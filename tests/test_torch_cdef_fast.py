"""The premises of the CDEF kernels' design (csrc/cdef.cu), held on the
CPU in plain torch (no jax):

- the exact-integer table: on integer squared-error tables the
  reference's f32 order (`_xla_rows_sum`, the sampled branch's TL rows
  then BR rows included) gives the exact integer total, rounded once,
  wherever that total is at most 2^24, 2^24 itself included; just above
  it the order decides, which is why the kernel keeps the ordered path;
- the out-of-frame taps: constrain gives 0 for a tap of -2^14 at every
  strength and damping CDEF uses, so the kernels need no in-frame test;
- the frame-level wrappers (one launch a frame on the card) route each
  plane to its plain version on the CPU, and check their inputs;
- the operation counts that chip_smoke.py's bounds divide by the card's
  issue rate count the work the ladder entries share once.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cdef_cuda.py, chip_smoke.py phase 6)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_content import DIR_BINS, dir_extremes
from rav1e_tpu_torch.ops import cdef as tc

EXACT = 2 ** 24


def _squares(rng, shape, top):
    """Integer squared errors e^2, |e| <= top, as f32."""
    e = rng.integers(0, top + 1, shape)
    return torch.from_numpy((e * e).astype(np.float32))


@pytest.mark.parametrize("rows,cols,top", [
    (64, 32, 90),    # sampled luma: TL 32 rows, then BR 32
    (32, 32, 128),   # full luma, one 32-block
    (32, 16, 181),   # sampled chroma: TL 16 rows, then BR 16
    (16, 16, 255),   # full chroma
])
def test_rows_sum_is_the_exact_total_up_to_2_24(rows, cols, top):
    """Tables of 200 cells whose totals stay at most 2^24: the f32 sum in
    the reference's order equals the integer total converted to f32."""
    rng = np.random.default_rng(rows * cols + top)
    d = _squares(rng, (200, rows, cols), top)
    exact = d.to(torch.int64).sum((1, 2))
    assert int(exact.max()) <= EXACT
    got = tc._xla_rows_sum(d)
    assert torch.equal(got, exact.to(torch.float32))


def test_rows_sum_at_exactly_2_24():
    """A cell whose integer total is exactly 2^24 (258 x 255^2 + 27^2 +
    6^2 + 1^2, the rest 0, in a shuffled order), at each cell shape the
    table uses (64x32 sampled luma, 32x32, 32x16): the ordered f32 sum is
    2^24."""
    for rows, cols in ((64, 32), (32, 32), (32, 16)):
        rng = np.random.default_rng(rows + cols)
        flat = np.zeros(rows * cols, np.float32)
        flat[:261] = [255.0 ** 2] * 258 + [27.0 ** 2, 6.0 ** 2, 1.0]
        d = torch.from_numpy(rng.permutation(flat).reshape(1, rows, cols))
        assert int(d.to(torch.int64).sum()) == EXACT
        assert float(tc._xla_rows_sum(d)[0]) == float(EXACT), (rows, cols)


def test_rows_sum_just_past_2_24_depends_on_the_order():
    """Just past 2^24 the f32 spacing is 2: a cell whose first rows reach
    2^24 and whose later rows add 1s at lane 0 (each such add rounds back
    to even) sums to 2^24 in the reference's order, while its integer
    total is 2^24 + 32. An exact table would differ here, so the kernel
    takes the ordered path past 2^24."""
    d = torch.zeros((1, 64, 32), dtype=torch.float32)
    d[0, :32, :] = 128.0 ** 2                  # 2^24 in the first 32 rows
    d[0, 32:, 0] = 1.0                         # then 1 at lane 0, 32 times
    exact = int(d.to(torch.int64).sum())
    assert exact == EXACT + 32
    got = float(tc._xla_rows_sum(d)[0])
    assert got == float(EXACT)
    assert got != float(np.float32(exact))


@pytest.mark.parametrize("damping", [3, 4, 5, 6])
def test_out_of_frame_tap_constrains_to_zero(damping):
    """The kernels keep a tap outside the frame as -2^14 with no
    in-frame test: |d| = 2^14 + x for every pixel x, and constrain gives
    0 at every strength CDEF reads (luma's adjusted primary <= 14,
    secondary 1, 2, 4) and damping shift (luma damping, chroma one
    less). The reference's `_constrain` agrees, and so does the kernel's
    form min(a, max(0, S - (a >> sh)))."""
    a = torch.arange(2 ** 14, 2 ** 14 + 256, dtype=torch.int32)
    lad = torch.tensor(tc.CDEF_LADDER)
    var = torch.tensor([0, 1, 63, 64, 4096, 2 ** 20, 2 ** 30])
    v6 = var >> 6
    vs = torch.where(v6 > 0, torch.clamp(tc._msb(v6), max=12), 0)
    pri_adj = torch.where(var[:, None] > 0,
                          (lad[None, :, 0] * (4 + vs[:, None]) + 8) >> 4, 0)
    strengths = torch.unique(torch.cat([pri_adj.flatten(), lad.flatten()]))
    assert int(strengths.max()) == 14
    for pdamp in (damping, damping - 1):
        for s in strengths.tolist():
            s_t = torch.tensor(s, dtype=torch.int32)
            assert not torch.any(tc._constrain(-a, s_t, pdamp)), (s, pdamp)
            sh = max(0, pdamp - int(tc._msb(torch.tensor(max(s, 1)))))
            assert not torch.any(torch.clamp(
                torch.minimum(a, s - (a >> sh)), min=0)), (s, pdamp)


def test_ladder_strengths_the_kernels_share():
    """The ladder entries share what the kernel forms once: the secondary
    strengths are 0, 1, 2 and 4 on both plane kinds, and chroma's entries
    1 and 2 are one pair."""
    lad = tc.CDEF_LADDER
    assert {e[1] for e in lad} == {e[3] for e in lad} == {0, 1, 2, 4}
    assert lad[1][2:] == lad[2][2:] == (1, 0)
    assert lad[0] == (0, 0, 0, 0)


def _frame(w, h, seed):
    """A frame, its source and skip map: smooth texture, a per-SB recon
    noise level (some SBs left unfiltered), 8x8 blocking."""
    rng = np.random.default_rng(seed)
    rec, src = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        yy, xx = np.mgrid[0:ph, 0:pw]
        s = 128 + 60 * np.sin(xx / 7.0 + yy / 11.0) + rng.normal(0, 6,
                                                                 (ph, pw))
        sb = 64 * ph // h
        amp = np.kron(rng.choice([0.0, 2.0, 6.0, 12.0],
                                 (-(-ph // sb), -(-pw // sb))),
                      np.ones((sb, sb)))[:ph, :pw]
        r = s + rng.normal(0, 1, (ph, pw)) * amp + np.kron(
            rng.normal(0, 3, (ph // 8, pw // 8)), np.ones((8, 8)))
        src.append(torch.from_numpy(s.clip(0, 255).astype(np.uint8)))
        rec.append(torch.from_numpy(r.clip(0, 255).astype(np.uint8)))
    skip8 = torch.from_numpy(rng.random((h // 8, w // 8)) < 0.25)
    return rec, src, skip8


def test_frame_wrappers_route_each_plane():
    """On the CPU the frame-level wrappers run each plane's plain version
    (the JAX functions hold those, tests/test_torch_cdef.py): each plane
    goes to its own call, as luma or as chroma, with its own kind's
    strengths (distinct, so a swap would show), on a frame with a partial
    SB row and column."""
    rec, src, skip8 = _frame(160, 96, seed=4)
    dirs, var = tc.cdef_dirs(rec[0])
    got = tc.cdef_ladder_sse(rec, src, dirs, var, skip8, 4, False)
    assert got.shape == (3, 8, 3, 5) and got.dtype == torch.float32
    planes = tc.cdef_apply(rec, dirs, var, skip8, 4, strengths=(5, 2, 1, 4))
    for i in range(3):
        want = tc.cdef_ladder_sse_plain(rec[i], src[i], dirs, var, skip8, 4,
                                        i > 0, False)
        assert torch.equal(got[i], want), i
        want = tc.cdef_apply_plain(rec[i], dirs, var, skip8, 4, i > 0, None,
                                   *((1, 4) if i else (5, 2)))
        assert torch.equal(planes[i], want), i
    assert not torch.equal(got[1], got[2])
    assert not torch.equal(planes[0][:48, :80], tc.cdef_apply_plain(
        rec[0], dirs, var, skip8, 4, False, None, 1, 4)[:48, :80])


# ---- the bounds chip_smoke.py holds the kernels to --------------------------

def _unit(var, skip):
    """One 8x8 luma unit's grids: var, skip8."""
    return (torch.tensor([[var]], dtype=torch.int32),
            torch.tensor([[skip]]))


@pytest.mark.parametrize("chroma,var,skip,want", [
    # skipped: the unfiltered error and its multiply-add, 2 a pixel
    (False, 0, True, 2 * 64),
    # var 0: no primary strength; entries 2-7 filter with the secondary
    # strengths 1, 2, 4: the secondary taps' shared work and window 32,
    # the primary window 4, three sums of 32, three pairs at 6, six
    # multiply-adds, 2; the adjustment 4 + 2 x 8 a unit
    (False, 0, False, (32 + 4 + 96 + 18 + 6 + 2) * 64 + 20),
    # var >> 6 >= 4096: the strengths as they are; seven primary sums
    # (1, 2, 3, 5, 7, 10, 14) at 16, seven pairs, six with both sums
    (False, 1 << 20, False,
     (12 + 32 + 4 + 112 + 96 + 42 + 6 + 7 + 2) * 64 + 20),
    # chroma: primary 1, 2, 4, 5, 8, 12 (entries 1 and 2 one pair), six
    # pairs, five with both sums, seven entries filtering
    (True, 0, False, (12 + 32 + 4 + 96 + 96 + 36 + 5 + 7 + 2) * 16),
])
def test_ladder_ops_count_shared_work_once(chroma, var, skip, want):
    """chip_smoke.py's count of the ladder table's operations (its bound)
    on one unit, by hand: the tap work the entries share once, one sum a
    distinct strength, one round and clip a distinct pair."""
    v, sk = _unit(var, skip)
    assert cs._cdef_ladder_ops(torch, tc, v, sk, chroma, None) == want


@pytest.mark.parametrize("chroma,var,entry,want", [
    (False, 1 << 20, 7, (4 + 8 + 28 + 56 + 5 + 1) * 64 + 6),   # (14, 4)
    (False, 1 << 20, 0, 0),                # (0, 0): copied
    (False, 0, 1, 0),                      # (1, 0), adjusted to (0, 0)
    (True, 0, 1, (4 + 28 + 5) * 16),       # (1, 0): primary taps only
    (True, 0, 7, (4 + 8 + 28 + 56 + 5 + 1) * 16),              # (12, 4)
])
def test_apply_ops_by_hand(chroma, var, entry, want):
    """chip_smoke.py's count of the filter's operations on one unit and
    entry: 7 a tap that its strength reads, the window, the round and
    clip; nothing where the pair is (0, 0) after luma's adjustment."""
    v, sk = _unit(var, False)
    ent = torch.tensor([[entry]])
    assert cs._cdef_ops(torch, tc, v, sk, chroma, ent) == want


@pytest.mark.parametrize("chroma", [False, True])
def test_ladder_ops_at_most_each_entry_filtered_alone(chroma):
    """On a frame's grids, the ladder's count (its bound) is at most the
    8 entries filtered one at a time, each with its error and its
    multiply-add a pixel: sharing never counts more than the plain way."""
    rec, _, skip8 = _frame(192, 128, seed=9)
    _, var = tc.cdef_dirs(rec[0])
    npx = rec[0].numel() // (4 if chroma else 1)
    alone = sum(cs._cdef_ops(torch, tc, var, skip8, chroma,
                             torch.full_like(var, k)) + 2 * npx
                for k in range(8))
    shared = cs._cdef_ladder_ops(torch, tc, var, skip8, chroma, None)
    assert 0 < shared < alone


def test_dirs_ops_by_hand():
    """chip_smoke.py's count of cdef_dirs' least work an 8x8 block (its
    bound), by hand: __dp4a words of up to 4 pixels of one bin
    (directions 0 and 4: 15 bins of 1..8..1 pixels, 22 words; 2 and 6: 8
    bins of 8, 16; 1, 3, 5, 7: 11 bins of 2, 4, 6, 8, 8, 8, 8, 8, 6, 4, 2,
    18), a square and a multiply-add a bin (90 bins), the argmax's 7
    steps of 3 and var's subtract and shift."""
    sizes = [sorted(np.bincount(b.ravel()).tolist()) for b in DIR_BINS]
    assert sizes[0] == sizes[4] == sorted([1, 2, 3, 4, 5, 6, 7, 8, 7, 6,
                                           5, 4, 3, 2, 1])
    assert sizes[2] == sizes[6] == [8] * 8
    for d in (1, 3, 5, 7):
        assert sizes[d] == sorted([2, 4, 6, 8, 8, 8, 8, 8, 6, 4, 2])
    words = 2 * 22 + 2 * 16 + 4 * 18
    assert cs._dirs_ops() == words + 2 * 90 + 7 * 3 + 2 == 351


def test_frame_wrappers_check_their_inputs():
    """Frames must be 4:2:0 with matching sources, whole superblocks on
    the sampled branch, skip8 bool or uint8 bytes, idx the SB grid, and
    damping AV1's 3..6 (the out-of-frame taps' premise)."""
    rec, src, skip8 = _frame(128, 96, seed=1)
    dirs, var = tc.cdef_dirs(rec[0])
    with pytest.raises(ValueError, match="4:2:0"):
        tc.cdef_ladder_sse([rec[0], rec[1][:, :-4], rec[2]], src, dirs, var,
                           skip8, 3, False)
    with pytest.raises(ValueError, match="must match"):
        tc.cdef_ladder_sse(rec, src[:1] * 3, dirs, var, skip8, 3, False)
    with pytest.raises(ValueError, match="whole superblocks"):
        tc.cdef_ladder_sse(rec, src, dirs, var, skip8, 3, True)
    with pytest.raises(ValueError, match="skip8 must be"):
        tc.cdef_apply(rec, dirs, var, skip8.to(torch.int64), 3,
                      strengths=(1, 0, 1, 0))
    for damping in (2, 7):
        with pytest.raises(ValueError, match="damping is 3..6"):
            tc.cdef_ladder_sse(rec, src, dirs, var, skip8, damping, False)
        with pytest.raises(ValueError, match="damping is 3..6"):
            tc.cdef_apply(rec, dirs, var, skip8, damping,
                          strengths=(1, 0, 1, 0))
    with pytest.raises(ValueError, match="idx must be"):
        tc.cdef_apply(rec, dirs, var, skip8, 3,
                      idx=torch.zeros((1, 1), dtype=torch.int32))


def _dir_costs(blocks):
    """The 8 direction costs of 8x8 uint8 blocks [N, 8, 8], int64, from
    the definition: bins of x - 128 along each direction, each partial
    sum squared and weighted by 840 / (the bin's pixels)."""
    x = blocks.astype(np.int64) - 128
    costs = []
    for b in DIR_BINS:
        c = 0
        for k in range(b.max() + 1):
            on = b == k
            c = c + x[:, on].sum(1) ** 2 * (840 // int(on.sum()))
        costs.append(c)
    return np.stack(costs, 1)


def test_direction_costs_fit_int32():
    """The cdef_dirs kernel keeps the costs in int32: at 8 bits a bin of
    n pixels has |sum| <= 128 n and weight 840 / n, so a cost is at most
    128^2 * 840 * 64 = 880,803,840 < 2^31 - 1. An all-black block reaches
    it in all 8 directions (dir 0 by the first maximum, var 0); no
    direction of 10^4 random, extreme or 0 / 255 blocks passes it; and
    the argmax with var of these costs is cdef_directions'."""
    bound = 128 * 128 * 840 * 64
    assert bound == 880_803_840 < 2 ** 31 - 1
    black = _dir_costs(np.zeros((1, 8, 8), np.uint8))
    assert (black == bound).all()
    rng = np.random.default_rng(9)
    ext = dir_extremes()
    blocks = np.concatenate([
        ext.reshape(8, -1, 8).transpose(1, 0, 2),
        rng.integers(0, 256, (5000, 8, 8)),
        np.where(rng.random((4968, 8, 8)) < 0.5, 0, 255)]).astype(np.uint8)
    assert blocks.shape[0] == 10_000
    costs = _dir_costs(blocks)
    assert costs.max() <= bound and costs.min() >= 0
    best = costs.argmax(1)                 # the first maximum
    top = costs[np.arange(len(costs)), best]
    var = (top - costs[np.arange(len(costs)), best ^ 4]) >> 10
    d, v = tc.cdef_directions(torch.from_numpy(blocks))
    np.testing.assert_array_equal(d.numpy(), best)
    np.testing.assert_array_equal(v.numpy(), var)
    assert d[0] == 0 and v[0] == 0

