"""The CDEF kernels of csrc/cdef.cu against their plain torch versions,
on the card (`python -m pytest tests/test_torch_cdef_cuda.py -m cuda`;
they skip on a machine without CUDA), at 8 bits and at 10 (the content
as 10-bit int16 planes: x 4 plus a seeded dither in [0, 3]), and the
wrappers' dtype checks on both routes. This file imports no jax, so it
runs on the card's machine; tests/test_torch_cdef.py holds the plain
versions to the JAX package on the CPU."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from _torch_content import dir_extremes
from rav1e_tpu_torch.ops import cdef as tc


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def content(w, h, seed=1):
    """(recon planes, source planes, skip8) as int32 / bool numpy: the
    deblocked-recon-like content of tests/test_torch_cdef.py."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw, sigma, sb):
        tex = gaussian_filter(rng.normal(0, 40, (ph, pw)), sigma) * 3 + 128
        edges = ((np.arange(pw)[None] // 13 + np.arange(ph)[:, None] // 9)
                 % 2) * 40
        src = (tex + edges).clip(0, 255)
        amp = np.kron(rng.choice([0.0, 0.7, 1.5, 3.0, 5.0, 8.0],
                                 (-(-ph // sb), -(-pw // sb))),
                      np.ones((sb, sb)))[:ph, :pw]
        rec = (src + rng.normal(0, 1, (ph, pw)) * amp
               + np.kron(rng.normal(0, 3, (ph // 8, pw // 8)),
                         np.ones((8, 8))))
        return src.astype(np.int32), rec.clip(0, 255).astype(np.int32)

    y, u, v = (plane(h, w, 2.0, 64), plane(h // 2, w // 2, 1.5, 32),
               plane(h // 2, w // 2, 1.5, 32))
    skip8 = rng.random((h // 8, w // 8)) < 0.2
    return [y[1], u[1], v[1]], [y[0], u[0], v[0]], skip8


def noise_at_q255(w, h, seed, scale=1):
    """Binary noise (0 / 255) as the source and, as its recon, the 8x8
    block means with mild noise, divided by `scale`: a cell's SSE passes
    2^24 (tests/test_torch_speed6.py's content)."""
    rng = np.random.default_rng(seed)
    rec, src = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        s = np.where(rng.random((ph, pw)) < 0.5, 0, 255).astype(np.int32)
        m = s.reshape(ph // 8, 8, pw // 8, 8).mean((1, 3))
        r = np.kron(m, np.ones((8, 8))) + rng.normal(0, 12, (ph, pw))
        rec.append(np.clip(r.clip(0, 255).astype(np.int32) // scale, 0, 255))
        src.append(s)
    return rec, src, rng.random((h // 8, w // 8)) < 0.1


def _pix(p, bd, seed=0):
    """An 8-bit plane as the kernels take bd-bit pixels: uint8, or at 10
    bits int16 p x 4 plus a seeded dither in [0, 3]."""
    if bd == 8:
        return p.astype(np.uint8)
    rng = np.random.default_rng(seed)
    return (p.astype(np.int16) * 4
            + rng.integers(0, 4, p.shape).astype(np.int16))


def _on_card(rec, src, skip8, bd=8):
    return ([_t(_pix(p, bd, i)).cuda() for i, p in enumerate(rec)],
            [_t(_pix(p, bd, 3 + i)).cuda() for i, p in enumerate(src)],
            _t(skip8).cuda())


def _tables_equal_plain(recd, srcd, sk, dirs, var, damping, sampled, bd=8):
    """One cdef_ladder_sse launch against the plain version per plane;
    returns the tables and the blocks' (exact, ordered) path counts."""
    paths = tc.path_counts("cuda")
    paths.zero_()
    got = tc.cdef_ladder_sse(recd, srcd, dirs, var, sk, damping, sampled,
                             bd)
    counts = paths[:2].tolist()
    for i in range(3):
        want = tc.cdef_ladder_sse_plain(recd[i], srcd[i], dirs, var, sk,
                                        damping, i > 0, sampled, bd)
        assert torch.equal(got[i], want), (i, sampled, bd)
    assert sum(counts) == got[0, 0].numel()
    return got, counts


def _apply_equal_plain(recd, dirs, var, sk, damping, bd=8, **kw):
    """One cdef_apply launch against the plain version per plane; returns
    the (filtered, copied) counts of (SB, plane) pairs."""
    paths = tc.path_counts("cuda")
    paths.zero_()
    got = tc.cdef_apply(recd, dirs, var, sk, damping, bd=bd, **kw)
    counts = paths[2:].tolist()
    st = kw.get("strengths", (0, 0, 0, 0))
    for i in range(3):
        want = tc.cdef_apply_plain(recd[i], dirs, var, sk, damping, i > 0,
                                   kw.get("idx"), *(st[2:] if i else st[:2]),
                                   bd)
        assert torch.equal(got[i], want), (i, kw, bd)
    return counts


def _dirs_equal_plain_at_the_extremes_on_card(what):
    """On the card: cdef_dirs (int32 costs, 8 threads a block) equals its
    plain version on blocks at the ends of its range (all 0, the int32
    bound in every direction: dir 0, var 0; all 255; a ramp and stripes
    along each direction), on them from a misaligned base (the wrapper
    copies to an 8-byte-aligned one), and on a frame 8 px past a
    multiple of 64 wide (a thread block of 32 8x8 blocks partly outside
    each row); at 8 bits and at 10 (searched on px >> 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for bd in (8, 10):
        y = _t(_pix(np.tile(dir_extremes(), (3, 1)), bd)).cuda()
        if what == "misaligned":
            flat = torch.empty(y.numel() + 1, dtype=y.dtype, device="cuda")
            flat[1:].view(y.shape).copy_(y)
            y = flat[1:].view(y.shape)
            assert y.data_ptr() % 8
        elif what == "1928x136":
            rng = np.random.default_rng(31)
            y = _t(_pix(gaussian_filter(rng.normal(128, 40, (136, 1928)),
                                        2.0).clip(0, 255), bd)).cuda()
        d, v = tc.cdef_dirs(y, bd)
        dp, vp = tc.cdef_dirs_plain(y, bd)
        assert torch.equal(d, dp) and torch.equal(v, vp), bd
        if what != "1928x136":
            assert int(d[0, 0]) == 0 and int(v[0, 0]) == 0


def _kernels_equal_plain_on_card(w, h):
    """On the card: cdef_dirs, cdef_ladder_sse (both branches where the
    frame is 64-aligned) and cdef_apply (ladder winners, every entry,
    entry 0 everywhere, uniform strengths with chroma's primary 0 and
    with every strength 0) equal their plain versions exactly, one
    launch a frame each; 1920x1056 and 320x224 cut SBs at the frame's
    edge, and 320x224 has all-skipped SBs. Entry 0, the (0, 0) pair and
    the skipped SBs take the copy path. At 8 bits and at 10, where the
    exact path holds a cell's total while it stays under 2^24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = content(w, h, seed=4)
    skip8[:8, :16] = True                       # two all-skipped SBs
    for bd in (8, 10):
        recd, srcd, sk = _on_card(rec, src, skip8, bd)
        dirs, var = tc.cdef_dirs(recd[0], bd)
        dp, vp = tc.cdef_dirs_plain(recd[0], bd)
        assert torch.equal(dirs, dp) and torch.equal(var, vp)
        sampled = h % 64 == 0 and w % 64 == 0
        for branch in (False, True) if sampled else (False,):
            sses, counts = _tables_equal_plain(recd, srcd, sk, dirs, var, 4,
                                               branch, bd)
            if bd == 8:
                assert counts[1] == 0           # real content: exact path
        nr, nc = -(-h // 64), -(-w // 64)
        nsb = nr * nc
        idx = tc._choose(tc._sse_sb(sses, sampled, nr, nc), None)
        every = (torch.arange(nsb, device="cuda") % 8).reshape(nr, nc)
        for ix in (idx, every):
            filt, copied = _apply_equal_plain(recd, dirs, var, sk, 4, bd,
                                              idx=ix)
            assert copied >= 3 * 2              # the two skipped SBs
        assert _apply_equal_plain(recd, dirs, var, sk, 4, bd,
                                  idx=torch.zeros_like(every)) == [0,
                                                                   3 * nsb]
        _apply_equal_plain(recd, dirs, var, sk, 4, bd,
                           strengths=(3, 2, 0, 2))
        assert _apply_equal_plain(recd, dirs, var, sk, 4, bd,
                                  strengths=(0, 0, 0, 0)) == [0, 3 * nsb]


def _kernels_past_2_24_on_card(w, h, seed, scale):
    """On the card, on noise at q 255 where a cell's SSE passes 2^24 and
    the f32 order decides: the tables equal the plain version's bit for
    bit, the blocks past 2^24 taking the ordered path (both branches at
    256x192, the full one at 160x96), and the winners' planes too; at 8
    bits and at 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = noise_at_q255(w, h, seed, scale)
    for bd in (8, 10):
        recd, srcd, sk = _on_card(rec, src, skip8, bd)
        dirs, var = tc.cdef_dirs(recd[0], bd)
        sampled = h % 64 == 0 and w % 64 == 0
        for branch in (False, True) if sampled else (False,):
            sses, counts = _tables_equal_plain(recd, srcd, sk, dirs, var, 3,
                                               branch, bd)
            assert float(sses.max()) >= 2 ** 24 and counts[1] > 0, branch
        nby, nbx = h // 32, w // 32
        idx = tc._choose(tc._sse_sb(sses, sampled, (nby + 1) // 2,
                                    (nbx + 1) // 2), None)
        _apply_equal_plain(recd, dirs, var, sk, 3, bd, idx=idx)


@pytest.mark.parametrize("dev", ["cpu"])
@pytest.mark.parametrize("what", ["dirs", "var"])
def test_grids_of_another_dtype_raise(dev, what):
    """The kernels read dirs as int8 and var as int32: a grid of another
    dtype (int32 directions, say) raises on both routes instead of being
    read as the wrong bytes on the card."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = content(64, 64, seed=2)
    p = [_t(r).to(dev) for r in rec]
    s = [_t(r).to(dev) for r in src]
    sk = _t(skip8).to(dev)
    dirs, var = tc.cdef_dirs(p[0].to(torch.uint8))
    if what == "dirs":
        dirs = dirs.to(torch.int32)
    else:
        var = var.to(torch.int64)
    with pytest.raises(ValueError, match=f"{what} must be"):
        tc.cdef_ladder_sse(p, s, dirs, var, sk, 4, True)
    with pytest.raises(ValueError, match=f"{what} must be"):
        tc.cdef_apply(p, dirs, var, sk, 4, idx=torch.zeros(
            (1, 1), dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_kernels_equal_plain_on_card():
    """Every card case of this file, in one function (the cases skip
    together here): _dirs_equal_plain_at_the_extremes_on_card on the
    extreme blocks, them from a misaligned base and a 1928x136 frame;
    _kernels_equal_plain_on_card at 1920x1088, 1920x1056 and 320x224;
    _kernels_past_2_24_on_card on both noise frames; and
    test_grids_of_another_dtype_raise on the card, for both grids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for what in ("extremes", "misaligned", "1928x136"):
        _dirs_equal_plain_at_the_extremes_on_card(what)
    for w, h in ((1920, 1088), (1920, 1056), (320, 224)):
        _kernels_equal_plain_on_card(w, h)
    for w, h, seed, scale in ((256, 192, 19, 1), (160, 96, 11, 4)):
        _kernels_past_2_24_on_card(w, h, seed, scale)
    for what in ("dirs", "var"):
        test_grids_of_another_dtype_raise("cuda", what)
