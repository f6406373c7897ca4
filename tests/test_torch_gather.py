"""The patch gather (rav1e_tpu_torch.ops.gather) against the JAX
package's gathers, on the CPU: the plain version must equal
jax.vmap(jax.lax.dynamic_slice), whose start rule the main path relies
on, for one gather and per item of a group (gather_patches_many), and
the port's _gather_patch and its MC split into gather and filter must
equal the JAX functions. The CUDA kernel is held to the plain version on
the card. The JAX package is imported
inside the tests that need it, so the card tests also run on a GPU
machine without jax (python -m pytest tests/test_torch_gather.py -m
cuda)."""

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.ops import gather as G

PATCH_SIZES = [23, 39, 41, 43]


def _starts(rng, B, H, W, P):
    """Random starts that include ones below 0 and past H-P / W-P."""
    r0 = rng.integers(-P - 5, H + 5, B).astype(np.int32)
    c0 = rng.integers(-P - 5, W + 5, B).astype(np.int32)
    r0[:4] = [-1, -3 * P, H - P + 1, H]
    c0[:4] = [W - P + 2, -7, 0, W]
    return r0, c0


def _jax_gather(plane, r0, c0, P):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.vmap(
        lambda r, c: jax.lax.dynamic_slice(plane, (r, c), (P, P)))(
            jnp.asarray(r0), jnp.asarray(c0)))


@pytest.mark.parametrize("P", PATCH_SIZES)
def test_plain_gather_equals_clamped_dynamic_slice(P):
    """gather_patches (a CPU tensor takes the plain version) equals
    vmap(dynamic_slice), out-of-range starts included."""
    rng = np.random.default_rng(P)
    H, W = 96, 160
    plane = rng.integers(-300, 300, (H, W)).astype(np.int32)
    r0, c0 = _starts(rng, 64, H, W, P)
    out = G.gather_patches(torch.from_numpy(plane), torch.from_numpy(r0),
                           torch.from_numpy(c0), P)
    assert out.dtype == torch.int32 and out.shape == (64, P, P)
    np.testing.assert_array_equal(out.numpy(),
                                  _jax_gather(plane, r0, c0, P))


@pytest.mark.parametrize("n,ss,M", [(32, 0, 2), (32, 0, 1), (16, 1, 2)])
def test_gather_patch_equals_reference(n, ss, M):
    """The port's _gather_patch (centre-MV patches of n+7+2M) equals the
    JAX _gather_patch, for MVs that push windows off the padded plane."""
    import jax.numpy as jnp

    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter
    rng = np.random.default_rng(n + M)
    nby, nbx = 3, 4
    h, w = (32 * nby) >> ss, (32 * nbx) >> ss
    p = jinter.PAD >> ss
    plane = rng.integers(0, 256, (h + 2 * p, w + 2 * p)).astype(np.int32)
    by = (np.repeat(np.arange(nby), nbx) * (32 >> ss)).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * (32 >> ss)).astype(np.int32)
    mv = rng.integers(-400, 400, (nby * nbx, 2)).astype(np.int32)
    pj, rj, cj = jinter._gather_patch(jnp.asarray(plane), jnp.asarray(by),
                                      jnp.asarray(bx), jnp.asarray(mv), n,
                                      ss, M)
    pt, rt, ct = tinter._gather_patch(*(torch.from_numpy(x) for x in
                                        (plane, by, bx, mv)), n, ss, M)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_many_equals_dynamic_slice_per_group(seed):
    """gather_patches_many_plain, and gather_patches_many on CPU tensors,
    on a mixed group (P = 15, 23, 39, 71 on a luma-like and a
    chroma-like plane, starts below 0 and past H-P / W-P, an item with
    B = 0) equal vmap(dynamic_slice) item by item."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(-300, 300, (120, 160)).astype(np.int32),
              rng.integers(0, 256, (80, 96)).astype(np.int32)]
    items, want = [], []
    for i, P in enumerate((15, 23, 39, 71, 23, 15)):
        plane = planes[i % 2] if P < 71 else planes[0]
        H, W = plane.shape
        r0, c0 = _starts(rng, 24 + 8 * i, H, W, P)
        items.append(tuple(torch.from_numpy(x) for x in (plane, r0, c0))
                     + (P,))
        want.append(_jax_gather(plane, r0, c0, P))
    e0 = torch.zeros(0, dtype=torch.int32)
    items.append((torch.from_numpy(planes[1]), e0, e0, 9))
    for got in (G.gather_patches_many_plain(items),
                G.gather_patches_many(items)):
        assert len(got) == len(items)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[-1].shape == (0, 9, 9)
    assert G.gather_patches_many([]) == []


@pytest.mark.parametrize("four_tap", [False, True])
@pytest.mark.parametrize("n,ss", [(32, 0), (16, 1), (8, 1)])
def test_mc_split_equals_reference_mc_batch(n, ss, four_tap):
    """The port's sub-pel prediction, split into its gather (_mc_window,
    several MCs in one _mc_windows group) and its filter (_mc_filter),
    equals the JAX _mc_batch at every MV of a group, 8- and 4-tap."""
    import jax.numpy as jnp

    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter
    rng = np.random.default_rng(n + 3 * ss + four_tap)
    nby, nbx = 3, 4
    p = jinter.PAD >> ss
    plane = rng.integers(0, 256, (nby * n + 2 * p,
                                  nbx * n + 2 * p)).astype(np.int32)
    by = (np.repeat(np.arange(nby), nbx) * n).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * n).astype(np.int32)
    mvs = [rng.integers(-200, 200, (nby * nbx, 2)).astype(np.int32)
           for _ in range(3)]
    t = torch.from_numpy
    specs = [(t(plane), t(by), t(bx), t(mv), n, ss) for mv in mvs]
    wins = tinter._mc_windows(specs)
    for (patch, fr, fc), mv in zip(wins, mvs):
        got = tinter._mc_filter(patch, fr, fc, n, four_tap)
        want = jinter._mc_batch(jnp.asarray(plane), jnp.asarray(by),
                                jnp.asarray(bx), jnp.asarray(mv), n, ss,
                                four_tap=four_tap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bound_reads_each_covered_element_once():
    """chip_smoke.py's byte bound for a gather launch, by hand: every
    patch written and every start read, and each distinct plane's
    elements that the launch's windows cover, clamped as the kernel
    clamps them, read once however many windows overlap them."""
    import chip_smoke as cs
    a = torch.zeros((20, 30), dtype=torch.int32)
    b = torch.zeros((10, 10), dtype=torch.int32)

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32)

    group = [(a, i32(0), i32(0), 8),          # rows 0-7, columns 0-7
             (a, i32(4), i32(4), 8),          # 4-11 x 4-11: 16 shared
             (a, i32(-1), i32(40), 5),        # 15-19 x 25-29 (clamped)
             (b, i32(3, -2), i32(0, 0), 10)]  # the whole plane, twice
    written = 4 * (64 + 64 + 25 + 2 * 100) + 8 * 5

    def nbytes(items):
        return cs._gather_bound(torch, G, items) * cs.H100_BYTES_PER_S / 1e3

    assert nbytes(group) == pytest.approx(written + 4 * (112 + 25 + 100))
    # launched one item at a time, the shared 16 are read twice
    assert sum(nbytes([it]) for it in group) == pytest.approx(
        written + 4 * (64 + 64 + 25 + 100))


def test_negative_start_counts_from_the_end():
    """jax.lax.dynamic_slice (allow_negative_indices=True, its default)
    adds the axis length to a negative start before clamping, so start
    -1 reads the LAST window, not the first. The port follows it."""
    plane = np.arange(20 * 30, dtype=np.int32).reshape(20, 30)
    r0 = np.array([-1, -25, 3], np.int32)
    c0 = np.array([-4, 2, -31], np.int32)
    out = G.gather_patches(torch.from_numpy(plane), torch.from_numpy(r0),
                           torch.from_numpy(c0), 8).numpy()
    np.testing.assert_array_equal(out, _jax_gather(plane, r0, c0, 8))
    np.testing.assert_array_equal(out[0], plane[12:20, 22:30])
    np.testing.assert_array_equal(out[1], plane[0:8, 2:10])
    np.testing.assert_array_equal(out[2], plane[3:11, 0:8])


@pytest.mark.parametrize("r", [-9, -6, -1, 0, 3, 5, 8])
def test_keyframe_row_start_rule_matches_dynamic_slice(r):
    """The keyframe wavefront's one-row reads and writes
    (tpu_intra._clamp_row) take the same start rule, for
    dynamic_slice and dynamic_update_slice alike."""
    import jax
    import jax.numpy as jnp

    from rav1e_tpu_torch.pipeline.tpu_intra import _clamp_row
    a = np.arange(6 * 2, dtype=np.int32).reshape(6, 2)
    got = _clamp_row(a, r)
    np.testing.assert_array_equal(
        a[got], np.asarray(jax.lax.dynamic_slice(a, (r, 0), (1, 2)))[0])
    upd = np.asarray(jax.lax.dynamic_update_slice(
        jnp.zeros((6, 2), jnp.int32), jnp.ones((1, 2), jnp.int32), (r, 0)))
    assert upd[got].all() and upd.sum() == 2


def test_wrapper_rejects_bad_inputs():
    plane = torch.zeros((40, 40), dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        G.gather_patches(plane.to(torch.int64), s, s, 8)
    with pytest.raises(ValueError, match="does not fit"):
        G.gather_patches(plane, s, s, 41)
    with pytest.raises(ValueError, match="starts"):
        G.gather_patches(plane, s.to(torch.int64), s, 8)
    with pytest.raises(ValueError, match="differ in length"):
        G.gather_patches_many([(plane, s, s, 8), (plane, s, s[:2], 8)])
    with pytest.raises(ValueError, match="at most 16"):
        G.gather_patches_many([(plane, s, s, 8)] * 17)


def _kernel_equals_plain_on_the_card(P):
    """The CUDA kernel against the plain version on the card, on the
    1080p planes' shapes with clamped starts: through gather_patches (a
    group of one), and through gather_patches_many on a mixed group (P
    = 15, 27, 71 beside this P, and an item with B = 0) and on a group
    of one; one launch a group, none for a group whose B are all 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(P)

    def item(P, H, W, B):
        plane = torch.from_numpy(
            rng.integers(0, 256, (H, W)).astype(np.int32)).cuda()
        r0, c0 = (torch.from_numpy(x).cuda()
                  for x in _starts(rng, B, H, W, P))
        return plane, r0, c0, P

    H, W = (1152, 1984) if P != 23 else (576, 992)
    it = item(P, H, W, 2040)
    e0 = torch.zeros(0, dtype=torch.int32, device="cuda")
    group = [it, item(15, 576, 992, 8160), item(27, 1152, 1984, 8160),
             item(71, 1152, 1984, 510), (it[0], e0, e0, 7)]
    n0 = G.gather_patches_many.launches
    out = G.gather_patches(*it)
    many = G.gather_patches_many(group)
    one = G.gather_patches_many([it])
    none = G.gather_patches_many([(it[0], e0, e0, 7)])
    torch.cuda.synchronize()
    assert G.gather_patches_many.launches == n0 + 3
    want = G.gather_patches_many_plain(group)
    assert torch.equal(out, want[0]) and torch.equal(one[0], want[0])
    for g, w in zip(many, want):
        assert torch.equal(g, w)
    assert none[0].shape == (0, 7, 7)


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    """_kernel_equals_plain_on_the_card at each patch size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for P in (23, 39, 43):
        _kernel_equals_plain_on_the_card(P)
