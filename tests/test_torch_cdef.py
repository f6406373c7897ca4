"""The port's CDEF (rav1e_tpu_torch/ops/cdef.py) against the JAX package's
(rav1e_tpu/ops/tpu/cdef.py), on the CPU, with the same numpy-seeded
deblocked-recon-like planes: a textured source with edges, and a recon
that adds noise of a strength that varies per 64x64 superblock plus
8x8 blocking, so the SBs choose different ladder entries.

Everything is held bit-exact: directions and variances, the prepared
taps and the filter, the fixed-strength frame filter, and the per-SB
search (index map and planes) on both branches: 192x128 is 64-aligned
(the sampled TL + BR quadrants), 160x96 is not (every 32-block). The
port's SSEs are exact integers where the reference's are f32 sums; they
agree because every per-plane SB SSE of the content is below 2^24, which
one test asserts. The card-only cases, which hold the kernels to the
plain versions, are in tests/test_torch_cdef_cuda.py (no jax there)."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rav1e_tpu.ops.tpu import cdef as jc
from rav1e_tpu_torch.ops import cdef as tc

SHAPES = [(192, 128), (160, 96)]


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """The test runner's workers share the machine's memory, and each
    keeps the heap its earlier modules freed: hand it back to the system
    before the module (glibc's malloc_trim), and drop the worker's JAX
    compiles after it."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def content(w, h, seed=1):
    """(recon planes, source planes, skip8) as int32 / bool numpy."""
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


# the reference jitted, as its pipelines run it
_j_search = jax.jit(jc.cdef_search_persb_jax, static_argnames=("bd",))
_j_filter = jax.jit(jc.cdef_filter_frame_jax)
_j_dirs = jax.jit(jc._dirs_var)


@pytest.mark.parametrize("w,h", SHAPES)
def test_directions_bit_exact(w, h):
    """cdef_directions (via the [h/8, w/8] grids) and the kernel wrapper's
    plain route: dir and var equal the JAX function's, ties included."""
    rec, _, _ = content(w, h)
    y = rec[0].copy()
    y[:8, :8] = 77                         # a flat block: every cost ties
    dj, vj = (np.asarray(a) for a in _j_dirs(jnp.asarray(y)))
    dt, vt = tc._dirs_var(_t(y))
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    d8, v8 = tc.cdef_dirs(_t(y))
    assert d8.dtype == torch.int8 and v8.dtype == torch.int32
    np.testing.assert_array_equal(d8.numpy(), dj)
    np.testing.assert_array_equal(v8.numpy(), vj)
    assert len(np.unique(dj)) == 8 and dj[0, 0] == 0 and vj[0, 0] == 0


@pytest.mark.parametrize("w,h", SHAPES)
def test_prep_and_filter_from_prep_bit_exact(w, h):
    """_prep_plane + _filter_from_prep on luma and chroma with scalar
    strengths, per-pixel strengths, zero primary and zero secondary
    strengths: bit-exact."""
    rec, _, skip8 = content(w, h)
    dj, vj = (np.asarray(a) for a in _j_dirs(jnp.asarray(rec[0])))
    rng = np.random.default_rng(5)
    for i, n in ((0, 8), (1, 4)):
        luma = i == 0
        dpix = np.repeat(np.repeat(dj, n, 0), n, 1)
        spix = np.repeat(np.repeat(skip8, n, 0), n, 1)
        vpix = np.repeat(np.repeat(vj, 8, 0), 8, 1) if luma else None
        pp_j = jc._prep_plane(jnp.asarray(rec[i]), jnp.asarray(dpix), n,
                              luma)
        pp_t = tc._prep_plane(_t(rec[i]), _t(dpix), n, luma)
        for a, b in zip(pp_t["p_pri"] + pp_t["p_sec"],
                        pp_j["p_pri"] + pp_j["p_sec"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pgrid = rng.integers(0, 16, rec[i].shape).astype(np.int32)
        for pri, sec, damp in ((5, 2, 3), (0, 4, 5), (7, 0, 6), (1, 1, 4),
                               (pgrid, 2, 4)):
            out_j = jc._filter_from_prep(
                pp_j, jnp.asarray(spix), jnp.asarray(pri), sec, damp,
                None if vpix is None else jnp.asarray(vpix))
            out_t = tc._filter_from_prep(
                pp_t, _t(spix), _t(pri) if isinstance(pri, np.ndarray)
                else pri, sec, damp, None if vpix is None else _t(vpix))
            np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("w,h", SHAPES)
def test_filter_frame_bit_exact(w, h):
    """cdef_filter_frame (the fixed-strength form of cdef_rdo=False),
    including a chroma primary strength of 0 (direction 0)."""
    rec, _, skip8 = content(w, h)
    for prm in ((3, 1, 2, 1, 4), (5, 2, 0, 2, 3)):
        out_j = _j_filter([jnp.asarray(p) for p in rec], jnp.asarray(skip8),
                          *prm)
        out_t = tc.cdef_filter_frame([_t(p) for p in rec], _t(skip8), *prm)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("lam", [None, 60.0])
@pytest.mark.parametrize("w,h", SHAPES)
def test_search_persb_bit_exact(w, h, lam):
    """cdef_search_persb: index map and filtered planes equal the JAX
    function's on both branches, without and with the nb_strengths
    subset RD; the content makes the SBs choose several entries."""
    rec, src, skip8 = content(w, h)
    ij, pj = _j_search([jnp.asarray(p) for p in rec],
                       [jnp.asarray(p) for p in src], jnp.asarray(skip8), 3,
                       lam=None if lam is None else jnp.float32(lam))
    it, pt = tc.cdef_search_persb([_t(p) for p in rec], [_t(p) for p in src],
                                  _t(skip8), 3,
                                  lam=None if lam is None
                                  else torch.tensor(lam))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert len(np.unique(np.asarray(ij))) >= 2
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("w,h", SHAPES)
def test_content_sse_below_2_24(w, h):
    """Every per-plane SSE over a superblock (and over each 32-block) of
    the test content, for every ladder entry, is below 2^24, where the
    reference's f32 sums are exact integers in any order."""
    rec, src, skip8 = content(w, h)
    dirs, var = tc.cdef_dirs(_t(rec[0]))
    sampled = h % 64 == 0 and w % 64 == 0
    for i in range(3):
        t = tc.cdef_ladder_sse(_t(rec[i]), _t(src[i]), dirs, var, _t(skip8),
                               3, i > 0, sampled).numpy().astype(np.int64)
        if not sampled:
            K, nby, nbx = t.shape
            t = np.pad(t, ((0, 0), (0, nby % 2), (0, nbx % 2)))
            t = t.reshape(K, (nby + 1) // 2, 2, (nbx + 1) // 2, 2).sum((2, 4))
        assert 0 < t.max() < 2 ** 24, (i, t.max())


def test_msb_is_the_integer_msb_and_agrees_where_cdef_reads_it():
    """The port's _msb is floor(log2(max(x, 1))) exactly, for x in
    1..2^20 and at every 2^k - 1, 2^k, 2^k + 1. The reference's float
    log2 is off by one at some of those points (8192 and 32768 on
    XLA:CPU, and 2^k - 1 for k >= 21: ROADMAP.md section 3), but never
    where CDEF reads it: strengths up to 14 << 4 and min(msb(var >> 6),
    12) for every var >> 6 up to 2^20 agree."""
    x = np.arange(1, 2 ** 20 + 1, dtype=np.int64)
    pts = np.array(sorted({2 ** k + d for k in range(1, 31) for d in (-1, 0, 1)
                           if 1 <= 2 ** k + d < 2 ** 31}), np.int64)
    for v in (x, pts, np.array([0, -5])):
        exact = np.array([max(int(a), 1).bit_length() - 1 for a in v])
        np.testing.assert_array_equal(
            tc._msb(_t(v.astype(np.int32))).numpy(), exact)
    jm = jax.jit(jc._msb)
    ref = np.asarray(jm(jnp.asarray(x.astype(np.int32))))
    port = tc._msb(_t(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(np.minimum(port, 12), np.minimum(ref, 12))
    np.testing.assert_array_equal(port[x < 8192], ref[x < 8192])
    bad = x[port != ref]
    assert bad.min() >= 8192, bad[:5]


def test_compact_ladder_and_ladder_equal():
    assert tc.CDEF_LADDER == jc.CDEF_LADDER
    rng = np.random.default_rng(2)
    for used in ([3], [0, 7], [1, 2, 5], [0, 1, 2, 3, 4, 5, 6, 7],
                 [2, 4, 6, 7, 1]):
        m = rng.choice(used, (5, 7)).astype(np.int32)
        a, b = tc.compact_ladder(m), jc.compact_ladder(m)
        assert a[0] == b[0] and a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])


def test_subset_rd_sums_in_xla_cpu_order():
    """The nb_strengths RD totals over 510 SBs (the 1080p frame) pass
    2^24, so their f32 rounding depends on the order: _tree_sum equals
    jnp.sum on XLA:CPU bit for bit (at 510, 509 and 1,100 terms), and
    _choose equals the reference's subset RD and argmin."""
    rng = np.random.default_rng(9)
    for n in (510, 509, 1100, 7):
        x = (rng.integers(2000, 900000, (6, n)) * 2.0).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a: a.sum(-1))(jnp.asarray(x)))
        np.testing.assert_array_equal(tc._tree_sum(_t(x)).numpy(), ref)
    masks, bits = tc._subsets(17 * 30)
    assert masks.shape == (107, 8)

    @jax.jit
    def ref_choose(sse_sb, lam):
        flat = sse_sb.reshape(8, -1)
        msse = jnp.where(jnp.asarray(masks)[:, :, None], flat[None], jnp.inf)
        tot = msse.min(1).sum(1) + lam * jnp.asarray(bits)
        allowed = jnp.asarray(masks)[jnp.argmin(tot)]
        return jnp.argmin(jnp.where(allowed[:, None, None], sse_sb, jnp.inf),
                          axis=0), tot

    base = rng.integers(20000, 900000, (17, 30))
    for lam in (2.0, 500.0, 9000.0):
        sse = ((base[None] + rng.integers(0, 40000, (8, 17, 30)))
               * 2.0).astype(np.float32)
        ij, _ = ref_choose(jnp.asarray(sse), jnp.float32(lam))
        it = tc._choose(_t(sse), torch.tensor(lam, dtype=torch.float32))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
