"""The port's speed-7 slice (PARTITION_SPLIT RDO in keyframes and P
frames) against the JAX package's, on the CPU, with the same numpy-seeded
inputs.

The 3-frame 192x128 speed-7 GOP with CDEF must give rav1e_tpu's packets
and recon byte for byte and decode exactly on libdav1d and libaom; its
content (a moving texture with static sharp-edged squares) makes both
split outcomes occur in the keyframe and in a P frame. The JAX GOP (one
keyframe and one P-step compile) is computed once per test run and shared
between the runner's workers through a locked file. The edge rule of the
quads, the speed-7 RD tables and the split scan layout are held to the
JAX functions directly."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu.pipeline import tpu_intra as jti
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from rav1e_tpu_torch.pipeline import tpu_intra as tti
from test_torch_inter import _decode_exactly
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)

W, H = 192, 128
CDEF = (0, 0, 0, 0, 3)


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """The test runner's workers share the machine's cores and memory,
    and each keeps the heap its earlier modules freed: run torch on one
    thread here, hand the freed heap back to the system before the
    module (glibc's malloc_trim), and drop the worker's JAX compiles
    after it."""
    _trim_heap()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jinter._core.cache_clear()
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


# static squares of one 16x16 quad (row, col, luma), where the 32x32
# predictors cannot follow their edges and the P frames' zero MV fits
SQUARES = ((16, 16, 230), (48, 80, 30), (80, 144, 220), (16, 112, 40),
           (96, 48, 200))


def split_frames(w=W, h=H, n=3):
    """The translating texture of tests/test_inter_conformance.py with
    static sharp-edged 16x16 squares on it."""
    rng = np.random.default_rng(11)
    tex = gaussian_filter(rng.normal(0, 40, (h + 100, w + 100)), 2.5)
    frames = []
    for t in range(n):
        oy, ox = int(30 + 2.5 * t), int(30 - 1.5 * t)
        y = 128 + tex[oy:oy + h, ox:ox + w]
        for r, c, val in SQUARES:
            y[r:r + 16, c:c + 16] = val
        frames.append([y.clip(0, 255).astype(np.uint8),
                       np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 135, np.uint8)])
    return frames


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("half", [16, 8])
@pytest.mark.parametrize("quad", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_sub_edge_matches_reference(quad, half):
    """_sub_edge at each quad of a 32x32 luma block (half 16) and of a
    16x16 chroma block (half 8), on a batch holding every (has_a, has_l)
    pair: edges, top-left pixel and availabilities equal the JAX
    function's."""
    rng = np.random.default_rng(20 + 2 * quad[0] + quad[1] + half)
    n, b = 4, 2 * half
    cur = rng.integers(0, 256, (n, b, b)).astype(np.int32)
    ea = rng.integers(0, 256, (n, b)).astype(np.int32)
    el = rng.integers(0, 256, (n, b)).astype(np.int32)
    etl = rng.integers(0, 256, n).astype(np.int32)
    has_a = np.array([False, False, True, True])
    has_l = np.array([False, True, False, True])
    r0, c0 = quad[0] * half, quad[1] * half
    want = jti._sub_edge(*(jnp.asarray(x) for x in (cur, ea, el, etl, has_a,
                                                     has_l)),
                         r0, c0, half, n)
    got = tti._sub_edge(*(_t(x) for x in (cur, ea, el, etl, has_a, has_l)),
                        r0, c0, half)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_speed7_rd_tables_match_reference():
    """build_rd with the speed-7 mode sets (modes_quad = modes_y =
    MODES_7, no TX search, no split8), key by key, and the keyframe's
    speed-7 mode sets."""
    assert tti._mode_sets(7) == (tti.MODES_7, tti.MODES_UV, tti.MODES_7)
    rd_j = jax.tree_util.tree_map(np.asarray, jti.build_rd(
        100, jti.MODES_7, jti.MODES_UV, modes_quad=jti.MODES_7,
        tx_search=False, split8=False))
    rd_t = tti.build_rd(100, tti.MODES_7, tti.MODES_UV,
                        modes_quad=tti.MODES_7, device="cpu")

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
                assert a[k].numpy().dtype == b[k].dtype, k

    same(rd_t, rd_j)


def test_quad_cost_sum_in_xla_order():
    """The P frame's split cost sums its four quad costs as the
    reference's jnp.sum over the quad axis does on XLA:CPU (one add at a
    time), bit for bit on f32 values of wide range, where a pairwise
    order would differ."""
    rng = np.random.default_rng(22)
    c = (rng.random((20000, 4))
         * 10.0 ** rng.integers(-3, 8, (20000, 4))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=1))(c))
    np.testing.assert_array_equal(tinter._quad_sum(_t(c)).numpy(), want)
    pair = (c[:, 0] + c[:, 1]) + (c[:, 2] + c[:, 3])
    assert (pair != want).any()


def test_split_scan_layout_matches_reference():
    """scanline on blocks of both kinds (split: quadrant-major 16x16 /
    8x8 scans), its nonzero stream, and the host's unpack_stream back to
    spatial levels: equal to the JAX functions, and the round trip gives
    the levels back."""
    rng = np.random.default_rng(21)
    B = 6
    split = np.array([True, False, True, True, False, False])

    def lv(*s):
        return (rng.integers(-40, 41, s)
                * (rng.random(s) < 0.025)).astype(np.int32)

    lv_y, lv_u, lv_v = lv(B, 32, 32), lv(B, 16, 16), lv(B, 16, 16)
    q = (lv(4 * B, 16, 16), lv(4 * B, 8, 8), lv(4 * B, 8, 8))
    sl_j = np.asarray(jinter.scanline(
        *(jnp.asarray(x) for x in (lv_y, lv_u, lv_v) + q),
        jnp.asarray(split), B))
    sl_t = tinter.scanline(*(_t(x) for x in (lv_y, lv_u, lv_v) + q),
                           _t(split), B)
    np.testing.assert_array_equal(sl_t.numpy(), sl_j)
    cap = 64 * B
    st_j = [np.asarray(x) for x in jinter.nnz_stream(jnp.asarray(sl_j), cap)]
    st_t = [x.numpy() for x in tinter.nnz_stream(sl_t, cap)]
    for a, b in zip(st_t, st_j):
        np.testing.assert_array_equal(a, b)
    out_j = jinter.unpack_stream(*st_j, split, cap)
    out_t = tinter.unpack_stream(*st_t, split, cap)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert not out_t[3].any()          # every block within its 64 slots
    quads = [tinter._unquads(_t(x), n).numpy()
             for x, n in zip(q, (16, 8, 8))]
    for got, whole, quad in zip(out_t[:3], (lv_y, lv_u, lv_v), quads):
        np.testing.assert_array_equal(
            got, np.where(split[:, None, None], quad, whole))


def _gop_reference():
    """The JAX package's speed-7 CDEF GOP of split_frames() at q 100:
    (packets, recons as numpy)."""
    pk, rc = jinter.encode_gop_tpu(split_frames(), qindex=100, speed=7,
                                   cdef=CDEF)
    return pk, [[np.asarray(p) for p in r] for r in rc]


def test_speed7_gop_packets_identical_and_conformant(shared_dir):
    """encode_gop_tpu(speed=7, cdef=(0, 0, 0, 0, 3)) on the 3-frame
    192x128 GOP at q 100: the keyframe's and at least one P frame's
    split maps hold both values; every packet and recon equals
    rav1e_tpu's, and the stream decodes on libdav1d and libaom to the
    port's recon. The P frames' 16x16 blocks take the {parent, zero}
    per-16 MVs (no refine16 at speed 7)."""
    pk_j, rc_j = _once(shared_dir, "gop_speed7_split",
                       _gop_reference)
    frames = split_frames()
    kd = tti.analyze_keyframe(frames[0], 100, speed=7, cdef=CDEF,
                              device="cpu")
    assert len(set(kd.state[8].numpy().ravel().tolist())) == 2
    fetched = []
    orig = tinter._fetch_packed

    def recording_fetch(*a, **k):
        fetched.append(orig(*a, **k))
        return fetched[-1]

    tinter._fetch_packed = recording_fetch
    try:
        timings: list = []
        pk_t, rc_t = tinter.encode_gop_tpu(frames, qindex=100, speed=7,
                                           cdef=CDEF, device="cpu",
                                           timings=timings)
    finally:
        tinter._fetch_packed = orig
    assert any(f[5].any() and not f[5].all() for f in fetched)
    for i, (a, b) in enumerate(zip(pk_t, pk_j)):
        assert a == b, f"packet {i}"
    recs = [rc_t[0]] + [[r.numpy() for r in rc] for rc in rc_t[1:]]
    for i in range(3):
        for j in range(3):
            np.testing.assert_array_equal(recs[i][j], rc_j[i][j],
                                          err_msg=f"frame {i} plane {j}")
    _decode_exactly(pk_t, recs)
    assert all("split" in t for t in timings[1:])
