"""The port's speed-6 keyframe (the default of encode_keyframe_tpu) against
the JAX package's, on the CPU, with the same numpy-made inputs.

Two keyframes are compared whole, each with and without CDEF: 128x96
content whose 8..16 px detail stays under the split8 gate (3 x 4 blocks,
so the above-right and below-left edge rules both occur), on which CfL,
a directional mode and each of the four QUAD_TXS types are taken; and a
64x64 8-px checkerboard that passes the gate, on which quads split
16->8. The packet, recon and phase-1 decision grids must equal
rav1e_tpu's, and both decoders (libdav1d, libaom) must decode the packet
exactly. The JAX keyframes (one gate-off and one split8 compile, the
costliest in the repo) are computed once per test run and shared between
the runner's workers through a locked file.

The parts are held to the JAX functions directly: the speed-6 RD
tables, the 2i+j skew tables, the decode-order edge tables, the split8
gate, the TX_4X4 transform pairs, the 16->8 scan layout and the deblock
sub_map. So are two sums that pass 2^24 and whose f32 order decides:
CDEF's per-SB SSEs on heavy noise at a q-255-like recon, and the subset
RD's total over the SBs."""

import ctypes
import functools
import gc
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.conform import aom, dav1d
from rav1e_tpu.core.constants import TxSize as JTx
from rav1e_tpu.core.constants import TxType as JTt
from rav1e_tpu.ops.tpu import cdef as jc
from rav1e_tpu.ops.tpu import deblock as jdb
from rav1e_tpu.ops.tpu import transforms as jT
from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu.pipeline import tpu_intra as jti
from rav1e_tpu_torch.core.constants import TxSize, TxType
from rav1e_tpu_torch.entropy.tile import chroma_tx_type
from rav1e_tpu_torch.ops import cdef as tc
from rav1e_tpu_torch.ops import deblock as tdb
from rav1e_tpu_torch.ops import transforms as tT
from rav1e_tpu_torch.ops.intra import MODE_TO_ANGLE
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from rav1e_tpu_torch.pipeline import tpu_intra as tti
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)

CDEF = (0, 0, 0, 0, 3)
P = tti.P
GRIDS = ("my", "mu", "split", "cfl", "ytx", "s16", "ym8", "uvm8")


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
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def gate_off(w=128, h=96, seed=7):
    """Sinusoids with two straight edges (one rising, one falling), three
    ramps on 16x16 quads and mild noise; chroma follows luma (CfL). The
    8..16 px band stays under the split8 gate (245 < 256)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 100 + 40 * np.sin(xx / 17) + 30 * np.cos(yy / 11)
    y = np.where(xx - yy > 20, y + 70, y)
    y = np.where((xx + yy > 150) & (yy < 48), y - 60, y)
    gy, gx = np.mgrid[0:16, 0:16]
    for r, c in ((32, 0), (64, 96)):
        y[r:r + 16, c:c + 16] += 4 * (gx + gy)
        y[r + 16:r + 32, c + 16:c + 32] += 6 * gy
        y[r:r + 16, c + 16:c + 32] += 6 * gx
    y = (y + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
    yd = y.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    u = (128 + 0.6 * (yd - 128)).clip(0, 255).astype(np.uint8)
    v = (128 - 0.4 * (yd - 128)).clip(0, 255).astype(np.uint8)
    return [y, u, v]


def gate_on(w=64, h=64, seed=2):
    """The 8-px checkerboard of tests/test_kf_split8.py with a column
    strip of binary noise; chroma follows luma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.where((xx // 8 + yy // 8) % 2 == 0, 90, 170).astype(np.float64)
    y[:, :24] = 128 + (rng.random((h, 24)) > 0.5) * 80
    y = (y + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.uint8)
    yd = y.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    u = (128 + 0.5 * (yd - 128)).clip(0, 255).astype(np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    return [y, u, v]


def _reference(planes):
    """The JAX package's default keyframe (speed 6) of `planes` at q 100,
    with CDEF (0, 0, 0, 0, 3) and without: {cdef: (packet, recon)}, the
    phase-1 decision grids and the rd's decode-order edge tables. Both
    encodes share one compile of the mode pass and the recon."""
    cap = {}
    orig = jti.wavefront_frame

    def capturing(*a, **k):
        out = orig(*a, **k)
        cap["grids"] = [np.asarray(x) for x in out[6:]]
        cap["edges"] = [np.asarray(a[5][k_]) for k_ in ("has_tr", "d203_ok")]
        return out

    jti.wavefront_frame = capturing
    try:
        out = {}
        for cdef in (CDEF, None):
            pkt, rec = jti.encode_keyframe_tpu(planes, 100, cdef=cdef)
            out[cdef] = (pkt, [np.asarray(r) for r in rec])
    finally:
        jti.wavefront_frame = orig
    return out, cap["grids"], cap["edges"]


def _check_decoders(pkt, rec):
    fr = dav1d.decode_all([pkt])
    out = aom.decode_all([pkt])
    for i in range(3):
        assert np.array_equal(fr[0].planes[i], rec[i]), f"dav1d plane {i}"
        assert np.array_equal(out[0][i], rec[i]), f"aom plane {i}"


def _same_keyframes(planes, ref):
    """The port's default keyframe on the CPU, with CDEF (0, 0, 0, 0, 3)
    and without: decision grids, packets and recon equal the
    reference's; both decoders decode each packet exactly. Returns the
    port's decision grids."""
    (outs, grids, _) = ref
    for cdef in (CDEF, None):
        kd = tti.analyze_keyframe(planes, 100, cdef=cdef, device="cpu")
        got = [g.numpy() for g in kd.state[6:]]
        for name, a, b in zip(GRIDS, got, grids):
            np.testing.assert_array_equal(a, b, err_msg=name)
        pkt, rec = tti.pack_keyframe(kd, planes, 100, device="cpu")
        pkt_j, rec_j = outs[cdef]
        assert pkt == pkt_j, cdef
        for a, b in zip(rec, rec_j):
            np.testing.assert_array_equal(a, b)
        _check_decoders(pkt, rec)
    return dict(zip(GRIDS, got))


def test_speed6_keyframe_gate_off(shared_dir):
    """128x96 under the split8 gate: the default encode_keyframe_tpu
    equals rav1e_tpu's with and without CDEF, with CfL, a directional
    mode and each QUAD_TXS type taken, and no 16->8 split."""
    planes = gate_off()
    assert tti._detail_band8(planes[0]) <= 256.0
    ref = _once(shared_dir, "kf_speed6_gate_off_128x96",
                lambda: _reference(planes))
    g = _same_keyframes(planes, ref)
    whole = ~g["split"]
    assert (g["mu"][..., 0][whole] == int(P.UV_CFL_PRED)).any()
    assert (g["cfl"][whole] != 0).any()
    directional = [int(m) for m in MODE_TO_ANGLE]
    assert np.isin(g["my"][..., 0][whole], directional).any()
    assert np.isin(g["my"][..., 1:][g["split"]], directional).any()
    assert set(g["ytx"][g["split"]].ravel()) == {1, 2, 3, 4}
    assert not g["s16"].any()


def test_speed6_keyframe_gate_on(shared_dir):
    """64x64 over the split8 gate: quads split 16->8 into 8x8 luma and
    4x4 chroma blocks; the keyframe equals rav1e_tpu's with and without
    CDEF."""
    planes = gate_on()
    assert tti._detail_band8(planes[0]) > 256.0
    ref = _once(shared_dir, "kf_speed6_gate_on_64x64",
                lambda: _reference(planes))
    g = _same_keyframes(planes, ref)
    assert g["s16"].any() and not g["s16"].all()


def test_mode_sets_and_speeds_0_to_5_are_speed_6():
    """Speeds 0-6 share the keyframe toolset the reference reads."""
    for s in range(7):
        assert tti._mode_sets(s) == (tti.MODES_FULL, tti.MODES_UV_FULL,
                                     tti.MODES_QUAD)
        ss = tti.SpeedSettings.from_preset(s)
        assert (ss.partition_split_rdo, ss.tx_search, ss.kf_split8,
                ss.cfl) == (True,) * 4


@pytest.mark.parametrize("split8", [False, True])
def test_build_rd_speed6_tables(split8):
    """build_rd with CfL, the TX search and (split8) the 8x8 / 4x4 rate
    LUTs equals the JAX package's key by key, dtypes included."""
    args = (100, tti.MODES_FULL, tti.MODES_UV_FULL)
    kw = dict(modes_quad=tti.MODES_QUAD, use_cfl=True, tx_search=True,
              split8=split8)
    rd_j = jax.tree_util.tree_map(np.asarray, jti.build_rd(*args, **kw))
    rd_t = tti.build_rd(*args, device="cpu", **kw)
    assert ("y8" in rd_t) == split8 and "ytxb" in rd_t

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
                assert a[k].numpy().dtype == b[k].dtype, k

    same(rd_t, rd_j)


@pytest.mark.parametrize("bh,bw", [(1, 1), (3, 4), (2, 5), (5, 2), (34, 60)])
def test_skew_and_edge_tables_2ij(bh, bw, monkeypatch):
    """_skew_tables(ext=True) (d = 2i + j; 126 diagonals at 1080p) and
    the decode-order edge tables (has_tr, d203_ok) equal the reference's;
    the latter are taken from the rd its encode_keyframe_tpu builds,
    stopped before the mode pass compiles."""
    for a, b in zip(tti._skew_tables(bh, bw, True),
                    jti._skew_tables(bh, bw, True)):
        np.testing.assert_array_equal(a, b)
    if (bh, bw) == (34, 60):
        assert tti._skew_tables(bh, bw, True)[0].shape[0] == 126
    got = {}

    class Stop(Exception):
        pass

    def stop(*a, **k):
        got["rd"] = a[5]
        raise Stop

    monkeypatch.setattr(jti, "wavefront_frame", stop)
    planes = [np.zeros((32 * bh, 32 * bw), np.uint8),
              np.zeros((16 * bh, 16 * bw), np.uint8),
              np.zeros((16 * bh, 16 * bw), np.uint8)]
    with pytest.raises(Stop):
        jti.encode_keyframe_tpu(planes, 100)
    has_tr, d203_ok = tti._edge_tables(bh, bw)
    np.testing.assert_array_equal(has_tr, np.asarray(got["rd"]["has_tr"]))
    np.testing.assert_array_equal(d203_ok, np.asarray(got["rd"]["d203_ok"]))


def test_recon_starts_stay_in_range_on_2ij():
    """Every row start of the 2i+j recon is in range before the
    wrap-then-clamp rule applies (_clamp_row changes none), at shapes of
    one row, one column and more: the +3 state offset covers the top-left
    read at d - 3."""
    seen = []
    orig = tti._clamp_row

    def checking(arr, r):
        seen.append(0 <= r < arr.shape[0])
        return orig(arr, r)

    tti._clamp_row = checking
    try:
        for w, h in ((32, 32), (96, 32), (32, 96), (96, 64)):
            planes = [np.full((h, w), 120, np.uint8),
                      np.full((h // 2, w // 2), 128, np.uint8),
                      np.full((h // 2, w // 2), 128, np.uint8)]
            tti.analyze_keyframe(planes, 100, device="cpu")
    finally:
        tti._clamp_row = orig
    assert seen and all(seen)


def test_detail_band8_matches_reference():
    rng = np.random.default_rng(4)
    for y in (gate_off()[0], gate_on()[0],
              rng.integers(0, 256, (1088, 1920)).astype(np.uint8),
              rng.integers(0, 256, (40, 72)).astype(np.uint8)):
        assert tti._detail_band8(y) == jti._detail_band8(y)


def _cts(tx):
    return sorted({chroma_tx_type(m, tx, True)
                   for m in list(tti.MODES_UV_FULL) + [P.UV_CFL_PRED]},
                  key=int)


@pytest.mark.parametrize("tx,tt", [(TxSize.TX_4X4, t)
                                   for t in _cts(TxSize.TX_4X4)]
                         + [(TxSize.TX_8X8, TxType.DCT_DCT)])
def test_split8_transform_pairs(tx, tt):
    """The TX_4X4 chroma types of the 4x4 children (cts4) and the TX_8X8
    luma DCT of the 8x8 children: the f32 forward transform within the
    port's tolerance of the JAX function's on residual-like blocks
    (|d| <= 1, equal on >= 99.99%: ROADMAP.md section 3), the inverse
    bit-exact."""
    rng = np.random.default_rng(int(tt) + 10 * int(tx))
    n = tx.height
    res = (np.round(rng.normal(0, 20, (4096, n, n))).clip(-255, 255)
           .astype(np.int32))
    jtx, jtt = JTx(int(tx)), JTt(int(tt))
    cf_j = np.asarray(jT.forward_transform(jnp.asarray(res), jtx, jtt))
    d = np.abs(tT.forward_transform(_t(res), tx, tt).numpy()
               .astype(np.int64) - cf_j)
    assert d.max() <= 1 and (d == 0).mean() >= 0.9999
    lv = (cf_j // 7).astype(np.int32)
    np.testing.assert_array_equal(
        tT.inverse_transform(_t(lv), tx, tt).numpy(),
        np.asarray(jT.inverse_transform(jnp.asarray(lv), jtx, jtt)))


def test_split8_scan_layout():
    """scanline with split16 quads (8x8 / 4x4 scans), the nonzero
    stream and unpack_stream(split16) equal the JAX functions."""
    rng = np.random.default_rng(8)
    B = 6
    ly = rng.integers(-3, 4, (B, 32, 32)) * (rng.random((B, 32, 32)) < .06)
    lu = rng.integers(-3, 4, (B, 16, 16)) * (rng.random((B, 16, 16)) < .06)
    lv = rng.integers(-3, 4, (B, 16, 16)) * (rng.random((B, 16, 16)) < .06)
    ly, lu, lv = (x.astype(np.int32) for x in (ly, lu, lv))
    split = np.array([1, 0, 1, 1, 0, 1], bool)
    s16 = rng.random((B, 4)) < 0.5
    s16[0] = True
    state = [None] * 3 + [_t(x.reshape(2, 3, *x.shape[1:]))
                          for x in (ly, lu, lv)] + [None] * 2 + [
        _t(split.reshape(2, 3))]
    ly8, lu4, lv4 = tti._kf_sub_levels(state)
    q = [tti._kf_quads(_t(x), n) for x, n in ((ly, 16), (lu, 8), (lv, 8))]
    sl_t = tinter.scanline(_t(ly), _t(lu), _t(lv), *q, _t(split), B,
                           lv_y8=ly8, lv_u4=lu4, lv_v4=lv4,
                           split16=_t(s16))
    jq = [jti._kf_quads(jnp.asarray(x), n)
          for x, n in ((ly, 16), (lu, 8), (lv, 8))]
    jstate = [None] * 3 + [jnp.asarray(x.reshape(2, 3, *x.shape[1:]))
                           for x in (ly, lu, lv)] + [None] * 2 + [
        jnp.asarray(split.reshape(2, 3))]
    jl8 = jti._kf_sub_levels(jstate)
    sl_j = np.asarray(jinter.scanline(
        jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv), *jq,
        jnp.asarray(split), B, lv_y8=jl8[0], lv_u4=jl8[1], lv_v4=jl8[2],
        split16=jnp.asarray(s16)))
    np.testing.assert_array_equal(sl_t.numpy(), sl_j)
    cap = B * 128
    st_t = [x.numpy() for x in tinter.nnz_stream(sl_t, cap)]
    st_j = [np.asarray(x) for x in jinter.nnz_stream(jnp.asarray(sl_j), cap)]
    for a, b in zip(st_t, st_j):
        np.testing.assert_array_equal(a, b)
    out_t = tinter.unpack_stream(*st_t, split, cap, s16)
    out_j = jinter.unpack_stream(*st_j, split, cap, split16=s16)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert not out_t[3].any()           # no block past its stream slots
    for a, b in zip(out_t, (ly, lu, lv)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h", [(64, 64), (96, 256)])
def test_deblock_sub_map(w, h):
    """The deblock search with the 16->8 sub_map (8-tap luma / 4-tap
    chroma grid edges next to sub cells, and the half-spacing edges
    inside split quads) on the split map's 16/8-px grid equals the JAX
    function, level and planes; at 256 rows on its centre-band
    estimate."""
    rng = np.random.default_rng(w + h)
    src, rec = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        yy, xx = np.mgrid[0:ph, 0:pw]
        s = 120 + 40 * np.sin(xx / 9) * np.cos(yy / 13)
        # the coded blocks' offsets: 4-px steps the filter can smooth
        r = s + np.kron(rng.integers(-6, 7, (ph // 4, pw // 4)),
                        np.ones((4, 4)))
        src.append(s.astype(np.int32))
        rec.append(r.clip(0, 255).astype(np.int32))
    split = rng.random((h // 32, w // 32)) < 0.7
    sub = (rng.random((h // 8, w // 8)) < 0.4) & np.kron(
        split, np.ones((4, 4), bool))
    lv_j, out_j = jax.jit(jdb.deblock_search, static_argnums=(3, 4, 5))(
        [jnp.asarray(p) for p in rec], [jnp.asarray(s) for s in src],
        jnp.int32(20), 16, 8, 8, jnp.asarray(split),
        sub_map=jnp.asarray(sub))
    lv_t, out_t = tdb.deblock_search([_t(p) for p in rec],
                                     [_t(s) for s in src], 20, 16, 8, 8,
                                     _t(split), _t(sub))
    assert int(lv_t) == int(lv_j) > 0
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- step 0: f32 sums past 2^24 ---------------------------------------------

def noise_at_q255(w, h, seed):
    """Binary noise (0 / 255) as the source and, as its recon, the 8x8
    block means with mild noise (what q 255 leaves of it): per-plane SB
    SSEs pass 2^24. (recon, source, skip8) int32 / bool."""
    rng = np.random.default_rng(seed)
    rec, src = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        s = np.where(rng.random((ph, pw)) < 0.5, 0, 255).astype(np.int32)
        m = s.reshape(ph // 8, 8, pw // 8, 8).mean((1, 3))
        r = np.kron(m, np.ones((8, 8))) + rng.normal(0, 12, (ph, pw))
        rec.append(r.clip(0, 255).astype(np.int32))
        src.append(s)
    return rec, src, rng.random((h // 8, w // 8)) < 0.1


_j_search = jax.jit(jc.cdef_search_persb_jax, static_argnames=("bd",))


def _exact_table(*args):
    """cdef_ladder_sse's table in exact integers (int64), to show where a
    cell passes 2^24 and where f32 rounding in another order would
    differ from the reference's."""
    errs, dims = tc._ladder_errors(*args, bd=8)
    return torch.stack([torch.sum(d.long() ** 2, dim=dims) for d in errs])


@pytest.mark.parametrize("seed", [19, 5, 14, 28, 0])
def test_cdef_ladder_index_past_2_24(seed):
    """256x192 (the sampled branch, 12 SBs) on noise_at_q255: a luma SB
    SSE passes 2^24 (checked on the exact integers), and the per-SB ladder
    index and filtered planes equal cdef_search_persb_jax's with and
    without the subset RD. Other orders choose other entries here: the
    exact integer tables at seed 19 (lam 60), tables summed one element
    at a time at seeds 5 (lam 60) and 28 (no subset RD), and the
    subset RD's total summed one SB at a time at seeds 5 and 14 (lam
    2000)."""
    w, h = 256, 192
    rec, src, skip8 = noise_at_q255(w, h, seed)
    dirs, var = tc.cdef_dirs(_t(rec[0]))
    exact = _exact_table(_t(rec[0]), _t(src[0]), dirs, var, _t(skip8), 3,
                         False, True)
    assert int(exact.max()) >= 2 ** 24
    for lam in (None, 60.0, 2000.0):
        ij, pj = _j_search([jnp.asarray(p) for p in rec],
                           [jnp.asarray(p) for p in src], jnp.asarray(skip8),
                           3, lam=None if lam is None else jnp.float32(lam))
        it, pt = tc.cdef_search_persb([_t(p) for p in rec],
                                      [_t(p) for p in src], _t(skip8), 3,
                                      lam=None if lam is None
                                      else torch.tensor(lam))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                      err_msg=str(lam))
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=1)
def _reference_tables():
    """cdef_search_persb_jax, jitted, returning each plane's f32 SSE table
    where it would rank them: the function's own source with that return
    put in front of the ranking. (A standalone jnp.sum of the same squares
    sums in another order: XLA:CPU vectorizes the reduce fused into the
    filter, not the one alone.)"""
    src = inspect.getsource(jc.cdef_search_persb_jax).replace(
        "def cdef_search_persb_jax(", "def tables(")
    ret = ("    if sampled:\n"
           "        return [samp_sse(o, s) for o, s in zip(outs_s, "
           "(src_ys, src_us, src_vs))]\n"
           "    return [blk_sse(outs[i], srcs[i], b) for i, b in "
           "((0, 32), (1, 16), (2, 16))]\n")
    at = "    if lam is not None:\n"
    assert src.count(at) == 1
    ns = dict(vars(jc))
    exec(src.replace(at, ret + at), ns)
    return jax.jit(ns["tables"], static_argnames=("bd",))


@pytest.mark.parametrize("w,h", [(256, 192), (160, 96)])
def test_ladder_sse_f32_order(w, h):
    """cdef_ladder_sse's f32 table (the port's order, _xla_rows_sum)
    equals the reference's SSE tables bit for bit on every plane of
    noise_at_q255 with a heavier error, sampled (256x192) and full
    (160x96, not 64-aligned), where the exact integers rounded once to
    f32 do not."""
    rec, src, skip8 = noise_at_q255(w, h, 11)
    rec = [np.clip(r // 4, 0, 255) for r in rec]     # RMS error ~150
    want = _reference_tables()([jnp.asarray(p) for p in rec],
                               [jnp.asarray(p) for p in src],
                               jnp.asarray(skip8), 3)
    sampled = h % 64 == 0 and w % 64 == 0
    dirs, var = tc.cdef_dirs(_t(rec[0]))
    tables = tc.cdef_ladder_sse([_t(p) for p in rec], [_t(p) for p in src],
                                dirs, var, _t(skip8), 3, sampled)
    for i in range(3):
        args = (_t(rec[i]), _t(src[i]), dirs, var, _t(skip8), 3, i > 0,
                sampled)
        exact = _exact_table(*args)
        got = tables[i]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))
        if i == 0:
            assert int(exact.max()) >= 2 ** 24
            assert not np.array_equal(exact.float().numpy(),
                                      np.asarray(want[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(256, 192), (160, 96)])
def test_ladder_sse_kernel_past_2_24_on_card(w, h):
    """On the card: the cdef_ladder_sse kernel's f32 tables equal the
    plain version's bit for bit where a cell passes 2^24 (the content of
    test_ladder_sse_f32_order), every block taking the ordered path, and
    the search's index and planes equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = noise_at_q255(w, h, 11)
    rec = [np.clip(r // 4, 0, 255) for r in rec]
    sampled = h % 64 == 0 and w % 64 == 0
    dirs, var = tc.cdef_dirs(_t(rec[0]).cuda())
    paths = tc.path_counts("cuda")
    paths.zero_()
    tables = tc.cdef_ladder_sse([_t(p).cuda() for p in rec],
                                [_t(p).cuda() for p in src], dirs, var,
                                _t(skip8).cuda(), 3, sampled)
    assert paths[:2].tolist() == [0, tables[0, 0].numel()]
    for i in range(3):
        args = (_t(rec[i]).cuda(), _t(src[i]).cuda(), dirs, var,
                _t(skip8).cuda(), 3, i > 0, sampled)
        got = tables[i]
        assert torch.equal(got, tc.cdef_ladder_sse_plain(*args)), i
        if i == 0:
            assert float(got.max()) >= 2 ** 24
    lam = torch.tensor(60.0)
    ic, pc = tc.cdef_search_persb([_t(p).cuda() for p in rec],
                                  [_t(p).cuda() for p in src],
                                  _t(skip8).cuda(), 3, lam=lam.cuda())
    ih, ph = tc.cdef_search_persb([_t(p) for p in rec], [_t(p) for p in src],
                                  _t(skip8), 3, lam=lam)
    assert torch.equal(ic.cpu(), ih)
    for a, b in zip(pc, ph):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("nr,nc", [(1, 1), (2, 2), (2, 3), (3, 4), (4, 4),
                                   (4, 6), (4, 8), (17, 30), (1, 17), (3, 6),
                                   (4, 5), (3, 7), (5, 5), (4, 7), (5, 6),
                                   (1, 31)])
def test_subset_sum_in_the_fused_order(nr, nc):
    """The subset RD's total over nr * nc SBs, inside the fused reduce
    that picks the subset (the reference's expression, jitted): the
    port's _choose picks the same ladder entries on SB SSEs of 2^24 to
    2^26, where the order of the f32 sum decides: at 17-31 SBs LLVM
    vectorizes the sum over 8 or 4 lanes by n % 8 (17, 18, 20, 21, 25,
    28, 30, 31 here), elsewhere 8 lanes or XLA's tree."""
    masks, bits = tc._subsets(nr * nc)

    @jax.jit
    def ref_choose(sse_sb, lam):
        flat = sse_sb.reshape(8, -1)
        msse = jnp.where(jnp.asarray(masks)[:, :, None], flat[None], jnp.inf)
        tot = msse.min(1).sum(1) + lam * jnp.asarray(bits)
        allowed = jnp.asarray(masks)[jnp.argmin(tot)]
        return jnp.argmin(jnp.where(allowed[:, None, None], sse_sb, jnp.inf),
                          axis=0)

    rng = np.random.default_rng(nr * 100 + nc)
    for _ in range(40):
        base = rng.integers(2 ** 24, 2 ** 26, (nr, nc))
        sse = (base[None] + rng.integers(0, 64, (8, nr, nc)) * 4
               ).astype(np.float32)
        lam = float(rng.choice([0.5, 2.0, 50.0]))
        ij = np.asarray(ref_choose(jnp.asarray(sse), jnp.float32(lam)))
        it = tc._choose(_t(sse), torch.tensor(lam, dtype=torch.float32))
        np.testing.assert_array_equal(it.numpy(), ij)


def test_forward_transform_count_on_the_slice_content():
    """ROADMAP.md section 3: the port's f32 forward transform against the
    reference's on this file's two keyframes' blocks (their mean taken
    out), at every TX size and type the speed-6 keyframe codes: 0 of
    196,608 coefficients differ here (the tolerance the port holds it
    to: |d| <= 1 on fewer than 1e-4 of them); the decisions that rank
    them are compared whole by the keyframe tests above (none differs)."""
    total = differ = worst = 0
    for planes in (gate_off(), gate_on()):
        y, u, v = (p.astype(np.int32) for p in planes)

        def blocks(p, n):
            h, w = p.shape
            b = (p.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
                 .reshape(-1, n, n))
            return b - np.round(b.mean((1, 2), keepdims=True)).astype(
                np.int32)

        cases = ([(y, 32, TxSize.TX_32X32, TxType.DCT_DCT),
                  (y, 8, TxSize.TX_8X8, TxType.DCT_DCT)]
                 + [(y, 16, TxSize.TX_16X16, t) for t in tti.QUAD_TXS]
                 + [(p, tx.height, tx, t) for tx in (TxSize.TX_16X16,
                                                     TxSize.TX_8X8,
                                                     TxSize.TX_4X4)
                    for t in _cts(tx) for p in (u, v)])
        for p, n, tx, tt in cases:
            r = blocks(p, n)
            a = np.asarray(jT.forward_transform(
                jnp.asarray(r), JTx(int(tx)), JTt(int(tt))))
            d = np.abs(tT.forward_transform(_t(r), tx, tt).numpy()
                       .astype(np.int64) - a)
            total += d.size
            differ += int((d != 0).sum())
            worst = max(worst, int(d.max()))
    assert total == 196608
    assert worst <= 1 and differ * 1e4 < total, (differ, worst)
