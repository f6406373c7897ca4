"""The port's speed-6 P frame (SATD in the subpel descent, the 16->8
split, the 64x64 merge and intra-in-inter) against the JAX package's, on
the CPU, with the same numpy-made inputs.

Compared whole: encode_pframe_tpu with all four tools and refine16 (the
branch speeds 3-4 take) at 192x128, where every tool is taken (its
decision buffer, fetched decisions, packet and recon), the same step on
noise where the merge's and intra-in-inter's f32 SSEs pass 2^24, and the
speed-6 encode_gop_tpu (KEY + 2 P with CDEF) at 64x64, whose one 64x64
SB can merge. Both decoders (libdav1d, libaom) decode the port's packets
exactly. Two JAX P steps are compiled (192x128 with refine16, 64x64
without); the GOP's keyframe is tests/test_torch_speed6.py's gate-on
reference, shared through the same locked file, so no keyframe is
compiled here. The parts are held to the JAX functions directly: satd,
the 4-tap MC bank, the deblock merge_map, the TX_64X64 transform pair and
the packed decision buffer's fields."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rav1e_tpu.core.constants import TxSize as JTx
from rav1e_tpu.core.constants import TxType as JTt
from rav1e_tpu.ops.ref import transforms as jR
from rav1e_tpu.ops.tpu import deblock as jdb
from rav1e_tpu.ops.tpu import transforms as jT
from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu_torch.api.speed import SpeedSettings
from rav1e_tpu_torch.core.constants import TxSize, TxType
from rav1e_tpu_torch.ops import deblock as tdb
from rav1e_tpu_torch.ops import transforms as tT
from rav1e_tpu_torch.ops.cdef import _xla_rows_sum
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from test_torch_inter import _decode_exactly
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)
from test_torch_speed6 import CDEF, gate_on
from test_torch_speed6 import _reference as kf_reference

W, H = 192, 128
# the speed-6 P tools with refine16 on (speeds 3-4), as _core takes them
TOOLS = dict(use_split=True, use_satd=True, refine16=True, intra_rdo=True,
             b64_rdo=True, search=16, subpel=True, use_split8=True, bd=8)
PFRAME = {k: v for k, v in TOOLS.items() if k != "bd"}
NAMES = ("mv8", "skip", "lv_y", "lv_u", "lv_v", "split", "mv16", "skip16",
         "lf_lvl", "cdef_idx", "choice", "mvb8", "b64_map", "split16",
         "skip8")


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread, hand the worker's freed heap back to the
    system around the module (glibc's malloc_trim), and drop its JAX
    compiles after it."""
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def p_frames(w=W, h=H, seed=5):
    """A texture panning 3 px left and 2 px up (the reference, then the
    frame), with static sharp 8x8 squares (quads split 16->8), a flat
    ramp (64x64 merges) and, in the second frame only, two flat 32x32
    squares the reference does not hold (intra-in-inter)."""
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(0, 40, (h + 40, w + 40)), 2.0)
    out = []
    for t in range(2):
        oy, ox = 20 - 2 * t, 20 - 3 * t
        y = 128 + tex[oy:oy + h, ox:ox + w]
        y[64:128, 0:64] = 90 + 0.2 * np.arange(64)[None, :]
        for r, c, val in ((8, 72, 230), (40, 136, 30), (72, 104, 220)):
            y[r:r + 8, c:c + 8] = val
        if t == 1:
            for r, c, val in ((0, 160, 250), (96, 96, 10)):
                y[r:r + 32, c:c + 32] = val
        yd = y.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        out.append([y.clip(0, 255).astype(np.uint8),
                    (128 + 0.3 * (yd - 128)).clip(0, 255).astype(np.uint8),
                    (128 - 0.2 * (yd - 128)).clip(0, 255).astype(np.uint8)])
    return out


def noise_frame(seed=1):
    """p_frames' second frame with uniform noise on its luma and binary
    noise (0 / 255) on the left half: the merge's luma SSEs and
    intra-in-inter's pass 2^24."""
    rng = np.random.default_rng(seed)
    cur = [p.copy() for p in p_frames()[1]]
    cur[0] = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cur[0][:, :96] = np.where(rng.random((H, 96)) < 0.5, 0, 255)
    return cur


def _jax_step(frame, ref):
    nby, nbx = H // 32, W // 32
    step, _, gather = jinter._core(H, W, False, **TOOLS)
    o = step(jnp.asarray(jinter.pack_src(frame)),
             *(jnp.asarray(r) for r in ref),
             jnp.int32(jinter.dc_q_lut(100)), jnp.int32(jinter.ac_q_lut(100)),
             jnp.asarray([0, 0, 0, 0, 3], jnp.int32),
             jinter.build_rd_inter(100), jinter._ds16_quads(None, nby, nbx))
    dec = jinter._fetch_packed(o, gather, nby, nbx)
    return np.asarray(o[0]), [np.asarray(x) for x in dec]


def _port_step(frame, ref):
    cpu = torch.device("cpu")
    nby, nbx = H // 32, W // 32
    step, _, gather = tinter._core(H, W, False, **TOOLS)
    o = step(_t(tinter.pack_src(frame)), *(_t(r) for r in ref),
             *tinter._q_scalars(100, cpu), (0, 0, 0, 0, 3),
             tinter.build_rd_inter(100, device=cpu),
             tinter._ds16_quads(None, nby, nbx, cpu))
    return o, o[0].numpy(), tinter._fetch_packed(o, gather, nby, nbx)


def _pframe_reference():
    """The JAX package's encode_pframe_tpu with the four tools and
    refine16 on p_frames(): packet, recon, the packed decision buffer and
    the fetched decisions; and the same step (one compile) on
    noise_frame()."""
    ref, cur = p_frames()
    pkt, rec = jinter.encode_pframe_tpu(cur, ref, **PFRAME)
    return {"pkt": pkt, "rec": [np.asarray(r) for r in rec],
            "step": _jax_step(cur, ref),
            "noise": _jax_step(noise_frame(), ref)}


def _same_decisions(got, want):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_speed6_pframe_decisions_match_reference(shared_dir):
    """The port's P step with the four speed-6 tools and refine16: the
    packed decision buffer (MVs, split / split16 / b64 / choice maps,
    skips, the levels' nonzero stream) byte for byte, and its host unpack;
    every tool is taken (SATD ranks every descent)."""
    want = _once(shared_dir, "pframe_speed6_tools", _pframe_reference)
    ref, cur = p_frames()
    _, buf, dec = _port_step(cur, ref)
    np.testing.assert_array_equal(buf, want["step"][0])
    _same_decisions(dec, want["step"][1])
    d = dict(zip(NAMES, dec))
    assert d["split"].any()
    assert d["split16"].any()
    assert d["b64_map"].any()
    assert (d["choice"] == 3).any()
    # quads split 16->8 only inside split blocks; a merged SB's four
    # blocks share one MV and none of them is intra
    assert not (d["split16"] & ~d["split"][:, None]).any()
    b64 = np.repeat(np.repeat(d["b64_map"], 2, 0), 2, 1).reshape(-1)
    mv = d["mv8"].reshape(H // 32, W // 32, 2)
    for i, j in zip(*np.nonzero(d["b64_map"])):
        assert (mv[2 * i:2 * i + 2, 2 * j:2 * j + 2] == mv[2 * i,
                                                            2 * j]).all()
    assert not (b64 & (d["choice"] == 3)).any()


def test_speed6_pframe_packet_identical_and_conformant(shared_dir):
    """encode_pframe_tpu(..., use_satd=True, intra_rdo=True,
    b64_rdo=True, use_split8=True) on the CPU: packet and recon equal the
    JAX package's; the P frame against the port's speed-10 keyframe of
    its reference decodes on libdav1d and libaom to the port's recon."""
    ref, cur = p_frames()
    pkt, rec = tinter.encode_pframe_tpu(cur, ref, device="cpu", **PFRAME)
    from rav1e_tpu_torch.pipeline import tpu_intra as tti
    kf_pkt, kf_rec = tti.encode_keyframe_tpu(ref, 100, speed=10,
                                             device="cpu")
    got = []
    orig = tinter._fetch_packed

    def recording(*a, **k):
        got.append(orig(*a, **k))
        return got[-1]

    tinter._fetch_packed = recording
    try:
        pkt2, rec2 = tinter.encode_pframe_tpu(
            cur, [r.astype(np.uint8) for r in kf_rec], device="cpu",
            **PFRAME)
    finally:
        tinter._fetch_packed = orig
    d = dict(zip(NAMES, got[0]))
    assert d["b64_map"].any() and (d["choice"] == 3).any()
    _decode_exactly([kf_pkt, pkt2], [kf_rec, rec2])
    # the reference last: another worker may still be computing it
    want = _once(shared_dir, "pframe_speed6_tools", _pframe_reference)
    assert pkt == want["pkt"]
    for a, b in zip(rec, want["rec"]):
        np.testing.assert_array_equal(a, b)


def test_merge_and_intra_sums_past_2_24(shared_dir):
    """On noise_frame() the merge's 64x64 luma SSEs and intra-in-inter's
    32x32 ones pass 2^24, where the f32 order decides: the port's
    (_sse64_xla, _sse_cols_xla, _sse_rows_xla, read from the reference's
    fused loops) gives the reference's decision buffer byte for byte,
    and on these blocks a plain sum in another order rounds otherwise."""
    ref = p_frames()[0]
    cur = noise_frame()
    _, buf, dec = _port_step(cur, ref)
    y = _t(cur[0]).to(torch.int32)
    pred = _t(ref[0]).to(torch.int32)
    b64 = tinter.to_blocks(y, 64)
    p64 = tinter.to_blocks(pred, 64)
    exact = ((b64 - p64).long() ** 2).sum((1, 2))
    assert int(exact.max()) >= 2 ** 24
    xla = tinter._sse64_xla(p64, b64)
    seq = tinter._sse_cols_xla(p64, b64)
    assert not torch.equal(xla, seq)
    b32, p32 = tinter.to_blocks(y, 32), tinter.to_blocks(pred, 32)
    assert int(((b32 - p32).long() ** 2).sum((1, 2)).max()) >= 2 ** 24
    assert not torch.equal(tinter._sse_rows_xla(p32, b32),
                           _xla_rows_sum((p32 - b32).float() ** 2, 8))
    # the reference last: another worker may still be computing it
    want = _once(shared_dir, "pframe_speed6_tools", _pframe_reference)
    np.testing.assert_array_equal(buf, want["noise"][0])
    _same_decisions(dec, want["noise"][1])


def _gop_frames():
    """gate_on()'s 64x64 keyframe (its 16->8 split on), then two frames
    panned 2 px right and 1 down each (wrapping)."""
    kf = gate_on()
    out = [kf]
    for t in (1, 2):
        out.append([np.roll(p, (t // s if s == 1 else 0, 2 * t // s),
                            (0, 1)).copy()
                    for p, s in zip(kf, (1, 2, 2))])
    return out


def _gop_step(h, w):
    """The reference's speed-6 P step at h x w (as its encode_gop_tpu
    builds it): step(frame, ref planes) -> its outputs."""
    ss = SpeedSettings.from_preset(6)
    step, (nby, nbx), gather = jinter._core(
        h, w, True, use_split=ss.partition_split_rdo,
        use_satd=ss.satd_subpel, refine16=ss.mv_refine_16,
        intra_rdo=ss.intra_in_inter, b64_rdo=ss.b64_merge,
        search=ss.search_px, subpel=ss.subpel,
        use_split8=ss.partition_split8)

    def run(f, ref):
        return step(jnp.asarray(jinter.pack_src(f)), *ref,
                    jnp.int32(jinter.dc_q_lut(100)),
                    jnp.int32(jinter.ac_q_lut(100)),
                    jnp.asarray(list(CDEF), jnp.int32),
                    jinter.build_rd_inter(100),
                    jinter._ds16_quads(None, nby, nbx))
    return run, gather, nby, nbx


def _gop_p_frames(kf_rec):
    """The JAX package's speed-6 P frames of _gop_frames() with CDEF after
    the keyframe recon kf_rec, as its encode_gop_tpu makes them: each
    through the reference's _core step on the previous recon, then
    _fetch_packed and _pack_pframe with the speed-6 options. (packets,
    recons)"""
    frames = _gop_frames()
    h, w = frames[0][0].shape
    run, gather, nby, nbx = _gop_step(h, w)
    ref = [jnp.asarray(np.asarray(r, np.uint8)) for r in kf_rec]
    pkts, recs = [], []
    for i, f in enumerate(frames[1:], start=1):
        o = run(f, ref)
        ref = o[4:7]
        (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf, cmap,
         choice, _, b64m, split16, skip8) = jinter._fetch_packed(
            o, gather, nby, nbx)
        pkts.append(jinter._pack_pframe(
            h, w, 100, i, mv8, skip, lv_y, lv_u, lv_v, cdef=(CDEF, cmap),
            lf_level=lf, split=split, mv16=mv16, skip16=skip16,
            choice=choice, b64_map=b64m, split16=split16, skip8=skip8))
        recs.append([np.asarray(r) for r in o[4:7]])
    return pkts, recs


def test_speed6_gop_identical_and_conformant(shared_dir):
    """encode_gop_tpu(frames, 100, speed=6, cdef=(0, 0, 0, 0, 3)) on the
    CPU, KEY + 2 P at 64x64: every packet and recon equals the JAX
    package's speed-6 GOP, and the stream decodes exactly on libdav1d and
    libaom."""
    frames = _gop_frames()
    pkts, recs = tinter.encode_gop_tpu(frames, 100, speed=6, cdef=CDEF,
                                       device="cpu")
    recs = [recs[0]] + [[r.numpy().astype(np.int32) for r in rec]
                        for rec in recs[1:]]
    _decode_exactly(pkts, recs)
    # compile the reference's P step before the keyframe, which may still
    # be on its way from test_torch_speed6.py's worker
    run, _, _, _ = _gop_step(64, 64)
    run(frames[1], [jnp.asarray(p) for p in frames[0]])
    kf = _once(shared_dir, "kf_speed6_gate_on_64x64",
               lambda: kf_reference(frames[0]))[0][CDEF]
    pkts_j, recs_j = _once(shared_dir, "gop_speed6_64x64",
                           lambda: _gop_p_frames(kf[1]))
    assert pkts[0] == kf[0]
    assert pkts[1:] == pkts_j
    for got, want in zip(recs, [kf[1]] + recs_j):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("speed", [5])
def test_speed5_gop_is_speed6(speed):
    """encode_gop_tpu reads the same P tools at speeds 5 and 6
    (api/speed.py), so speed 5 gives speed 6's packets (the port alone)."""
    frames = _gop_frames()
    p6, _ = tinter.encode_gop_tpu(frames, 100, speed=6, cdef=CDEF,
                                  device="cpu")
    p5, _ = tinter.encode_gop_tpu(frames, 100, speed=speed, cdef=CDEF,
                                  device="cpu")
    assert p5 == p6


# ---- the parts --------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "plus_255", "minus_255",
                                  "checker_255", "hadamard_255"])
def test_satd_matches_reference(case):
    """satd (int32 Hadamard, one f32 cast) equals the reference's f32
    einsum at 32x32 and 16x16, on random residuals and on the 8-bit
    extremes: constant +-255 and a +-255 checkerboard (one output of
    64 x 255 a tile), and 255 x the Hadamard pattern in every tile (all
    64 outputs at 8 x 255: the largest total a block can reach, 2,088,960
    at 32x32, below 2^24)."""
    rng = np.random.default_rng(3)
    had = np.array([[(-1) ** bin(i & j).count("1") for j in range(8)]
                    for i in range(8)])
    for n in (32, 16):
        yy, xx = np.mgrid[0:n, 0:n]
        if case == "random":
            d = rng.integers(-255, 256, (64, n, n))
        elif case == "checker_255":
            d = np.broadcast_to(np.where((xx + yy) % 2, 255, -255),
                                (4, n, n))
        elif case == "hadamard_255":
            d = np.broadcast_to(255 * had[yy % 8, xx % 8], (4, n, n))
        else:
            d = np.full((4, n, n), 255 if case == "plus_255" else -255)
        d = d.astype(np.int32)
        got = tinter.satd(_t(d)).numpy()
        want = np.asarray(jax.jit(jinter.satd)(jnp.asarray(d)))
        np.testing.assert_array_equal(got, want)
        if case == "hadamard_255":
            assert got.max() * 8 == 64 * 8 * 255 * (n // 8) ** 2
        elif case != "random":
            assert got.max() * 8 == 64 * 255 * (n // 8) ** 2


@pytest.mark.parametrize("n", [16, 8])
def test_four_tap_mc_every_phase(n):
    """_mc_filter(four_tap=True) on the windows of a padded chroma plane
    equals the reference's _mc_batch(four_tap=True) at every (row,
    column) phase of the 16, bit for bit."""
    rng = np.random.default_rng(n)
    plane = rng.integers(0, 256, (64 + 32, 96 + 32)).astype(np.int32)
    fr, fc = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    B = fr.size
    # at 4:2:0 an eighth-pel luma MV is a sixteenth-pel chroma one: its
    # low 4 bits are the phase
    mv8 = np.stack([fr.ravel() + 16 * rng.integers(-2, 3, B),
                    fc.ravel() + 16 * rng.integers(-2, 3, B)], 1)
    pos_r = (rng.integers(0, 64 // n, B) * n).astype(np.int32)
    pos_c = (rng.integers(0, 96 // n, B) * n).astype(np.int32)
    (patch, r, c), = tinter._mc_windows([(_t(plane), _t(pos_r), _t(pos_c),
                                          _t(mv8.astype(np.int32)), n, 1)])
    got = tinter._mc_filter(patch, r, c, n, four_tap=True)
    want = jinter._mc_batch(jnp.asarray(plane), jnp.asarray(pos_r),
                            jnp.asarray(pos_c),
                            jnp.asarray(mv8.astype(np.int32)), n, 1,
                            four_tap=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eight = tinter._mc_filter(patch, r, c, n)
    assert not torch.equal(got, eight)


@pytest.mark.parametrize("w,h", [(128, 128), (192, 256)])
def test_deblock_merge_map(w, h):
    """The deblock search with a merge map (a merged SB's inner 32-level
    edges off), the split map and the 16->8 sub_map on the P frame's
    16/8-px grid equals the JAX function, level and planes; at 256 rows
    on its centre-band estimate."""
    rng = np.random.default_rng(w + h)
    src, rec = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        yy, xx = np.mgrid[0:ph, 0:pw]
        s = 120 + 40 * np.sin(xx / 9) * np.cos(yy / 13)
        r = s + np.kron(rng.integers(-6, 7, (ph // 4, pw // 4)),
                        np.ones((4, 4)))
        src.append(s.astype(np.int32))
        rec.append(r.clip(0, 255).astype(np.int32))
    merge = rng.random((h // 64, w // 64)) < 0.5
    merge[0, 0] = True
    split = (rng.random((h // 32, w // 32)) < 0.6) & ~np.kron(
        merge, np.ones((2, 2), bool))
    sub = (rng.random((h // 8, w // 8)) < 0.4) & np.kron(
        split, np.ones((4, 4), bool))
    lv_j, out_j = jax.jit(jdb.deblock_search, static_argnums=(3, 4, 5))(
        [jnp.asarray(p) for p in rec], [jnp.asarray(s) for s in src],
        jnp.int32(20), 16, 8, 8, jnp.asarray(split),
        merge_map=jnp.asarray(merge), sub_map=jnp.asarray(sub))
    lv_t, out_t = tdb.deblock_search([_t(p) for p in rec],
                                     [_t(s) for s in src], 20, 16, 8, 8,
                                     _t(split), _t(sub), merge_map=_t(merge))
    assert int(lv_t) == int(lv_j) > 0
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, no_merge = tdb.deblock_search([_t(p) for p in rec],
                                     [_t(s) for s in src], 20, 16, 8, 8,
                                     _t(split), _t(sub))
    assert not torch.equal(no_merge[0], out_t[0])


def test_tx64_pair_and_count():
    """Step 0 for TX_64X64 (the merge's luma, the port's first): the
    inverse equals the JAX package's spec inverse (ops/ref, which its
    batched inverse equals) bit for bit, and the f32 forward
    transform is held to |d| <= 1 on fewer than 1e-4 of the coefficients
    of the P frames' 64x64 blocks (mean taken out), of their differences
    and of +-255 residuals (on this sandbox's CPU 0 of these 106,496
    differ; ROADMAP section 3 has the step-0 counts of every TX size the
    P step codes)."""
    rng = np.random.default_rng(64)
    lv = np.zeros((8, 64, 64), np.int32)
    lv[:, :32, :32] = rng.integers(-200, 201, (8, 32, 32))
    got = tT.inverse_transform(_t(lv), TxSize.TX_64X64, TxType.DCT_DCT)
    want = np.stack([jR.inverse_transform(x, JTx.TX_64X64, JTt.DCT_DCT)
                     for x in lv])
    np.testing.assert_array_equal(got.numpy(), want)
    ref, cur = p_frames()
    blocks = [tinter.to_blocks(_t(p[0]).to(torch.int32), 64).numpy()
              for p in (ref, cur)]
    resid = [b - np.round(b.mean((1, 2), keepdims=True)).astype(np.int32)
             for b in blocks]
    resid.append(blocks[1] - blocks[0])
    resid.append(np.where(rng.random((8, 64, 64)) < 0.5, 255,
                          -255).astype(np.int32))
    x = np.concatenate(resid)
    a = tT.forward_transform(_t(x), TxSize.TX_64X64, TxType.DCT_DCT).numpy()
    b = np.asarray(jT.forward_transform(jnp.asarray(x), JTx.TX_64X64,
                                        JTt.DCT_DCT))
    d = np.abs(a.astype(np.int64) - b)
    assert d.max() <= 1
    assert (d != 0).sum() * 1e4 < d.size
    assert not a[:, 32:, :].any() and not a[:, :, 32:].any()


def test_pack_outputs_speed6_fields():
    """pack_outputs / unpack_outputs with every speed-6 field set (the
    b64 map, choice 0 and 3, split16 nibbles, skip8 bits, split blocks'
    mv16) equal the reference's bytes and fields."""
    rng = np.random.default_rng(6)
    nby, nbx = 4, 6
    B = nby * nbx
    nsb = (nby // 2, nbx // 2)
    split = rng.random(B) < 0.5
    o = [rng.integers(-300, 300, (B, 2)), rng.random(B) < 0.4,
         rng.integers(-3, 4, (B, 1536)) * (rng.random((B, 1536)) < 0.05),
         None, None, None, None, None, None,
         np.int32(17), rng.integers(0, 8, nsb),
         split, rng.integers(-300, 300, (B, 4, 2)), rng.random((B, 4)) < 0.5,
         np.where(rng.random(B) < 0.3, 3, 0), np.zeros((B, 2)),
         rng.random(nsb) < 0.5, (rng.random((B, 4)) < 0.5) & split[:, None],
         rng.random((B, 4, 4)) < 0.5]
    dtypes = {0: np.int32, 2: np.int16, 10: np.int32, 12: np.int32,
              14: np.int32, 15: np.int32}
    o = [None if x is None else np.asarray(x, dtypes.get(i, None))
         for i, x in enumerate(o)]
    want = np.asarray(jinter.pack_outputs(
        [None if x is None else jnp.asarray(x) for x in o]))
    got = tinter.pack_outputs([None if x is None else _t(x) for x in o])
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tinter.unpack_outputs(want, nby, nbx),
                    jinter.unpack_outputs(want, nby, nbx)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
