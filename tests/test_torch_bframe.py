"""The port's two-reference step (the B frame and the LAST + GOLDEN P
frame) against the JAX package's, on the CPU, with the same numpy-made
inputs.

Compared whole at 128x96: encode_bframe_tpu with the split and CDEF on
the fade + occluding-mover group of tests/_torch_content.py (its packed
decision buffer, fetched decisions, packet and recon; every block kind
taken), the same step on noise at q 255, where the re-judge's and the
ref choice's f32 SSEs pass 2^24, and encode_pframe2_tpu (LAST + GOLDEN,
SATD in the descent). Two JAX steps are compiled (the B step with split,
the fwd2 step), once per test run through the shared locked file. The
compound MC is held to the JAX functions at every phase; the port's own
reordered group (KEY, a non-shown anchor, B0, B1, SEF, B1, SEF) and a
KEY -> P -> LAST + GOLDEN chain decode exactly on libdav1d and libaom."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_content import bgroup
from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu_torch.entropy.obu import show_existing_packet
from rav1e_tpu_torch.ops.ref.mc import mc_predict_avg
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from rav1e_tpu_torch.pipeline import tpu_intra as tintra
from test_torch_inter import _decode_exactly
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)

W, H = 128, 96
CDEF = (0, 0, 0, 0, 3)
# the reference's B call as api/context.py makes it at speed 6
BFRAME = dict(order_hint=1, ref_hints=(0, 2), use_split=True, b64_rdo=True,
              cdef=CDEF)
PFRAME2 = dict(order_hint=2, cdef=CDEF, use_satd=True, golden_hint=0)
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


def noise_frame(seed=1):
    """bgroup()'s middle frame with uniform noise on its luma and binary
    noise (0 / 255) on the left half: at q 255 the re-judge's and the ref
    choice's 32x32 luma SSEs pass 2^24."""
    rng = np.random.default_rng(seed)
    cur = [p.copy() for p in bgroup()[1]]
    cur[0] = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cur[0][:, :W // 2] = np.where(rng.random((H, W // 2)) < 0.5, 0, 255)
    return cur


def tie_frames(k=91, j3=54, seed=4):
    """A B frame whose fwd / bwd choice is a tie inside f32 rounding past
    2^24: the frame's luma is 255, the fwd reference's a flat 100, the bwd
    reference's 100 with k pixels a 32-block at 101 (every MV stays zero
    at q 255), so bwd saves 309 a pixel of SSE against its 4 extra bits;
    under j3 of those pixels the frame holds 253 (4 more of the gap each)
    and under b more of them in block b 254 (2 more each): the blocks
    sweep the gap across the tie in steps of 2. Flat chroma."""
    rng = np.random.default_rng(seed)
    src = np.full((H, W), 255, np.uint8)
    bwd = np.full((H, W), 100, np.uint8)
    for b in range((H // 32) * (W // 32)):
        by, bx = (b // (W // 32)) * 32, (b % (W // 32)) * 32
        pos = rng.permutation(1024)[:k]
        rr, cc = by + pos // 32, bx + pos % 32
        bwd[rr, cc] = 101
        src[rr[:j3], cc[:j3]] = 253
        src[rr[j3:j3 + b], cc[j3:j3 + b]] = 254
    c = np.full((H // 2, W // 2), 128, np.uint8)
    return [src, c, c], [np.full((H, W), 100, np.uint8), c, c], [bwd, c, c]


def _recording(mod):
    """Patch mod._fetch_packed to keep what it returns: (the list it
    fills, a function that restores it)."""
    got, orig = [], mod._fetch_packed

    def recording(*a, **k):
        got.append(orig(*a, **k))
        return got[-1]

    mod._fetch_packed = recording

    def restore():
        mod._fetch_packed = orig
    return got, restore


def _run(mod, fn, *a, **k):
    """fn(*a, **k) -> (its packet, recon, fetched decisions)."""
    got, restore = _recording(mod)
    try:
        pkt, rec = fn(*a, **k)
    finally:
        restore()
    return pkt, [np.asarray(r) for r in rec], [np.asarray(x) for x in got[0]]


def _jax_bstep(cur, ra, rb, qindex):
    """The JAX package's B step (encode_bframe_tpu's _core) on one frame:
    its packed decision buffer."""
    nby, nbx = H // 32, W // 32
    step, _, _ = jinter._core(H, W, True, use_split=True, two_ref=True,
                              b64_rdo=True)
    o = step(jnp.asarray(jinter.pack_src(cur)),
             *(jnp.asarray(p) for p in ra), *(jnp.asarray(p) for p in rb),
             jnp.int32(jinter.dc_q_lut(qindex)),
             jnp.int32(jinter.ac_q_lut(qindex)),
             jnp.asarray(list(CDEF), jnp.int32), jinter.build_rd_inter(qindex),
             jinter._ds16_quads(None, nby, nbx))
    return np.asarray(o[0])


def _reference():
    """The JAX package's B frame of bgroup() (the middle frame on the two
    ends) and on noise_frame() at q 255, and its LAST + GOLDEN P frame
    (the last frame on the middle one and the first): packet, recon,
    fetched decisions, and the B step's packed buffer."""
    f = bgroup()
    out = {"b": _run(jinter, jinter.encode_bframe_tpu, f[1], f[0], f[2],
                     **BFRAME),
           "b_buf": _jax_bstep(f[1], f[0], f[2], 100),
           "noise": _run(jinter, jinter.encode_bframe_tpu, noise_frame(),
                         f[0], f[2], qindex=255, **BFRAME),
           "tie": _run(jinter, jinter.encode_bframe_tpu, *tie_frames(),
                       qindex=255, **BFRAME),
           "p2": _run(jinter, jinter.encode_pframe2_tpu, f[2], f[1], f[0],
                      **PFRAME2)}
    return out


def _want(shared_dir):
    return _once(shared_dir, "bframe_128x96", _reference)


def _same_decisions(got, want):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


# ---- compound MC ------------------------------------------------------------

@pytest.mark.parametrize("n,ss", [(32, 0), (32, 1), (16, 0), (16, 1)])
def test_compound_mc_every_phase(n, ss):
    """_mc_filter(interm=True) twice and _comp_avg equal the reference's
    _mc_batch(interm=True) and _comp_avg at every (row, column) phase
    pair of both MVs, bit for bit; _mc_patch(interm=True) equals the
    window route; each block equals ops/ref/mc.py's mc_predict_avg."""
    rng = np.random.default_rng(n + ss)
    pad = tinter.PAD >> ss
    ph, pw = (96 >> ss), (128 >> ss)
    planes = [np.pad(rng.integers(0, 256, (ph, pw)), pad, mode="edge")
              .astype(np.int32) for _ in range(2)]
    step = 16 >> (1 - ss)              # a phase step in eighth-pel units
    fr, fc = np.meshgrid(np.arange(0, 16, 16 // step),
                         np.arange(0, 16, 16 // step), indexing="ij")
    B = fr.size

    def mvs():
        # eighth-pel luma MVs whose plane-scale phases run over fr x fc
        k = 2 >> ss
        return np.stack([fr.ravel() // k + 16 * rng.integers(-1, 2, B),
                         fc.ravel() // k + 16 * rng.integers(-1, 2, B)],
                        1).astype(np.int32)

    mv0, mv1 = mvs(), np.roll(mvs(), 7, 0)
    pos_r = (rng.integers(0, ph // n, B) * n).astype(np.int32)
    pos_c = (rng.integers(0, pw // n, B) * n).astype(np.int32)
    wins = tinter._mc_windows([(_t(p), _t(pos_r), _t(pos_c), _t(m), n, ss)
                               for p, m in ((planes[0], mv0),
                                            (planes[1], mv1))])
    i0, i1 = (tinter._mc_filter(*w, n, interm=True) for w in wins)
    got = tinter._comp_avg(i0, i1).numpy()

    def jbatch(p, m):
        return jinter._mc_batch(jnp.asarray(p), jnp.asarray(pos_r),
                                jnp.asarray(pos_c), jnp.asarray(m), n, ss,
                                interm=True)

    j0, j1 = jbatch(planes[0], mv0), jbatch(planes[1], mv1)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(got, np.asarray(jinter._comp_avg(j0, j1)))
    # the patch route (a window around the MV, drift folded into the taps)
    patch, ir0, ic0 = tinter._gather_patch(_t(planes[0]), _t(pos_r),
                                           _t(pos_c), _t(mv0), n, ss, 1)
    np.testing.assert_array_equal(
        tinter._mc_patch(patch, ir0, ic0, _t(pos_r), _t(pos_c), _t(mv0), n,
                         ss, 1, interm=True).numpy(), i0.numpy())
    # the spec model, block by block on the unpadded planes
    raw = [p[pad:-pad, pad:-pad] for p in planes]
    for b in range(0, B, 7):
        want = mc_predict_avg(raw[0], raw[1], int(pos_r[b]), int(pos_c[b]),
                              n, n, tuple(mv0[b]), tuple(mv1[b]), ss=ss)
        np.testing.assert_array_equal(got[b], want)
    # intermediate precision is not the clipped prediction
    assert not torch.equal(i0, tinter._mc_filter(*wins[0], n))


# ---- the B frame ---------------------------------------------------------------

def test_bframe_decisions_match_reference(shared_dir):
    """The port's B step with split on bgroup(): the packed decision buffer
    byte for byte and its host unpack; blocks take single-fwd, single-bwd
    and compound, 32-blocks split, none merges (the B core never merges)."""
    f = bgroup()
    nby, nbx = H // 32, W // 32
    cpu = torch.device("cpu")
    step, _, gather = tinter._core(H, W, True, use_split=True, two_ref=True,
                                   b64_rdo=True)
    o = step(_t(tinter.pack_src(f[1])), *(_t(p) for p in f[0]),
             *(_t(p) for p in f[2]), *tinter._q_scalars(100, cpu), CDEF,
             tinter.build_rd_inter(100, device=cpu),
             tinter._ds16_quads(None, nby, nbx, cpu))
    dec = tinter._fetch_packed(o, gather, nby, nbx)
    d = dict(zip(NAMES, dec))
    assert set(np.unique(d["choice"])) == {0, 1, 2}
    assert d["split"].any() and not d["b64_map"].any()
    # a compound block carries its bwd MV; no other block does
    assert not d["mvb8"][d["choice"] != 2].any()
    want = _want(shared_dir)
    np.testing.assert_array_equal(o[0].numpy(), want["b_buf"])
    _same_decisions(dec, want["b"][2])


def test_bframe_packet_identical(shared_dir):
    """encode_bframe_tpu(..., use_split=True, b64_rdo=True, cdef=...) on
    the CPU: packet, recon and fetched decisions equal the JAX package's
    on the same numpy references."""
    f = bgroup()
    pkt, rec, dec = _run(tinter, tinter.encode_bframe_tpu, f[1], f[0], f[2],
                         device="cpu", **BFRAME)
    want = _want(shared_dir)["b"]
    assert pkt == want[0]
    for a, b in zip(rec, want[1]):
        np.testing.assert_array_equal(a, b)
    _same_decisions(dec, want[2])


def test_bframe_b64_rdo_is_no_merge():
    """The B core never merges a 64x64 SB: b64_rdo=True (the reference's
    call, an all-false merge map in the deblock) gives b64_rdo=False's
    packet and recon (the port alone)."""
    f = bgroup()
    kw = {k: v for k, v in BFRAME.items() if k != "b64_rdo"}
    on = tinter.encode_bframe_tpu(f[1], f[0], f[2], b64_rdo=True,
                                  device="cpu", **kw)
    off = tinter.encode_bframe_tpu(f[1], f[0], f[2], b64_rdo=False,
                                   device="cpu", **kw)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)


def test_bframe_sums_past_2_24(shared_dir):
    """On noise_frame() at q 255 the 32x32 luma SSEs of the re-judge and
    of the ref choice pass 2^24, where the f32 order decides: the port's
    (_sse_cols_xla, _sse_cols_b_xla, read from the reference's fused
    loops) gives the reference's choice map and packet; on these blocks
    both sums round (they differ from the exact ones)."""
    f = bgroup()
    cur = noise_frame()
    pkt, _, dec = _run(tinter, tinter.encode_bframe_tpu, cur, f[0], f[2],
                       qindex=255, device="cpu", **BFRAME)
    y = tinter.to_blocks(_t(cur[0]).to(torch.int32), 32)
    pred = tinter.to_blocks(_t(f[0][0]).to(torch.int32), 32)
    exact = ((y - pred).double() ** 2).sum((1, 2))
    assert float(exact.max()) >= 2 ** 24
    for fn in (tinter._sse_cols_xla, tinter._sse_cols_b_xla):
        assert not torch.equal(fn(pred, y).double(), exact)
    want = _want(shared_dir)["noise"]
    np.testing.assert_array_equal(dec[NAMES.index("choice")],
                                  want[2][NAMES.index("choice")])
    assert pkt == want[0]


def test_ref_choice_ties_past_2_24(shared_dir):
    """tie_frames(): with every MV zero, the fwd / bwd choice of each
    block is decided by the f32 rounding of SSEs near 2^24.6: the port's
    choice map equals the reference's, and exact sums would choose
    otherwise on some blocks, so the mirrored orders decide here."""
    cur, fwd, bwd = tie_frames()
    _, _, dec = _run(tinter, tinter.encode_bframe_tpu, cur, fwd, bwd,
                     qindex=255, device="cpu", **BFRAME)
    d = dict(zip(NAMES, dec))
    assert not d["mv8"].any() and not d["mvb8"].any()
    assert set(np.unique(d["choice"])) == {0, 1}
    rd = tinter.build_rd_inter(255, device="cpu")
    y = tinter.to_blocks(_t(cur[0]).to(torch.int32), 32)
    sse = [((tinter.to_blocks(_t(r[0]).to(torch.int32), 32) - y).double()
            ** 2).sum((1, 2)) for r in (fwd, bwd)]
    lam, g = float(rd["lam"]), float(rd["globalmv"])
    exact = (sse[1] + lam * (g + 4.0) < sse[0] + lam * g).numpy()
    assert (exact != (d["choice"] == 1)).any()
    want = _want(shared_dir)["tie"]
    np.testing.assert_array_equal(d["choice"], want[2][NAMES.index("choice")])


# ---- LAST + GOLDEN -------------------------------------------------------------

def test_pframe2_identical(shared_dir):
    """encode_pframe2_tpu (LAST + GOLDEN, SATD descent, CDEF) on the CPU:
    packet, recon and fetched decisions equal the JAX package's; blocks
    take both references."""
    f = bgroup()
    pkt, rec, dec = _run(tinter, tinter.encode_pframe2_tpu, f[2], f[1], f[0],
                         device="cpu", **PFRAME2)
    assert set(np.unique(dec[NAMES.index("choice")])) == {0, 1}
    want = _want(shared_dir)["p2"]
    assert pkt == want[0]
    for a, b in zip(rec, want[1]):
        np.testing.assert_array_equal(a, b)
    _same_decisions(dec, want[2])


# ---- chains on both decoders (the port alone) -----------------------------------

def test_reordered_group_decodes_exactly():
    """The default reordered group of five frames as api/context.py codes
    it (bgroup = 4): KEY, the non-shown anchor P (frame 4), B0 (frame 2,
    non-shown, refreshing slot 3), B1 (frame 1), SEF(3), B1 (frame 3),
    SEF(1); every B with split and b64_rdo, CDEF on. Both decoders return
    the five shown frames in display order, each exactly the port's
    recon."""
    f = bgroup(n=5)
    kpkt, krec = tintra.encode_keyframe_tpu(f[0], 100, speed=6, cdef=CDEF,
                                            device="cpu")
    apkt, arec = tinter.encode_pframe_tpu(
        f[4], [r.astype(np.uint8) for r in krec], order_hint=4,
        refresh_flags=1 << 1, ref_slot=0, show_frame=False, cdef=CDEF,
        use_split=True, use_satd=True, refine16=False, intra_rdo=True,
        b64_rdo=True, use_split8=True, device="cpu")
    kw = dict(use_split=True, b64_rdo=True, cdef=CDEF, device="cpu")
    b0, r0 = tinter.encode_bframe_tpu(f[2], krec, arec, order_hint=2,
                                      slot_fwd=0, slot_bwd=1,
                                      ref_hints=(0, 4), refresh_flags=1 << 3,
                                      show_frame=False, **kw)
    b1, r1 = tinter.encode_bframe_tpu(f[1], krec, r0, order_hint=1,
                                      slot_fwd=0, slot_bwd=3,
                                      ref_hints=(0, 2), **kw)
    b3, r3 = tinter.encode_bframe_tpu(f[3], r0, arec, order_hint=3,
                                      slot_fwd=3, slot_bwd=1,
                                      ref_hints=(2, 4), **kw)
    pkts = [kpkt, apkt, b0, b1, show_existing_packet(3), b3,
            show_existing_packet(1)]
    _decode_exactly(pkts, [krec, r1, r0, r3, arec])


def test_mref_chain_decodes_exactly():
    """KEY -> P (frame 1 on the keyframe) -> LAST + GOLDEN P (frame 2 on
    P's recon and the keyframe's, slots 0 and 1): both decoders decode
    every frame exactly to the port's recon."""
    f = bgroup()
    kpkt, krec = tintra.encode_keyframe_tpu(f[0], 100, speed=7, cdef=CDEF,
                                            device="cpu")
    ppkt, prec = tinter.encode_pframe_tpu(
        f[1], [r.astype(np.uint8) for r in krec], order_hint=1, cdef=CDEF,
        device="cpu")
    m = tinter.encode_pframe2_tpu(f[2], prec, krec, device="cpu",
                                  **PFRAME2)
    _decode_exactly([kpkt, ppkt, m[0]], [krec, prec, m[1]])


# ---- the step's shape on the device path ----------------------------------------

def test_bframe_gathers_in_three_groups():
    """A B frame's gathers run as three groups (one launch each on the
    card): both references' descent patches, their six re-judge windows,
    their four chroma windows; a LAST + GOLDEN frame's the same."""
    f = bgroup()
    sizes = []
    orig = tinter.gather_patches_many

    def counting(items):
        items = list(items)
        sizes.append([it[3] for it in items])
        return orig(items)

    tinter.gather_patches_many = counting
    try:
        tinter.encode_bframe_tpu(f[1], f[0], f[2], device="cpu", **BFRAME)
        b_groups, sizes[:] = list(sizes), []
        tinter.encode_pframe2_tpu(f[2], f[1], f[0], device="cpu", **PFRAME2)
    finally:
        tinter.gather_patches_many = orig
    assert b_groups == [[41, 41], [39] * 6, [23] * 4]
    assert sizes == b_groups


def test_bframe_options_beyond_the_slice_raise():
    """Loop restoration in a multi-tile frame (the reference's Context
    never asks for it) and bit depth 12 (the reference's numpy pipeline)
    raise NotImplementedError naming ROADMAP.md section 3."""
    f = bgroup()
    for kw in ({"tile_grid": (1, 2), "lr": True}, {"bit_depth": 12}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md section 3"):
            tinter.encode_bframe_tpu(f[1], f[0], f[2], device="cpu", **kw)


def test_two_reference_merge_raises():
    """p_frame_body(ryp2=..., b64_rdo=True), which no entry point of the
    reference reaches, raises naming ROADMAP.md section 3."""
    f = bgroup()
    planes = [_t(p).to(torch.int32) for p in f[1]]
    pads = [tinter._edge_pad(p, tinter.PAD >> (i > 0))
            for i, p in enumerate(planes)]
    by, bx = tinter._block_origins(H // 32, W // 32, torch.device("cpu"))
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="section 3"):
        tinter.p_frame_body(*planes, *pads, *tinter._q_scalars(100, cpu),
                            CDEF, tinter.build_rd_inter(100, device=cpu), by,
                            bx, H // 32, W // 32, True, *pads, b64_rdo=True)
