"""The port's speed-8 to 10 P-frame slices against the JAX package's, on the
CPU, with the same numpy-seeded inputs.

MC, the patch gather, the packed decision buffer and whole packets are
held bit-exact. The motion searches are float-ranked (bf16 operands, f32
sums), so they are held as MV fields, which must be identical on the test
content. Frames are at most 192x128, apart from one search-only check at
544x960 (510 blocks, the half-resolution branch). The JAX P step is
compiled once per process (its _core is cached per shape and its q is
traced), so the GOP and the q-30 noise frame share one compile."""

import ctypes
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as nd_shift

from rav1e_tpu.conform import aom, dav1d
from rav1e_tpu.ops.ref import mc as jmc
from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu_torch.ops.ref import mc as tmc
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from rav1e_tpu_torch.pipeline import tpu_intra as tintra

W, H = 192, 128
# the P toolsets of api/speed.py as encode_pframe_tpu options
SPEED10 = dict(use_split=False, refine16=False, search=8, subpel=False)
SPEED8 = dict(use_split=False, refine16=False, search=8, subpel=True)
SPEED7 = dict(use_split=True, refine16=False, search=8, subpel=True)


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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def motion_frames(w=W, h=H, n=3):
    """The translating texture of tests/test_inter_conformance.py."""
    rng = np.random.default_rng(11)
    tex = gaussian_filter(rng.normal(0, 40, (h + 100, w + 100)), 2.5)
    frames = []
    for t in range(n):
        oy, ox = int(30 + 2.5 * t), int(30 - 1.5 * t)
        y = (128 + tex[oy:oy + h, ox:ox + w]).clip(0, 255).astype(np.uint8)
        frames.append([y, np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 135, np.uint8)])
    return frames


def _decode_exactly(pkts, recs):
    d = dav1d.decode_all(pkts)
    a = aom.decode_all(pkts)
    for i, rec in enumerate(recs):
        for j in range(3):
            assert np.array_equal(d[i].planes[j], rec[j]), ("dav1d", i, j)
            assert np.array_equal(a[i][j], rec[j]), ("aom", i, j)


def _jax_core(h, w):
    """The JAX package's speed-10 P step, with the cache key
    encode_gop_tpu uses (so the GOP's compile is reused)."""
    from rav1e_tpu.api.speed import SpeedSettings
    ss = SpeedSettings.from_preset(10)
    return jinter._core(h, w, False, use_split=ss.partition_split_rdo,
                        use_satd=ss.satd_subpel,
                        refine16=ss.mv_refine_16,
                        intra_rdo=ss.intra_in_inter, b64_rdo=ss.b64_merge,
                        search=ss.search_px, subpel=ss.subpel,
                        use_split8=ss.partition_split8)


def _same_tree(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
        else:
            x, y = a[k].numpy(), np.asarray(b[k])
            np.testing.assert_array_equal(x, y, err_msg=f"{path}/{k}")
            assert x.dtype == y.dtype, f"{path}/{k}"


def test_rd_inter_tables_and_filters_match_reference():
    """build_rd_inter(100) key by key (values and dtypes), the
    rd_inter_from_numpy carrier, and the SUBPEL_FILTERS banks."""
    rd_j = jax.tree_util.tree_map(np.asarray, jinter.build_rd_inter(100))
    _same_tree(tinter.build_rd_inter(100, device="cpu"), rd_j)
    _same_tree(tinter.rd_inter_from_numpy(rd_j, "cpu"), rd_j)
    assert jmc.SUBPEL_FILTERS.keys() == tmc.SUBPEL_FILTERS.keys()
    for k, v in jmc.SUBPEL_FILTERS.items():
        np.testing.assert_array_equal(tmc.SUBPEL_FILTERS[k], v, err_msg=k)


def _mc_inputs(seed, ss):
    rng = np.random.default_rng(seed)
    nby, nbx = 3, 4
    n = 32 >> ss
    p = jinter.PAD >> ss
    ref = gaussian_filter(rng.normal(128, 50, (nby * n + 2 * p,
                                                nbx * n + 2 * p)), 1.0)
    ref = ref.clip(0, 255).astype(np.int32)
    by = (np.repeat(np.arange(nby), nbx) * n).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * n).astype(np.int32)
    # eighth-pel MVs: sub-pel phases and drifts up to 20 px
    mv = rng.integers(-160, 161, (nby * nbx, 2)).astype(np.int32)
    return ref, by, bx, mv, n


def _mc(ref, by, bx, mv, n, ss):
    """The port's sub-pel prediction as the P frame runs it: the window
    gather (_mc_windows, one launch) then the filter (_mc_filter)."""
    (patch, fr, fc), = tinter._mc_windows([(ref, by, bx, mv, n, ss)])
    return tinter._mc_filter(patch, fr, fc, n)


@pytest.mark.parametrize("ss", [0, 1])
def test_mc_batch_bit_exact(ss):
    """The reference's _mc_batch (8-tap, all 16 phases) on random MVs,
    luma and chroma, against the port's window gather and filter."""
    ref, by, bx, mv, n = _mc_inputs(5 + ss, ss)
    out_j = jinter._mc_batch(jnp.asarray(ref), jnp.asarray(by),
                             jnp.asarray(bx), jnp.asarray(mv), n, ss)
    out_t = _mc(_t(ref), _t(by), _t(bx), _t(mv), n, ss)
    assert out_t.dtype == torch.int32
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_mc_patch_bit_exact():
    """_mc_patch and _mc_patch_multi from M=2 patches: candidates that
    drift inside and beyond the patch (the drift clamps), bit-exact to
    the JAX functions and, in the patch, to the window gather and filter."""
    ref, by, bx, mv, n = _mc_inputs(9, 0)
    rng = np.random.default_rng(10)
    M = 2
    cands = (mv[None] + rng.integers(-24, 25, (4,) + mv.shape)
             ).astype(np.int32)
    # candidate 1 stays within the patch: |drift| <= 2 px = 16 eighth-pel
    cands[1] = mv + rng.integers(-16, 17, mv.shape)
    pj, rj, cj = jinter._gather_patch(jnp.asarray(ref), jnp.asarray(by),
                                      jnp.asarray(bx), jnp.asarray(mv), n,
                                      0, M)
    pt, rt, ct = tinter._gather_patch(_t(ref), _t(by), _t(bx), _t(mv), n,
                                      0, M)
    one_j = jinter._mc_patch(pj, rj, cj, jnp.asarray(by), jnp.asarray(bx),
                             jnp.asarray(cands[0]), n, 0, M)
    one_t = tinter._mc_patch(pt, rt, ct, _t(by), _t(bx), _t(cands[0]), n,
                             0, M)
    np.testing.assert_array_equal(one_t.numpy(), np.asarray(one_j))
    multi_j = jinter._mc_patch_multi(pj, rj, cj, jnp.asarray(by),
                                     jnp.asarray(bx), jnp.asarray(cands),
                                     n, 0, M)
    multi_t = tinter._mc_patch_multi(pt, rt, ct, _t(by), _t(bx),
                                     _t(cands), n, 0, M)
    np.testing.assert_array_equal(multi_t.numpy(), np.asarray(multi_j))
    # inside the patch the folded filter equals plain MC
    np.testing.assert_array_equal(
        multi_t[1].numpy(),
        _mc(_t(ref), _t(by), _t(bx), _t(cands[1]), n, 0).numpy())


def _search_inputs(w, h, seed, frac=None):
    """A textured reference and a source moved by a smooth field; frac
    (dy, dx) adds a fractional shift, for the subpel descent."""
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(0, 45, (h + 80, w + 80)), 2.0)
    ref = (128 + tex[40:40 + h, 40:40 + w]).clip(0, 255).astype(np.int32)
    moved = tex if frac is None else nd_shift(tex, frac, order=3)
    src = (128 + moved[43:43 + h, 38:38 + w]
           + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.int32)
    ryp = np.pad(ref, jinter.PAD, mode="edge")
    return ryp, src


def _search_both(w, h, seed, subpel=False):
    ryp, src = _search_inputs(w, h, seed,
                              (0.375, -0.625) if subpel else None)
    nby, nbx = h // 32, w // 32
    B = nby * nbx
    by = (np.repeat(np.arange(nby), nbx) * 32).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * 32).astype(np.int32)
    blks = jinter.to_blocks(src, 32)
    rd_j = jinter.build_rd_inter(100)

    @jax.jit
    def search_j(ryp, blks, by, bx, rd):
        mv8, _, _, _, gf = jinter._search_one_ref(
            ryp, blks, by, bx, rd, B, False, 8, subpel)
        return mv8, gf(mv8)

    mv_j, g_j = search_j(ryp, blks, by, bx, rd_j)
    rd_t = tinter.build_rd_inter(100, device="cpu")
    mv_t, _, _, _, gf_t = tinter._search_one_ref(
        _t(ryp), _t(np.asarray(blks)), _t(by), _t(bx), rd_t, B, False, 8,
        subpel)
    return (mv_t.numpy(), np.asarray(mv_j), gf_t(mv_t).numpy(),
            np.asarray(g_j))


def test_search_full_resolution_mv_field_identical():
    """_search_one_ref at 192x128 (24 blocks: the full-resolution
    branch): identical MV fields, and the SSD surface read by grid_fn
    equal at them."""
    mv_t, mv_j, g_t, g_j = _search_both(W, H, 1)
    np.testing.assert_array_equal(mv_t, mv_j)
    assert (mv_t != 0).any()
    np.testing.assert_array_equal(g_t, g_j)


def test_search_half_resolution_mv_field_identical():
    """_search_one_ref at 960x544 (510 blocks: the ds2 branch with its
    full-pel descent step from M=2 patches): identical MV fields."""
    mv_t, mv_j, _, _ = _search_both(960, 544, 2)
    assert mv_t.shape == (510, 2)
    np.testing.assert_array_equal(mv_t, mv_j)
    assert (mv_t % 16 != 0).any()          # the descent moved some MVs


def test_search_full_resolution_subpel_mv_field_identical():
    """The same search with subpel (speed 8): the 4, 2, 2 eighth-pel
    descent from M=1 patches gives identical MV fields, with quarter-pel
    MVs among them."""
    mv_t, mv_j, g_t, g_j = _search_both(W, H, 1, subpel=True)
    np.testing.assert_array_equal(mv_t, mv_j)
    assert (mv_t % 8 != 0).any()
    np.testing.assert_array_equal(g_t, g_j)


def test_search_half_resolution_subpel_mv_field_identical():
    """The ds2 search with subpel: the 8, 4, 2, 2 descent from M=2
    patches gives identical MV fields, with quarter-pel MVs among
    them."""
    mv_t, mv_j, _, _ = _search_both(960, 544, 2, subpel=True)
    np.testing.assert_array_equal(mv_t, mv_j)
    assert (mv_t % 8 != 0).any()


def test_mc_patch_multi_every_phase():
    """_mc_patch_multi at every 1/16-pel phase of both axes: luma
    (ss = 0: the even phases of eighth-pel MVs) and chroma (ss = 1: all
    16), candidates drifting up to M px from the patch centre; bit-exact
    to the JAX function, and to the window gather and filter, so the
    REGULAR bank's
    intermediate rounding matches at every phase."""
    M = 2
    for ss in (0, 1):
        ref, by, bx, mv, n = _mc_inputs(13 + ss, ss)
        B = mv.shape[0]
        step = 2 >> ss                       # 1/16 units per MV unit
        ph = np.arange(16 // step)           # MV units within one pixel
        # candidate c: row phase c, column phase (c * 5) mod 16, plus
        # whole-pixel drifts in [-M, M] (in MV units of 16 / step)
        per_px = 16 // step
        drift = np.random.default_rng(14).integers(-M, M, (len(ph), B, 2))
        cands = np.stack([mv + np.stack(
            [ph[c] + drift[c, :, 0] * per_px,
             ph[(c * 5) % len(ph)] + drift[c, :, 1] * per_px], 1)
            for c in range(len(ph))]).astype(np.int32)
        pj, rj, cj = jinter._gather_patch(jnp.asarray(ref), jnp.asarray(by),
                                          jnp.asarray(bx), jnp.asarray(mv),
                                          n, ss, M)
        pt, rt, ct = tinter._gather_patch(_t(ref), _t(by), _t(bx), _t(mv),
                                          n, ss, M)
        out_j = np.asarray(jinter._mc_patch_multi(
            pj, rj, cj, jnp.asarray(by), jnp.asarray(bx),
            jnp.asarray(cands), n, ss, M))
        out_t = tinter._mc_patch_multi(pt, rt, ct, _t(by), _t(bx),
                                       _t(cands), n, ss, M).numpy()
        np.testing.assert_array_equal(out_t, out_j)
        p16 = (by[None, :, None] << 4) + cands * step
        frac = p16 & 15
        assert len(np.unique(frac[..., 0])) == 16 // step
        assert len(np.unique(frac[..., 1])) == 16 // step
        for c in range(len(ph)):
            np.testing.assert_array_equal(
                out_t[c], _mc(_t(ref), _t(by), _t(bx), _t(cands[c]), n,
                              ss).numpy())


def test_coarse_mv_identical():
    """The 4x-downsampled long-range candidate."""
    ryp, src = _search_inputs(W, H, 3)
    B = (H // 32) * (W // 32)
    mv_j = jax.jit(functools.partial(jinter._coarse_mv, B=B, search=8))(
        jnp.asarray(src), jnp.asarray(ryp))
    mv_t = tinter._coarse_mv(_t(src), _t(ryp), B, 8)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))


def test_median_candidate_mirrors_jnp_median():
    """For an even count jnp.median averages the two middle values,
    while torch.median returns the lower one; the port mirrors jnp,
    then rounds /2 half to even."""
    mv = np.array([[1, 2], [2, -6], [3, 5], [10, 7]], np.int32)
    ref = np.asarray(jnp.round(jnp.median(jnp.asarray(mv), axis=0) / 2)
                     .astype(jnp.int32) * 2)
    out = tinter._median_q(_t(mv)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, [2, 4])
    assert torch.median(_t(mv).float(), dim=0).values.tolist() == [2.0, 2.0]


def test_pack_outputs_bytes_equal_reference():
    """The packed int8 decision buffer byte for byte, with values that
    wrap in the int8 casts (skip8 bit bytes of 255, low bytes above
    127, negative MVs, a split nibble), and the host unpack of it."""
    rng = np.random.default_rng(4)
    nby, nbx = 3, 5
    B = nby * nbx
    nsb = ((nby + 1) // 2, (nbx + 1) // 2)
    sl = (rng.integers(-400, 400, (B, 1536))
          * (rng.random((B, 1536)) < 0.03)).astype(np.int16)
    sl[2, :100] = 3                          # a block past its 64 slots
    o = [rng.integers(-300, 300, (B, 2)).astype(np.int32),
         rng.random(B) < 0.5, sl, None, None, None, None, None, None,
         np.int32(37), np.zeros(nsb, np.int32),
         rng.random(B) < 0.3, rng.integers(-200, 200, (B, 4, 2))
         .astype(np.int32), rng.random((B, 4)) < 0.5,
         rng.integers(0, 4, B).astype(np.int32),
         rng.integers(-129, 129, (B, 2)).astype(np.int32),
         rng.random(nsb) < 0.5, rng.random((B, 4)) < 0.5,
         rng.random((B, 4, 4)) < 0.6]
    o[18][0] = True                          # bit bytes of 255
    buf_j = np.asarray(jinter.pack_outputs([None if x is None else
                                            jnp.asarray(x) for x in o]))
    buf_t = tinter.pack_outputs([None if x is None else
                                 torch.as_tensor(np.asarray(x)) for x in o])
    assert buf_t.dtype == torch.int8
    np.testing.assert_array_equal(buf_t.numpy(), buf_j)
    ref = jinter.unpack_outputs(buf_j, nby, nbx)
    out = tinter.unpack_outputs(buf_t.numpy(), nby, nbx)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_sub_grids_match_reference():
    rng = np.random.default_rng(6)
    nby, nbx = 2, 3
    B = nby * nbx
    s16, sk16, sk8 = (rng.random(s) < 0.5 for s in ((B, 4), (B, 4),
                                                      (B, 4, 4)))
    out_j = jinter._sub_grids(nby, nbx, jnp.asarray(s16),
                              jnp.asarray(sk16), jnp.asarray(sk8))
    out_t = tinter._sub_grids(nby, nbx, _t(s16), _t(sk16), _t(sk8))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gop_packets_identical_and_conformant():
    """encode_gop_tpu(speed=10) on a 3-frame 192x128 moving-texture GOP:
    every packet byte-identical to rav1e_tpu's, every recon identical,
    and the stream decodes on libdav1d and libaom to the port's
    recon."""
    frames = motion_frames()
    pk_j, rc_j = jinter.encode_gop_tpu(frames, qindex=100, speed=10)
    pk_t, rc_t = tinter.encode_gop_tpu(frames, qindex=100, speed=10,
                                       device="cpu")
    assert len(pk_t) == 3
    for i, (a, b) in enumerate(zip(pk_t, pk_j)):
        assert a == b, f"packet {i}"
    recs = [rc_t[0]] + [[r.numpy() for r in rc] for rc in rc_t[1:]]
    for i in range(3):
        for j in range(3):
            np.testing.assert_array_equal(recs[i][j], np.asarray(rc_j[i][j]),
                                          err_msg=f"frame {i} plane {j}")
    _decode_exactly(pk_t, recs)


def test_speed8_cdef_gop_packets_identical_and_conformant():
    """encode_gop_tpu(speed=8, cdef=(0, 0, 0, 0, 3)) on the 3-frame
    192x128 GOP: the 7-mode keyframe and subpel P frames, each with the
    per-SB CDEF search (each P frame referencing the CDEF-filtered
    recon). Every packet byte-identical to rav1e_tpu's, every recon
    identical, and the stream decodes on libdav1d and libaom to the
    port's recon."""
    frames = motion_frames()
    cdef = (0, 0, 0, 0, 3)
    pk_j, rc_j = jinter.encode_gop_tpu(frames, qindex=100, speed=8,
                                       cdef=cdef)
    timings: list = []
    pk_t, rc_t = tinter.encode_gop_tpu(frames, qindex=100, speed=8,
                                       cdef=cdef, device="cpu",
                                       timings=timings)
    for i, (a, b) in enumerate(zip(pk_t, pk_j)):
        assert a == b, f"packet {i}"
    recs = [rc_t[0]] + [[r.numpy() for r in rc] for rc in rc_t[1:]]
    for i in range(3):
        for j in range(3):
            np.testing.assert_array_equal(recs[i][j], np.asarray(rc_j[i][j]),
                                          err_msg=f"frame {i} plane {j}")
    _decode_exactly(pk_t, recs)
    assert "cdef" in timings[0] and "filters" in timings[0]
    assert all("cdef" in t and "filt" in t for t in timings[1:])


def test_noise_pframe_takes_the_overflow_gather():
    """A q-30 noise P frame against a noise keyframe's recon: blocks hold
    more nonzeros than their 64 stream slots, so the host takes the
    overflow gather. Against the JAX package's P step at the same
    settings: identical MV and skip maps and packed buffer; the dense
    levels may differ by the f32 forward transform's rounding (|d| <= 1
    on < 1e-4 of the coefficients: XLA and torch sum its products in
    other orders), and where they agree the packet and the recon are
    identical. KEY + P decode exactly to the port's recon."""
    rng = np.random.default_rng(8)
    planes = [[rng.integers(0, 256, s).astype(np.uint8)
               for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
              for _ in range(2)]
    kf_pkt, kf_rec = tintra.encode_keyframe_tpu(planes[0], 30, speed=10,
                                                device="cpu")
    ref = [r.astype(np.uint8) for r in kf_rec]

    step, (nby, nbx), gather_dense = _jax_core(H, W)
    outs = step(jnp.asarray(jinter.pack_src(planes[1])),
                *(jnp.asarray(r) for r in ref),
                jnp.int32(jinter.dc_q_lut(30)),
                jnp.int32(jinter.ac_q_lut(30)),
                jnp.asarray([0, 0, 0, 0, 3], jnp.int32),
                jinter.build_rd_inter(30),
                jinter._ds16_quads(None, nby, nbx))
    dec_j = jinter._fetch_packed(outs, gather_dense, nby, nbx)
    counts = jinter.unpack_outputs(np.asarray(outs[0]), nby, nbx)[9]
    assert (counts > 64).any()

    tstep, _, tgather = tinter._core(H, W, False, use_split=False,
                                     use_satd=False, refine16=False,
                                     search=8, subpel=False)
    cpu = torch.device("cpu")
    o = tstep(_t(jinter.pack_src(planes[1])), *(_t(r) for r in ref),
              *tinter._q_scalars(30, cpu),
              torch.tensor([0, 0, 0, 0, 3], dtype=torch.int32),
              tinter.build_rd_inter(30, device=cpu),
              tinter._ds16_quads(None, nby, nbx, cpu))
    np.testing.assert_array_equal(o[0].numpy(), np.asarray(outs[0]))
    dec_t = tinter._fetch_packed(o, tgather, nby, nbx)
    for k in (0, 1, 5, 6, 7, 8):             # mv8 skip split mv16 skip16 lf
        np.testing.assert_array_equal(dec_t[k], dec_j[k])
    dlv = [np.abs(a.astype(np.int32) - b) for a, b in zip(dec_t[2:5],
                                                           dec_j[2:5])]
    nd = sum(int((d != 0).sum()) for d in dlv)
    assert max(int(d.max()) for d in dlv) <= 1
    assert nd * 1e4 < sum(d.size for d in dlv)

    pkt_t, rec_t = tinter.encode_pframe_tpu(planes[1], ref, qindex=30,
                                            device="cpu", **SPEED10)
    if nd == 0:
        mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf = dec_j[:9]
        assert pkt_t == jinter._pack_pframe(
            H, W, 30, 1, mv8, skip, lv_y, lv_u, lv_v, lf_level=lf,
            split=split, mv16=mv16, skip16=skip16)
        for a, b in zip(rec_t, outs[4:7]):
            np.testing.assert_array_equal(a, np.asarray(b))
    _decode_exactly([kf_pkt, pkt_t], [kf_rec, rec_t])


@pytest.mark.parametrize("kw", [{"lr": True},
                                {"bit_depth": 10}, {"bit_depth": 12},
                                {"tile_grid": (1, 2)}])
def test_pframe_options_beyond_the_slice_raise(kw):
    """On top of the speed-7 toolset, each option the port does not reach
    yet (loop restoration, bit depths 10 and 12, tiles) raises
    NotImplementedError naming its ROADMAP item; so does each on top of
    the reference's defaults."""
    planes = [np.zeros((64, 64), np.uint8), np.zeros((32, 32), np.uint8),
              np.zeros((32, 32), np.uint8)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tinter.encode_pframe_tpu(planes, planes, device="cpu",
                                 **{**SPEED7, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tinter.encode_pframe_tpu(planes, planes, device="cpu", **kw)


def test_pframe_packer_and_python_writer_agree():
    """encode_pframe_tpu's default C++ packer (use_native=True) and the
    Python TileWriter walk give the same packet and recon on the speed-7
    toolset at 64x64."""
    frames = motion_frames(64, 64, 2)
    pkt_n, rec_n = tinter.encode_pframe_tpu(frames[1], frames[0],
                                            device="cpu", **SPEED7)
    pkt_p, rec_p = tinter.encode_pframe_tpu(frames[1], frames[0],
                                            device="cpu", use_native=False,
                                            **SPEED7)
    assert pkt_n == pkt_p
    for a, b in zip(rec_n, rec_p):
        np.testing.assert_array_equal(a, b)


def test_gop_below_speed_9_raises_and_cuda_is_the_default():
    """Speed 2 (its P frames' 24-px search) raises naming ROADMAP item
    8c before the keyframe; without a device argument the GOP runs on
    cuda, and without CUDA that raises."""
    frames = motion_frames(64, 64, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 8c"):
        tinter.encode_gop_tpu(frames, speed=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinter.encode_gop_tpu(frames, speed=10)
