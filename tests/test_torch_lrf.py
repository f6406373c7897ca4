"""The port's loop restoration (ops/lrf.py, pipeline/lr.py and the LR
routes of the keyframe, P and B pipelines) against the JAX package's, on
the CPU, with the same numpy-made inputs.

- The Wiener and SGR applies of the piece batch are bit-exact against
  ops/tpu/lrf.py's _wiener_apply2 / _sgr_flt_batch and the numpy unit
  filters, for random taps and all 8 SGR sets.
- search_lr_plane equals search_lr_plane_tpu on test_tpu_lrf.py's
  136x168 content, luma and chroma: the grid, `used`, the filtered plane
  and every per-unit candidate SSE, SGR weight and least-squares tap.
- On content whose SSEs and SGR sums pass 2^24 the per-unit f32 sums
  take XLA:CPU's order: a plain torch.sum moves a decision there, the
  mirrored order keeps the reference's.
- KEY (encode_keyframe_tpu(lr=True)) + P + B with lr=True at 128x96 give
  the JAX package's packets and decode exactly on libdav1d and libaom; a
  10-bit P frame with lr decodes on libdav1d to the port's recon.
- encode_pframe_tpu(b64_rdo=True, use_split=False) (the 64x64 merge on
  the 32-level costs) equals the reference at 64x64, and the 24-px
  search of speeds 0-2 (its half-resolution stage at 510 blocks) gives
  the reference's MVs.
The JAX references are made once per test run and shared between the
runner's workers through the locked file of test_torch_keyframe.py."""

import ctypes
import gc
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rav1e_tpu.ops.ref.lrf import (SGR_PARAMS_S, WIENER_TAPS_MAX,
                                   WIENER_TAPS_MIN, sgr_filter_unit,
                                   sgr_weights, wiener_filter_unit)
from rav1e_tpu.ops.tpu import lrf as jlrf
from rav1e_tpu_torch.ops import lrf as tlrf
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)

PH, PW = 136, 168          # irregular: the last units merge
Q = 150


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread and hand the worker's freed heap back to
    the system around the module (glibc's malloc_trim)."""
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


def _plane(h, w, seed=0, amp=60, sigma=1.2):
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.normal(0, amp, (h, w)), sigma)
    return (128 + base).clip(0, 255).astype(np.int32)


def _rec_src(h, w, seed, noise=6.0):
    """test_tpu_lrf.py's content: a smooth source and its recon with
    Gaussian noise."""
    rng = np.random.default_rng(seed)
    src = _plane(h, w, seed + 1).astype(np.int64)
    rec = (src + rng.normal(0, noise, src.shape)).clip(0, 255)
    return rec.astype(np.int32), src


def test_wiener_and_sgr_apply_bit_exact():
    """The piece-batch Wiener apply with random per-piece taps, and both
    SGR passes of every set, equal the JAX functions on the same patches;
    combined with the set's weights they equal the numpy unit filters on
    every single-piece unit."""
    rng = np.random.default_rng(1)
    rec = _plane(PH, PW, 2)
    g, rows3, cols3, _, _, meta, _ = tlrf._gather_maps(PH, PW, 0, 3)
    _, rows4, cols4, _, _, _, _ = tlrf._gather_maps(PH, PW, 0, 4)
    P, H, W = rows3.shape[0], g["max_h"], g["max_w"]
    taps = [np.stack([rng.integers(WIENER_TAPS_MIN[i], WIENER_TAPS_MAX[i]
                                   + 1, P) for i in range(3)],
                     1).astype(np.int32) for _ in range(2)]
    p3 = tlrf._gather_patches(torch.from_numpy(rec), torch.from_numpy(rows3),
                              torch.from_numpy(cols3))
    p4 = tlrf._gather_patches(torch.from_numpy(rec), torch.from_numpy(rows4),
                              torch.from_numpy(cols4))
    assert np.array_equal(p3.numpy(), np.asarray(jlrf._gather_patches(
        jnp.asarray(rec), jnp.asarray(rows3), jnp.asarray(cols3))))
    out = tlrf._wiener_apply2(p3, torch.from_numpy(taps[0]),
                              torch.from_numpy(taps[1]), 8).numpy()
    ref = np.asarray(jlrf._wiener_apply2(jnp.asarray(p3.numpy()),
                                         jnp.asarray(taps[0]),
                                         jnp.asarray(taps[1]), 8))
    assert np.array_equal(out, ref)
    for k, (ur, uc, y0, h, x0, w) in enumerate(meta):
        assert np.array_equal(out[k, :h, :w], wiener_filter_unit(
            rec, y0, x0, h, w, tuple(taps[0][k]), tuple(taps[1][k]), bd=8))
    row_par = np.zeros((P, H), np.int32)
    for k, (_, _, _, h, _, _) in enumerate(meta):
        row_par[k, :h] = np.arange(h) & 1
    tgt = p3[:, 3: 3 + H, 3: 3 + W]
    u = tgt.numpy().astype(np.int64) << 4
    for sset in tlrf.SGR_SETS:
        s0, s1 = SGR_PARAMS_S[sset]
        flt = []
        for r, s, sl in ((2, s0, slice(1, -1)), (1, s1, slice(2, -2))):
            if not s:
                flt.append(u)
                continue
            got = tlrf._sgr_flt_batch(p4[:, sl, sl], tgt, r, s, 8,
                                      torch.from_numpy(row_par)).numpy()
            want = np.asarray(jlrf._sgr_flt_batch(
                jnp.asarray(p4[:, sl, sl].numpy()), jnp.asarray(tgt.numpy()),
                r, s, 8, jnp.asarray(row_par)))
            assert np.array_equal(got, want), (sset, r)
            flt.append(got)
        x0q = int(rng.integers(-32, 32)) if s0 else 0
        x1q = int(rng.integers(-16, 64))
        w0, w1, w2 = sgr_weights(sset, x0q, x1q)
        dev = np.clip((w1 * u + w0 * flt[0] + w2 * flt[1] + (1 << 10)) >> 11,
                      0, 255)
        for k, (ur, uc, y0, h, x0, w) in enumerate(meta):
            y0u, y1u = g["ubands"][ur]
            if (y0, h) == (y0u, y1u - y0u):
                assert np.array_equal(dev[k, :h, :w], sgr_filter_unit(
                    rec, y0, x0, h, w, sset, x0q, x1q, bd=8)), (sset, k)


def _unit_results(rec, src, ss, chroma):
    """The reference's jitted step on (rec, src): per-unit SSEs, SGR
    weights and least-squares taps, in the port's summary layout."""
    step, _, _, _ = jlrf._search_fn(rec.shape[0], rec.shape[1], ss, 8,
                                    chroma)
    o = jax.device_get(step(jnp.asarray(rec),
                            jnp.asarray(src.astype(np.int32))))
    return np.concatenate([
        np.asarray(o["base_sse"])[None], np.asarray(o["wiener_sse"]),
        np.asarray(o["sgr_sse"])]).ravel(), np.concatenate([
            np.asarray(o["sgr_xqd"]).transpose(0, 2, 1).ravel(),
            np.asarray(o["wiener_vsol"]).ravel(),
            np.asarray(o["wiener_hsol"]).ravel()]).astype(np.float32)


def _port_units(rec, src, ss):
    summ, _, _, tb = tlrf._search_dev(torch.from_numpy(rec),
                                      torch.from_numpy(src.astype(np.int32)),
                                      8, ss, chroma=ss > 0)
    s = summ.numpy()
    n = 13 * tb.n_units
    return s[:n], s[n:]


@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_search_lr_plane_equals_reference(plane, shared_dir):
    """search_lr_plane on test_tpu_lrf.py's content (luma 136x168;
    chroma its 68x84 plane, ss = 1) equals search_lr_plane_tpu: the grid,
    `used`, the filtered plane, and every unit's candidate SSEs, SGR
    weights and least-squares taps."""
    ss = 0 if plane == "luma" else 1
    rec, src = _rec_src(PH >> ss, PW >> ss, 5 + ss)

    def reference():
        grid, filtered, used = jlrf.search_lr_plane_tpu(rec, src, bd=8,
                                                        ss=ss)
        return grid, np.asarray(filtered), used, _unit_results(
            rec, src, ss, ss > 0)

    grid_j, filt_j, used_j, (sse_j, dec_j) = _once(
        shared_dir, f"lrf_search_{plane}", reference)
    grid, filt, used = tlrf.search_lr_plane(torch.from_numpy(rec),
                                            torch.from_numpy(src), bd=8,
                                            ss=ss, chroma=ss > 0)
    assert used and used_j
    assert grid == grid_j
    assert np.array_equal(filt.numpy(), filt_j)
    sse, dec = _port_units(rec, src, ss)
    assert np.array_equal(sse, sse_j)
    assert np.array_equal(dec, dec_j)
    assert sse.max() < 2 ** 24 < np.abs(
        _sgr_sums(rec, src, ss)).max()


def test_10bit_search_applies_the_unit_filters():
    """search_lr_plane at bd 10 on bright 10-bit content (flat blocks
    beside a smooth plane; a patch's squares pass 2^31), luma and chroma,
    with a plane before CDEF that differs from the recon (the rows
    beyond each stripe read it): every unit that chose a filter holds
    exactly ops/ref/lrf.py's wiener_filter_unit / sgr_filter_unit output
    at bd 10 with that plane (the spec filters libdav1d decodes), the
    others the recon; Wiener and SGR units both occur, and the filtered
    plane's SSE is below the recon's."""
    from rav1e_tpu_torch.ops.ref import lrf as rlrf
    kinds = set()
    for ss in (0, 1):
        h, w = PH >> ss, PW >> ss
        rng = np.random.default_rng(ss)
        # flat 8x8 blocks (where SGR wins) left, a smooth plane right
        src = _plane(h, w, 6 + ss) << 2
        src[:, : w // 2] = np.kron(rng.integers(200, 800, (h // 8 + 1, 11)),
                                   np.ones((8, 8), np.int64))[:h, : w // 2]
        src = (src + 200).clip(0, 1023)
        rec = (src + rng.normal(0, 24, src.shape)).clip(0, 1023).astype(
            np.int32)
        pre = (rec + rng.integers(-9, 10, rec.shape)).clip(0, 1023).astype(
            np.int32)
        assert (rec[:70, :70].astype(np.int64) ** 2).sum() > 2 ** 31
        grid, filt, used = tlrf.search_lr_plane(
            torch.from_numpy(rec), torch.from_numpy(src), bd=10, ss=ss,
            pre=torch.from_numpy(pre), chroma=ss > 0)
        filt = filt.numpy()
        assert used and filt.max() <= 1023
        off, sh = 8 >> ss, 64 >> ss
        geo = tlrf._piece_geometry(*rec.shape, ss)
        for ur, (y0, y1) in enumerate(geo["ubands"]):
            for uc, (x0, x1) in enumerate(geo["cbands"]):
                cell = grid[ur][uc]
                h, w = y1 - y0, x1 - x0
                if cell is None:
                    want = rec[y0:y1, x0:x1]
                elif cell[0] == "W":
                    want = rlrf.wiener_filter_unit(
                        rec, y0, x0, h, w, cell[1], cell[2], bd=10,
                        stripe_h0=sh - off, stripe_h=sh, pre=pre)
                else:
                    want = rlrf.sgr_filter_unit(
                        rec, y0, x0, h, w, *cell[1:], bd=10,
                        stripe_h0=sh - off, stripe_h=sh, pre=pre)
                kinds.add(cell and cell[0])
                assert np.array_equal(filt[y0:y1, x0:x1], want), (ss, ur, uc)
        sse = lambda a: int(((a.astype(np.int64) - src) ** 2).sum())  # noqa
        assert sse(filt) < sse(rec)
    assert {"W", "S"} <= kinds


def _sgr_sums(rec, src, ss):
    """The port's SGR least-squares sums (aa, ab, bb, at, bt of every
    set, per unit), taken from _search_dev's batched sum."""
    got = []
    orig = tlrf._unit_sum

    def keep(tb, v):
        out = orig(tb, v)
        got.append(out)
        return out

    tlrf._unit_sum = keep
    try:
        tlrf._search_dev(torch.from_numpy(rec),
                         torch.from_numpy(src.astype(np.int32)), 8, ss,
                         chroma=ss > 0)
    finally:
        tlrf._unit_sum = orig
    return got[1].numpy()


def _tie_content(seed=3, n=160, amp=6):
    """A flat recon of 200 over a flat source of 0 (each unit's SSE past
    2^27) with n random bumps of +-amp: the SGR sets' outputs differ only
    near the bumps, so several candidates' SSEs lie within f32 rounding of
    each other, and the SGR sums of the bumps' terms (times (0 - 200) <<
    11) pass 2^24."""
    rng = np.random.default_rng(seed)
    src = np.zeros((PH, PW), np.int64)
    rec = np.full((PH, PW), 200, np.int32)
    ys, xs = rng.integers(0, PH, n), rng.integers(0, PW, n)
    rec[ys, xs] += rng.integers(-amp, amp + 1, n).astype(np.int32)
    return rec, src


def test_sums_past_2_24_take_the_reference_order(shared_dir):
    """On _tie_content the per-unit SSEs and the SGR sums pass 2^24 and
    SGR candidates of one unit are within f32 rounding of each other: the
    port's mirrored order gives the reference's grid, SSEs and weights,
    and the same search with a plain torch.sum over each piece picks
    another set."""
    rec, src = _tie_content()

    def reference():
        grid, filtered, used = jlrf.search_lr_plane_tpu(rec, src, bd=8)
        return grid, np.asarray(filtered), _unit_results(rec, src, 0, False)

    grid_j, filt_j, (sse_j, dec_j) = _once(shared_dir, "lrf_search_tie",
                                           reference)
    sse, dec = _port_units(rec, src, 0)
    assert sse.min() > 2 ** 24
    assert np.abs(_sgr_sums(rec, src, 0)).max() > 2 ** 24
    assert np.array_equal(sse, sse_j) and np.array_equal(dec, dec_j)
    grid, filt, _ = tlrf.search_lr_plane(torch.from_numpy(rec),
                                         torch.from_numpy(src), chroma=False)
    assert grid == grid_j and np.array_equal(filt.numpy(), filt_j)
    orig = tlrf._xla_sum_hw
    tlrf._xla_sum_hw = lambda x: x.sum((-2, -1))
    try:
        grid_p, _, _ = tlrf.search_lr_plane(torch.from_numpy(rec),
                                            torch.from_numpy(src),
                                            chroma=False)
        sse_p, _ = _port_units(rec, src, 0)
    finally:
        tlrf._xla_sum_hw = orig
    assert not np.array_equal(sse_p, sse_j)
    assert grid_p != grid_j


def test_small_solves_round_as_lapack():
    """The Wiener normal equations' 2x2 / 3x3 solves (_solve_small) equal
    jnp.linalg.solve bit for bit on 4,000 random SPD systems of each size
    (condition numbers up to ~1e4), and _fma32 rounds once."""
    rng = np.random.default_rng(0)
    for n in (2, 3):
        X = (rng.normal(0, 1, (4000, 50, n)) * rng.uniform(
            0.1, 10, (4000, 1, n))).astype(np.float32)
        X[:, :, 1:] += X[:, :, :1] * rng.uniform(-0.9, 0.9, (4000, 1, 1)
                                                 ).astype(np.float32)
        G = (np.einsum("bki,bkj->bij", X, X).astype(np.float32)
             + np.float32(1e-4) * np.eye(n, dtype=np.float32))
        r = rng.normal(0, 50, (4000, n)).astype(np.float32)
        want = np.asarray(jax.jit(lambda a, b: jnp.linalg.solve(
            a, b[..., None])[..., 0])(G, r))
        got = tlrf._solve_small(torch.from_numpy(G), torch.from_numpy(r))
        assert np.array_equal(got.numpy(), want), n
    a = torch.tensor([1 + 2 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    fused = 2.0 ** -11 + 2.0 ** -24
    assert tlrf._fma32(a, a, c).item() == fused != (a * a + c).item()


def _lr_frames(t):
    """test_tpu_lrf.py's moving content at 128x96, frame t."""
    rng = np.random.default_rng(7)
    base = gaussian_filter(rng.normal(0, 55, (96 + 16, 128 + 16)), 1.0)
    y = (128 + base[t: t + 96, 2 * t: 2 * t + 128]).clip(0, 255)
    return [y.astype(np.uint8), np.full((48, 64), 120, np.uint8),
            np.full((48, 64), 133, np.uint8)]


# KEY (slot all), P two frames on (slot 1, refs the KEY), then the B frame
# between them (fwd the KEY in slot 0, bwd the P in slot 1)
P_ARGS = dict(qindex=Q, order_hint=2, refresh_flags=0x02, ref_slot=0,
              lr=True)
B_ARGS = dict(qindex=Q, order_hint=1, ref_hints=(0, 2), slot_fwd=0,
              slot_bwd=1, lr=True)


def _kpb(mod_intra, mod_inter, kf_kw=None, **kw):
    """KEY + P + B with lr=True through one package's pipelines: the three
    packets and recons. kf_kw: the keyframe's own keywords (else kw)."""
    pk, rk = mod_intra.encode_keyframe_tpu(_lr_frames(0), qindex=Q,
                                           speed=6, lr=True,
                                           **(kf_kw or kw))
    pp, rp = mod_inter.encode_pframe_tpu(_lr_frames(2), rk, **P_ARGS, **kw)
    pb, rb = mod_inter.encode_bframe_tpu(_lr_frames(1), rk, rp, **B_ARGS,
                                         **kw)
    return [pk, pp, pb], [[np.asarray(p) for p in r] for r in (rk, rp, rb)]


@contextmanager
def _lr_frames_coded():
    """The (lr_types, lr_data) of every search_lr_frame call inside, in
    call order."""
    from rav1e_tpu_torch.pipeline import lr as plr
    calls, orig = [], plr.search_lr_frame
    plr.search_lr_frame = lambda *a, **k: calls.append(orig(*a, **k)) or \
        calls[-1]
    try:
        yield calls
    finally:
        plr.search_lr_frame = orig


def _filtered_units(call):
    """The frame's restoration types and its count of filtered units."""
    types, lr_data = call
    units = (lr_data or {}).get("units", {})
    return types, sum(c is not None for g in units.values() for row in g
                      for c in row)


def test_key_p_b_with_lr_equal_reference_and_decode(shared_dir):
    """encode_keyframe_tpu(lr=True), encode_pframe_tpu(lr=True) and
    encode_bframe_tpu(lr=True) give the JAX package's packets and recons
    (every frame restores some unit), and libdav1d and libaom decode the
    three exactly; with CDEF on too, they decode the port's three
    exactly."""
    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu.pipeline import tpu_intra as jintra
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter
    from rav1e_tpu_torch.pipeline import tpu_intra as tintra
    from test_torch_inter import _decode_exactly

    pkts_j, recs_j = _once(shared_dir, "lrf_kpb_128x96",
                           lambda: _kpb(jintra, jinter))
    timings = {}
    with _lr_frames_coded() as calls:
        pkts, recs = _kpb(tintra, tinter, device="cpu")
    assert pkts == pkts_j
    for r, rj in zip(recs, recs_j):
        for a, b in zip(r, rj):
            assert np.array_equal(a, b)
    _decode_exactly(pkts, recs)
    # every frame signals restoration and filters some unit
    assert len(calls) == 3
    for call in calls:
        types, n = _filtered_units(call)
        assert any(types) and n > 0, (types, n)
    tinter.encode_pframe_tpu(_lr_frames(2), recs[0], **P_ARGS,
                             device="cpu", timings=timings)
    assert timings["lr"] > 0 and "tile_walk" in timings
    # with CDEF (the keyframe's at fixed strengths, which change the rows
    # beyond the stripes) the filters read the deblocked planes before
    # CDEF there, as decoders do (the reference reads the CDEF output)
    with _lr_frames_coded() as calls:
        pkts, recs = _kpb(tintra, tinter, device="cpu", cdef=(0, 0, 0, 0, 5),
                          kf_kw=dict(device="cpu", cdef=(6, 2, 4, 1, 5),
                                     cdef_rdo=False))
    _decode_exactly(pkts, recs)
    assert [_filtered_units(c)[1] > 0 for c in calls] == [True] * 3


def test_10bit_pframe_with_lr_decodes_exactly():
    """A 10-bit P frame with lr=True (its search on the device route at
    10 bits, where the reference's device step would search at 8)
    decodes on libdav1d to exactly the port's recon, after the numpy
    keyframe at 10 bits with lr; both frames filter some unit."""
    from rav1e_tpu_torch.conform import dav1d
    from rav1e_tpu_torch.pipeline.intra import encode_keyframe
    from rav1e_tpu_torch.pipeline.tpu_inter import encode_pframe_tpu

    f0, f1 = (_lr_frames(t) for t in (0, 2))
    to10 = lambda f: [(p.astype(np.uint16) << 2) | 1 for p in f]  # noqa
    with _lr_frames_coded() as calls:
        pk, rk = encode_keyframe(to10(f0), qindex=Q, bit_depth=10, lr=True,
                                 device="cpu")
        pp, rp = encode_pframe_tpu(to10(f1), rk, qindex=Q, order_hint=1,
                                   lr=True, bit_depth=10, device="cpu")
    assert [_filtered_units(c)[1] > 0 for c in calls] == [True, True]
    d = dav1d.decode_all([pk, pp])
    for i, rec in enumerate((rk, rp)):
        for j in range(3):
            assert np.array_equal(d[i].planes[j], np.asarray(rec[j])), (i, j)


def _b64_frames():
    """A 64x64 pair whose P frame merges its SB at q 100: a smooth plane
    shifted by one pixel."""
    rng = np.random.default_rng(11)
    base = gaussian_filter(rng.normal(0, 30, (72, 72)), 3.0)
    y0 = (128 + base[:64, :64]).clip(0, 255).astype(np.uint8)
    y1 = (128 + base[1:65, 1:65]).clip(0, 255).astype(np.uint8)
    c = np.full((32, 32), 128, np.uint8)
    return [y0, c, c], [y1, c, c]


def test_b64_merge_without_split_equals_reference(shared_dir):
    """encode_pframe_tpu(b64_rdo=True, use_split=False): the 64x64 merge
    on the 32-level costs, as the reference's p_frame_body, gives its
    packet and recon at 64x64."""
    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter

    ref, cur = _b64_frames()
    kw = dict(qindex=100, use_split=False, b64_rdo=True)

    def reference():
        pkt, rec = jinter.encode_pframe_tpu(cur, ref, **kw)
        return pkt, [np.asarray(r) for r in rec]

    pkt_j, rec_j = _once(shared_dir, "lrf_b64_nosplit_64x64", reference)
    got, orig = [], tinter._fetch_packed
    tinter._fetch_packed = lambda *a, **k: got.append(orig(*a, **k)) or got[-1]
    try:
        pkt, rec = tinter.encode_pframe_tpu(cur, ref, device="cpu", **kw)
    finally:
        tinter._fetch_packed = orig
    assert np.asarray(got[0][12]).all()          # the SB merged
    assert pkt == pkt_j
    for a, b in zip(rec, rec_j):
        assert np.array_equal(a, b)


def test_search24_half_resolution_equals_reference():
    """The 24-px full-pel search of speeds 0-2 on a 960x544 frame (510
    blocks: the half-resolution stage, +-12 px on the 16x16 means, then
    the full-resolution step and the SATD descent) gives the reference's
    MVs on every block, the reference picture moved by (5, -7) px."""
    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter

    h, w = 544, 960
    rng = np.random.default_rng(17)
    ref = (128 + gaussian_filter(rng.normal(0, 50, (h, w)), 2.0)).clip(
        0, 255).astype(np.int32)
    cur = np.roll(ref, (-5, 7), (0, 1))
    ryp = np.pad(ref, tinter.PAD, mode="edge")
    nby, nbx = h // 32, w // 32
    B = nby * nbx
    blks = cur.reshape(nby, 32, nbx, 32).transpose(0, 2, 1, 3).reshape(
        B, 32, 32)
    by = (np.repeat(np.arange(nby), nbx) * 32).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * 32).astype(np.int32)
    rd_j = jinter.build_rd_inter(100)
    want = np.asarray(jax.jit(lambda r, b, y, x: jinter._search_one_ref(
        r, b, y, x, rd_j, B, True, 24, True)[0])(
        jnp.asarray(ryp), jnp.asarray(blks), jnp.asarray(by),
        jnp.asarray(bx)))
    got = tinter._search_one_ref(
        torch.from_numpy(ryp), torch.from_numpy(blks), torch.from_numpy(by),
        torch.from_numpy(bx), tinter.build_rd_inter(100, device="cpu"), B,
        True, 24, True)[0].numpy()
    assert np.array_equal(got, want)
    assert (np.abs(want) > 16 * 8).any()          # past the 16-px range


def test_12bit_host_search_and_session_decode():
    """12-bit loop restoration, which the port searches on the host as the
    reference does (ops/ref/lrf.py, routed by pipeline/lr.py):
    solve_wiener equals the reference's on 12-bit planes (luma and
    chroma units); sgr_pass_outputs equals the reference's at 8 bits,
    and at 12 bits once the reference's pass composition is given the
    port's box-sum step (_sgr_ab: A equal, B the unscaled sum's, the
    port's repair, which changes B at 12 bits); then a 12-bit speed-2
    session at 128x96 (the numpy pipelines, LR on every frame) restores
    some unit and decodes on libdav1d and libaom to the port's recons."""
    import chip_smoke
    from rav1e_tpu.ops.ref import lrf as jref
    from rav1e_tpu_torch.api import Config
    from rav1e_tpu_torch.api.context import Context
    from rav1e_tpu_torch.conform import aom, dav1d
    from rav1e_tpu_torch.ops.ref import lrf as tref

    rng = np.random.default_rng(12)
    src = (16 * (128 + gaussian_filter(rng.normal(0, 55, (PH, PW)), 1.0))
           ).clip(0, 4095).astype(np.int64)
    rec = np.clip(src + rng.normal(0, 40, src.shape), 0, 4095).astype(
        np.int32)
    for y0, x0, h, w, chroma in ((0, 0, 56, 64, False), (56, 64, 80, 104,
                                                          False),
                                 (0, 64, 56, 64, True)):
        assert tref.solve_wiener(rec, src, y0, x0, h, w, chroma=chroma) == \
            jref.solve_wiener(rec, src, y0, x0, h, w, chroma=chroma)
    rec8 = rec >> 4
    for sset in range(16):
        for a, b in zip(tref.sgr_pass_outputs(rec8, 40, 64, 96, 104, sset),
                        jref.sgr_pass_outputs(rec8, 40, 64, 96, 104, sset)):
            np.testing.assert_array_equal(a, b)
    At, Bt = tref._sgr_ab(rec, None, 56, 64, 0, 64, 1, 925, 12, 56, 119)
    Aj, Bj = jref._sgr_ab(rec, 56, 64, 0, 64, 1, 925, 12, 54, 121)
    np.testing.assert_array_equal(At, Aj)
    assert not np.array_equal(Bt, Bj)

    def port_ab(src, y_lo, hs, x0, w, r, s, bd, row_lo, row_hi):
        # the reference's clamp rows [row_lo, row_hi] are the stripe +-2
        return tref._sgr_ab(src, None, y_lo, hs, x0, w, r, s, bd,
                            row_lo + 2, row_hi - 2)

    orig = jref._sgr_ab
    jref._sgr_ab = port_ab
    try:
        for sset in (0, 3, 10, 14):
            for a, b in zip(
                    tref.sgr_pass_outputs(rec, 40, 64, 96, 104, sset, bd=12),
                    jref.sgr_pass_outputs(rec, 40, 64, 96, 104, sset,
                                          bd=12)):
                np.testing.assert_array_equal(a, b)
    finally:
        jref._sgr_ab = orig

    frames = [chip_smoke._to_sampling(_lr_frames(t), "420", 12)
              for t in range(3)]
    recs, mk = [], Context._mk_stats

    def keeping(self, src, rec, data, q):
        recs.append([np.asarray(p) for p in rec])
        return mk(self, src, rec, data, q)

    Context._mk_stats = keeping
    try:
        with _lr_frames_coded() as calls:
            ctx = Config(width=128, height=96, bit_depth=12, speed=2,
                         quantizer=Q, extra={"enc_stats": "1"}
                         ).new_context(device="cpu")
            for f in frames:
                ctx.send_frame(f)
            ctx.flush()
            pkts = []
            while True:
                _, p = ctx.receive_packet()
                if p is None:
                    break
                pkts.append(p)
    finally:
        Context._mk_stats = mk
    assert sum(_filtered_units(c)[1] for c in calls) > 0
    coded = [p for p in pkts if p.enc_stats is not None]
    assert len(coded) == len(recs) == 3
    by_frame = {p.input_frameno: r for p, r in zip(coded, recs)}
    data = [p.data for p in pkts]
    for dec in ([f.planes for f in dav1d.decode_all(data)],
                aom.decode_all(data)):
        assert len(dec) == 3
        for i, planes in enumerate(dec):
            for got, want in zip(planes, by_frame[i]):
                np.testing.assert_array_equal(
                    np.asarray(got), want[:got.shape[0], :got.shape[1]])
