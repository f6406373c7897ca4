"""10-bit 4:2:0 in the port against the JAX package, on the CPU, with
tests/test_hbd_inter.py's content and calls (`_frames10` at 96x64, its
q, cdef and speed-6 flags), so the JAX calls are that file's programs
and the persistent compile cache serves them; the JAX results are made
once per test run and shared between the runner's workers through a
locked file (test_torch_keyframe._once).

Held bit for bit: the copied numpy keyframe (pipeline/intra.py) at 10
bits and at 8 bits 4:2:0; encode_pframe_tpu(bit_depth=10) with and
without the in-loop filters and one encode_bframe_tpu(bit_depth=10)
frame, packets and recons, each decoded by libdav1d to its recon; the
10-bit Context at test_context_10bit_gop's settings (packets, types,
qps) and the CLI on the same frames as a p10 y4m; and the sums
that pass 2^24 at 10 bits (the CDEF table, SATD's bound, the bf16 SSD
correlation). No test here compiles a JAX P step beyond
test_hbd_inter.py's. The CDEF kernels at 10 bits are held to their
plain versions on the card by tests/test_torch_cdef_cuda.py."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hbd_inter import _frames10
from test_torch_keyframe import _once, shared_dir, synth  # noqa: F401
from test_torch_speed6 import _reference_tables, noise_at_q255
from rav1e_tpu_torch.conform import dav1d
from rav1e_tpu_torch.ops import cdef as tc
from rav1e_tpu_torch.pipeline import tpu_inter as tinter

Q_P, Q_NF = 120, 150                 # test_hbd_inter's P and no-filter q
CDEF_P = (2, 1, 1, 0, 4)
S6 = dict(use_satd=True, intra_rdo=True, b64_rdo=True, use_split8=True)
BFRAME = dict(use_split=True, b64_rdo=True)     # the Context's B call


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
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _host(rec):
    return [np.asarray(r).astype(np.int32) for r in rec]


def _decodes_to(pkts, recs):
    """libdav1d decodes the packets to the shown frames' recons."""
    frames = dav1d.decode_all(pkts)
    assert len(frames) == len(recs)
    for fr, rec in zip(frames, recs):
        for j in range(3):
            np.testing.assert_array_equal(
                np.asarray(fr.planes[j], np.int32), rec[j])


# ---- the numpy keyframe -----------------------------------------------------

def test_numpy_keyframe_copy_identical():
    """pipeline/intra.py's encode_keyframe, copied from the JAX package's
    with its imports renamed, gives its packet and recon byte for byte:
    at 10 bits (test_hbd_inter.py's two keyframes, with and without
    CDEF) and at 8 bits 4:2:0 (synth(64, 64), q 100 and q 30, and with
    lr=True, the loop-restoration search on the port's device route,
    here the CPU)."""
    from rav1e_tpu.pipeline.intra import encode_keyframe as jkf
    from rav1e_tpu_torch.pipeline.intra import encode_keyframe as tkf
    cases = [(_frames10(1)[0], dict(qindex=Q_P, bit_depth=10, cdef=CDEF_P)),
             (_frames10(1, seed=5)[0], dict(qindex=Q_NF, bit_depth=10)),
             (synth(64, 64), dict(qindex=100, cdef=CDEF_P)),
             (synth(64, 64), dict(qindex=30))]
    for planes, kw in cases:
        pj, rj = jkf(planes, **kw)
        pt, rt = tkf(planes, **kw)
        assert pt == pj, kw
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a, b)
    assert max(int(r.max()) for r in rt) <= 255
    pj, rj = jkf(synth(64, 64), qindex=100, lr=True)
    pt, rt = tkf(synth(64, 64), qindex=100, lr=True, device="cpu")
    assert pt == pj
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)


# ---- the P and B steps at 10 bits -------------------------------------------

def _pb_calls(mod, encode_keyframe, device=None):
    """test_hbd_inter.py's two P frames (with the speed-6 tools, CDEF and
    deblock; without filters), then the reordered group's pair: an
    anchor P of frame 2 (non-shown, refreshing slot 1) and a B frame of
    frame 1 between the keyframe and it, through `mod`'s entry points on
    `encode_keyframe`'s keyframes. Returns {name: (packet, recon)} with
    the keyframes'."""
    dev = {} if device is None else dict(device=device)
    fr = _frames10(3)
    nf = _frames10(2, seed=5)
    out = {"kf": encode_keyframe(fr[0], qindex=Q_P, bit_depth=10,
                                 cdef=CDEF_P),
           "kf_nf": encode_keyframe(nf[0], qindex=Q_NF, bit_depth=10)}
    rk, rk_nf = _host(out["kf"][1]), _host(out["kf_nf"][1])
    out["p"] = mod.encode_pframe_tpu(fr[1], rk, qindex=Q_P, order_hint=1,
                                     cdef=CDEF_P, bit_depth=10, **S6, **dev)
    out["p_nf"] = mod.encode_pframe_tpu(nf[1], rk_nf, qindex=Q_NF,
                                        order_hint=1, bit_depth=10, **dev)
    out["anchor"] = mod.encode_pframe_tpu(
        fr[2], rk, qindex=Q_P, order_hint=2, cdef=CDEF_P, bit_depth=10,
        refresh_flags=1 << 1, show_frame=False, **S6, **dev)
    out["b"] = mod.encode_bframe_tpu(
        fr[1], rk, _host(out["anchor"][1]), qindex=Q_P, order_hint=1,
        slot_fwd=0, slot_bwd=1, ref_hints=(0, 2), cdef=CDEF_P,
        bit_depth=10, **BFRAME, **dev)
    return {k: (p, _host(r)) for k, (p, r) in out.items()}


def _reference_pb():
    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu.pipeline.intra import encode_keyframe
    return _pb_calls(jinter, encode_keyframe)


def test_hbd_p_and_b_frames_identical(shared_dir):
    """encode_pframe_tpu(bit_depth=10) with the speed-6 tools and the
    filters (deblock at bd 10, CDEF at CoeffShift 2) and without filters,
    the anchor P and encode_bframe_tpu(bit_depth=10): packets and recons
    equal the JAX package's byte for byte (the numpy keyframe under
    them), and libdav1d decodes each stream to the recons; the recons
    use the 10-bit range."""
    from rav1e_tpu_torch.pipeline.intra import encode_keyframe
    want = _once(shared_dir, "hbd_pb_96x64", _reference_pb)
    got = _pb_calls(tinter, encode_keyframe, device="cpu")
    for k in want:
        assert got[k][0] == want[k][0], k
        for a, b in zip(got[k][1], want[k][1]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert max(int(r.max()) for r in got["b"][1]) > 255
    _decodes_to([got["kf"][0], got["p"][0]], [got["kf"][1], got["p"][1]])
    _decodes_to([got["kf_nf"][0], got["p_nf"][0]],
                [got["kf_nf"][1], got["p_nf"][1]])
    _decodes_to([got["kf"][0], got["anchor"][0], got["b"][0]],
                [got["kf"][1], got["b"][1]])


# ---- the session ------------------------------------------------------------

CTX = dict(width=96, height=64, speed=6, quantizer=130, bit_depth=10)


def _session(cfg_cls, frames, **kw):
    ctx = cfg_cls(**CTX).new_context(**kw)
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    rows = []
    while True:
        _, p = ctx.receive_packet()
        if p is None:
            return rows
        rows.append((p.frame_type, p.input_frameno, p.qp, p.data))


def _reference_session():
    """The JAX Context at test_context_10bit_gop's settings."""
    from rav1e_tpu.api import Config as JConfig
    return _session(JConfig, _frames10(6, seed=33))


def test_context_10bit_identical(shared_dir, tmp_path):
    """Config(bit_depth=10).new_context() at test_context_10bit_gop's
    settings (96x64, speed 6, q 130, 6 frames: the numpy keyframe, the
    reordered group's anchor P and B frames on the device steps) gives
    the JAX Context's packets, frame types, frame numbers and qps byte
    for byte, libdav1d decodes it to 6 frames past the 8-bit range, and
    the CLI on the frames as a p10 y4m writes the same packets. Neither
    session runs the lookahead (8-bit sessions only)."""
    from rav1e_tpu_torch.api import Config
    from rav1e_tpu_torch.cli import main as cli
    from rav1e_tpu_torch.cli.ivf import read_ivf
    from rav1e_tpu_torch.cli.y4m import write_y4m
    want = _once(shared_dir, "hbd_context_96x64", _reference_session)
    frames = _frames10(6, seed=33)
    got = _session(Config, frames, device="cpu")
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for a, b in zip(got, want):
        assert a[3] == b[3], a[:3]
    dec = dav1d.decode_all([r[3] for r in got])
    assert len(dec) == len(frames)
    assert max(int(np.asarray(d.planes[0]).max()) for d in dec) > 255
    src, out = tmp_path / "in_p10.y4m", tmp_path / "out.ivf"
    write_y4m(src, frames, bit_depth=10)
    cli.main([str(src), "-o", str(out), "--quantizer", "130", "--device",
              "cpu"])
    assert [d for _, d in read_ivf(str(out))] == [r[3] for r in got]


# ---- sums past 2^24 at 10 bits ----------------------------------------------

def test_hbd_sums_past_2_24():
    """The sums that pass 2^24 only above 8 bits, each held to the
    reference's on built content:
    - the CDEF ladder's f32 table at bd 10 (noise_at_q255 x 4: a luma
      cell's exact total passes 2^24, and the exact integers rounded once
      differ from the reference's) equals the reference's table bit for
      bit, sampled (256x192) and full (160x96), and the per-SB search's
      index and planes equal cdef_search_persb_jax(bd=10)'s;
    - SATD: a 32-block's |H x H| total is at most 8,192 max |d| =
      8,380,416 < 2^24 at 10 bits (tpu_inter.satd), reached where each
      8x8 tile is 1023 times the Hadamard matrix (H d H = 8 x 1023 H:
      every output at 8 x 1023); there and on random +-1023 noise the
      port's value equals the reference's satd;
    - the full-pel SSD correlation above 8 bits (_bf16_corr, two f32
      running sums over the even and the odd columns) equals the
      reference's bf16 einsum at the shapes of a 16-px search: the
      full-resolution stage's 32-blocks (+-16 px) on bright 10-bit
      blocks with odd dark pixels (sums past 2^24), and the
      half-resolution stage's 16-blocks (+-8 px) on quarter-pel means,
      where torch's einsum differs. (The half-resolution stage of an
      8-px search, +-4 px, sums in another order, not yet matched:
      ROADMAP.md section 3.)"""
    from rav1e_tpu.ops.tpu import cdef as jc
    from rav1e_tpu.pipeline import tpu_inter as jinter
    j_search = jax.jit(jc.cdef_search_persb_jax, static_argnames=("bd",))
    for w, h in ((256, 192), (160, 96)):
        rec, src, skip8 = noise_at_q255(w, h, 11)
        rec = [np.clip(r // 4, 0, 255) * 4 for r in rec]
        src = [s * 4 for s in src]
        sampled = h % 64 == 0 and w % 64 == 0
        want = _reference_tables()([jnp.asarray(p) for p in rec],
                                   [jnp.asarray(p) for p in src],
                                   jnp.asarray(skip8), 3, bd=10)
        dirs, var = tc.cdef_dirs(_t(rec[0]), 10)
        tables = tc.cdef_ladder_sse([_t(p) for p in rec],
                                    [_t(p) for p in src], dirs, var,
                                    _t(skip8), 3, sampled, 10)
        for i in range(3):
            np.testing.assert_array_equal(tables[i].numpy(),
                                          np.asarray(want[i]))
        errs, dims = tc._ladder_errors(_t(rec[0]), _t(src[0]), dirs, var,
                                       _t(skip8), 3, False, sampled, 10)
        exact = torch.stack([torch.sum(e.long() ** 2, dim=dims)
                             for e in errs])
        assert int(exact.max()) >= 2 ** 24
        assert not np.array_equal(exact.float().numpy(), np.asarray(want[0]))
        ij, pj = j_search([jnp.asarray(p) for p in rec],
                          [jnp.asarray(p) for p in src], jnp.asarray(skip8),
                          3, lam=jnp.float32(60.0), bd=10)
        it, pt = tc.cdef_search_persb([_t(p) for p in rec],
                                      [_t(p) for p in src], _t(skip8), 3,
                                      lam=torch.tensor(60.0), bd=10)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rng = np.random.default_rng(3)
    had = np.array([[1 - 2 * (bin(i & j).count("1") & 1) for j in range(8)]
                    for i in range(8)])
    worst = np.tile(had, (4, 4))
    d = np.stack([1023 * worst, -1023 * worst,
                  1023 * rng.choice([-1, 1], (32, 32)),
                  rng.integers(-1023, 1024, (32, 32))]).astype(np.int32)
    st = tinter.satd(_t(d)).numpy()
    sj = np.asarray(jax.jit(jinter.satd)(jnp.asarray(d)))
    np.testing.assert_array_equal(st, sj)
    assert float(st.max()) * 8 == 8192 * 1023 < 2 ** 24

    def corr_ref(b, w2):
        return jnp.einsum("brc,bRdc->brRd", b.astype(jnp.bfloat16),
                          w2.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    j_corr = jax.jit(corr_ref)
    for n, S, frac in ((32, 16, False), (16, 8, True)):
        def plane(shape):
            big = rng.choice([1023, 1000, 900, 770, 520], shape)
            dark = (rng.integers(1, 255, shape) | 1) / (4.0 if frac else 1)
            return np.where(rng.random(shape) < 0.6, big, dark)
        blk = plane((8, n, n)).astype(np.float32)
        win = plane((8, n + 2 * S, n + 2 * S)).astype(np.float32)
        b_bf = _t(blk).to(torch.bfloat16).float()
        w_bf = _t(win).to(torch.bfloat16).float()
        w2 = torch.stack([w_bf[:, :, dx: dx + n] for dx in range(2 * S + 1)],
                         2)
        want = np.asarray(j_corr(jnp.asarray(blk), jnp.asarray(w2.numpy())))
        got = tinter._bf16_corr(b_bf, w2).numpy()
        np.testing.assert_array_equal(got, want)
        if not frac:
            assert float(want.max()) > 2 ** 24
        else:
            other = torch.einsum("brc,bRdc->brRd", b_bf, w2).numpy()
            assert not np.array_equal(other, want)
