"""The numpy inter pipeline (pipeline/inter.py) and the Context's routes
onto it, in the port against the JAX package, on the CPU.

pipeline/inter.py is the JAX package's, copied with its imports renamed;
its packer IR is coded on the CPU here (device="cpu"). Its P and B frames
at 4:2:0 with CDEF (with and without variance AQ), 4:2:0 at 12 bits with
CDEF, and 4:2:2 and 4:4:4 (tests/test_chroma_inter.py's content and q)
equal the JAX package's packets and recons byte for byte, and libdav1d and
libaom decode them to those recons. At 4:2:2 and 4:4:4 the port differs
from the JAX package where the JAX package's streams decode to other
chroma pixels than its recons (ROADMAP.md section 3): with CDEF on (its
CDEF filters chroma as 4:2:0 at every sampling), with loop restoration
(it searches and signals 4:2:2 / 4:4:4 chroma units as 4:2:0 luma ones)
and at 4:2:2 wherever a 16x32 chroma block reads above-right pixels (its
numpy keyframe reads 32 where decoders read 16). The port's follow the
decoders, and its streams are held to their decodes instead.

The sessions: 4:2:2, 4:4:4 and 12-bit Contexts (the numpy keyframe and
numpy inter frames, no JAX compile), and tests/test_resilience.py's
switch-frame and error-resilient sessions with its content, and a
photon-noise session on that content (the device steps with film grain),
whose JAX programs tests/test_resilience.py compiles too: packets, frame
types and qps equal the JAX Context's byte for byte, and the streams
decode on both decoders (libaom applies the grain, libdav1d here does
not). The CLI codes the 12-bit y4m to the Context's packets."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from test_chroma_inter import _planes
from test_resilience import _frames as _resilience_frames
from rav1e_tpu_torch.conform import aom, dav1d
from rav1e_tpu_torch.entropy.obu import show_existing_packet
from rav1e_tpu_torch.pipeline import inter as pinter
from rav1e_tpu_torch.pipeline import intra as pintra

Q = 110                               # test_chroma_inter's q
Q_CDEF = 150           # a session's CDEF filters from q 120 (y_pri 3)
CDEF = (1, 0, 1, 0, 3)


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread and hand the worker's freed heap back to
    the system around the module (glibc's malloc_trim)."""
    _trim_heap()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _deep(planes, bd):
    """8-bit planes as bd-bit uint16 ones, with low bits set."""
    return [(p.astype(np.uint16) << (bd - 8)) | (p.astype(np.uint16) & 3)
            for p in planes]


def _decodes_to(pkts, recs):
    """libdav1d and libaom decode the packets to the shown recons."""
    d = dav1d.decode_all(pkts)
    a = aom.decode_all(pkts)
    assert len(d) == len(a) == len(recs)
    for i, rec in enumerate(recs):
        for j in range(3):
            np.testing.assert_array_equal(np.asarray(d[i].planes[j]),
                                          rec[j], err_msg=f"{i} {j}")
            np.testing.assert_array_equal(np.asarray(a[i][j]), rec[j],
                                          err_msg=f"{i} {j}")


def _group(mod, f, krec, cs, bd, cdef, aq=False, q=Q, **dev):
    """An anchor P (frame 2, non-shown, slot 1) and the B frame between
    it and the keyframe, by `mod`'s encode_pframe / encode_bframe."""
    kw = dict(qindex=q, chroma_sampling=cs, bit_depth=bd, cdef=cdef, **dev)
    apkt, arec = mod.encode_pframe(f[2], krec, order_hint=2,
                                   refresh_flags=0x02, ref_slot=0,
                                   show_frame=False, aq=aq, **kw)
    bpkt, brec = mod.encode_bframe(f[1], krec, arec, order_hint=1,
                                   slot_fwd=0, slot_bwd=1, ref_hints=(0, 2),
                                   **kw)
    return apkt, arec, bpkt, brec


CASES = [("420", 8, CDEF, False), ("420", 8, CDEF, True),
         ("420", 12, CDEF, False), ("422", 8, None, False),
         ("444", 8, None, False)]


def test_numpy_pframe_bframe_equal_reference():
    """For each case of CASES (chroma sampling, bit depth, CDEF, AQ): the
    port's numpy P and B frames equal the JAX package's, packets and
    recons, after the port's numpy keyframe of the same case; the KEY,
    P, B, show-existing stream decodes to the recons on both decoders.
    Then 4:2:2 and 4:4:4 with CDEF, and with CDEF and loop restoration
    on every frame (q 150, the Wiener and SGR units on the CPU device):
    the port's streams decode to its recons (the JAX package's do not,
    in chroma)."""
    from rav1e_tpu.pipeline import inter as jinter
    for cs, bd, cdef, aq, *lr in CASES + [
            ("422", 8, CDEF, False), ("444", 8, CDEF, False),
            ("422", 8, (3, 1, 2, 0, 4), False, True),
            ("444", 8, (3, 1, 2, 0, 4), False, True)]:
        f = [_planes(cs, t=t) for t in range(3)]
        if bd > 8:
            f = [_deep(p, bd) for p in f]
        kw = dict(lr=True, q=Q_CDEF) if lr else {}
        kpkt, krec = pintra.encode_keyframe(f[0], qindex=kw.get("q", Q),
                                            cdef=cdef, chroma_sampling=cs,
                                            bit_depth=bd, lr=bool(lr),
                                            device="cpu")
        got = _group(pinter, f, krec, cs, bd, cdef, aq, device="cpu", **kw)
        if (cs, bd, cdef, aq) in CASES:
            want = _group(jinter, f, krec, cs, bd, cdef, aq)
            assert got[0] == want[0] and got[2] == want[2], (cs, bd, aq)
            for a, b in zip(got[1] + got[3], want[1] + want[3]):
                np.testing.assert_array_equal(a, b)
        _decodes_to([kpkt, got[0], got[2], show_existing_packet(1)],
                    [krec, got[3], got[1]])


def _run(ctx, frames):
    """Send every frame, flush, drain: (frame type, frame number, qp,
    bytes) rows."""
    for f in frames:
        assert ctx.send_frame(f).name == "SUCCESS"
    ctx.flush()
    rows = []
    while True:
        st, p = ctx.receive_packet()
        if p is None:
            assert st.name == "LIMIT_REACHED"
            return rows
        rows.append((p.frame_type, p.input_frameno, p.qp, p.data))


def _sessions_equal(frames, decoded=True, **cfg):
    """The port's Context (device="cpu") and the JAX package's on the same
    frames give the same rows; the stream decodes on both decoders (the
    same frames unless decoded=False: film grain). Returns the rows."""
    from rav1e_tpu.api import Config as JConfig
    from rav1e_tpu_torch.api import Config
    h, w = frames[0][0].shape
    want = _run(JConfig(width=w, height=h, **cfg).new_context(), frames)
    got = _run(Config(width=w, height=h, **cfg).new_context(device="cpu"),
               frames)
    assert [r[:3] for r in got] == [r[:3] for r in want], cfg
    for a, b in zip(got, want):
        assert a[3] == b[3], (cfg, a[:3])
    pkts = [r[3] for r in got]
    d, a = dav1d.decode_all(pkts), aom.decode_all(pkts)
    assert len(d) == len(a) == len(frames)
    if decoded:
        for i in range(len(frames)):
            for j in range(3):
                np.testing.assert_array_equal(np.asarray(d[i].planes[j]),
                                              np.asarray(a[i][j]))
    return got


def test_numpy_sessions_equal_reference(tmp_path):
    """4:4:4 low latency and reordered at speed 6 with CDEF off (its CDEF
    is the port's own, above) and a 12-bit 4:2:0 reordered session whose
    CDEF filters (q 150; the numpy keyframe and inter frames): each equals
    the JAX Context's packets. Then 4:2:2 sessions (whose keyframes are
    the port's own, above), low latency at q 110 and reordered at q 150,
    and a 4:4:4 one at q 150 (CDEF on) decode on both decoders to the
    recons the port's pipelines returned; and the CLI on the 12-bit
    frames as a y4m writes the 12-bit session's packets."""
    from rav1e_tpu_torch.api import Config
    from rav1e_tpu_torch.cli import main as cli
    from rav1e_tpu_torch.cli.ivf import read_ivf
    from rav1e_tpu_torch.cli.y4m import write_y4m
    off = {"cdef": "off"}
    f422 = [_planes("422", t=t) for t in range(5)]
    f444 = [_planes("444", t=t) for t in range(5)]
    for ll in (True, False):
        _sessions_equal(f444, chroma_sampling="444", quantizer=Q,
                        low_latency=ll, extra=off)
    f12 = [_deep(_planes("420", t=t), 12) for t in range(5)]
    rows = _sessions_equal(f12, bit_depth=12, quantizer=Q_CDEF)
    assert [r[0] for r in rows].count("INTER") == 4
    for cs, frames, q, ll in (("422", f422, Q, True),
                              ("422", f422, Q_CDEF, False),
                              ("444", f444, Q_CDEF, False)):
        kept = {}                  # each coded packet's recon
        saved = (pintra.encode_keyframe, pinter.encode_pframe,
                 pinter.encode_bframe)

        def keeping(fn):
            def call(*a, **k):
                pkt, rec = fn(*a, **k)
                kept[pkt] = rec
                return pkt, rec
            return call

        pintra.encode_keyframe, pinter.encode_pframe, pinter.encode_bframe = (
            keeping(fn) for fn in saved)
        try:
            got = _run(Config(width=128, height=96, chroma_sampling=cs,
                              quantizer=q, low_latency=ll).new_context(
                                  device="cpu"), frames)
        finally:
            (pintra.encode_keyframe, pinter.encode_pframe,
             pinter.encode_bframe) = saved
        coded = {r[1]: kept[r[3]] for r in got if r[0] != "SHOW_EXISTING"}
        later = {r[1] for r in got if r[0] == "SHOW_EXISTING"}
        # the frames in display order: a non-shown anchor shows at its
        # show-existing packet
        shown = [coded[r[1]] for r in got
                 if r[0] == "SHOW_EXISTING" or r[1] not in later]
        _decodes_to([r[3] for r in got], shown)
    src, out = tmp_path / "in_p12.y4m", tmp_path / "out.ivf"
    write_y4m(src, f12, bit_depth=12)
    cli.main([str(src), "-o", str(out), "--quantizer", str(Q_CDEF),
              "--device", "cpu"])
    assert [d_ for _, d_ in read_ivf(str(out))] == [r[3] for r in rows]


def test_resilient_and_grain_sessions_equal_reference():
    """tests/test_resilience.py's sessions on its content (96x64): switch
    frames every 3 (speed 6; the S-frames on the numpy P frame with
    whole-pel MVs, the other inter frames on the device steps) and every
    inter frame error-resilient (speed 8, the numpy P frame with the
    slots' order hints); then a reordered speed-6 session with photon
    noise (ISO 800: the keyframe on the numpy keyframe, the anchor P and
    B frames on the device steps with the grain table in their headers).
    Each equals the JAX Context's packets, frame types and qps byte for
    byte and decodes on both decoders (libdav1d without the grain, which
    libaom applies)."""
    frames = _resilience_frames(7)
    rows = _sessions_equal(frames, speed=6, quantizer=120, low_latency=True,
                           extra={"switch_frame_interval": 3})
    assert [r[0] for r in rows] == ["KEY"] + ["INTER"] * 6
    _sessions_equal(frames[:5], speed=8, quantizer=120, low_latency=True,
                    extra={"error_resilient": "1"})
    rows = _sessions_equal(frames[:5], decoded=False, speed=6, quantizer=Q,
                           extra={"photon_noise": 800})
    assert [r[0] for r in rows].count("SHOW_EXISTING") == 2
