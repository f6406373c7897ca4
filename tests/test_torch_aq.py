"""Keyframe variance AQ in the port against the JAX package, on the CPU.

encode_keyframe_tpu(aq=True) at tests/test_tpu_pipeline.py's
test_tpu_wavefront_aq_conformance content and calls (128x96, flat left
half, noisy right half, q 100, speeds 6 and 10, so the JAX programs are
that test's): the per-32-block segment map (host numpy, the reference's
f64 variances and quartiles), the per-block quantizers gathered in phase
1 and read per skewed diagonal in the recon wavefront, and the Python
TileWriter walk with the segment ids give the JAX package's packet and
recon byte for byte, and both decoders decode the packet to the recon.
An `aq` session (the AQ keyframe on the device, the inter frames on the
numpy pipeline, as the reference routes them) equals the JAX Context's
packets."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.conform import aom, dav1d
from rav1e_tpu_torch.pipeline import tpu_intra as tti


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


def _aq_content():
    """test_tpu_wavefront_aq_conformance's planes."""
    rng = np.random.default_rng(11)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    y = (90 + 60 * np.sin(xx / 29)).astype(np.float64)
    y[:, w // 2:] += rng.normal(0, 40, (h, w // 2))
    return [y.clip(0, 255).astype(np.uint8),
            np.full((h // 2, w // 2), 120, np.uint8),
            (128 + 20 * np.cos(yy[::2, ::2] / 13)).clip(0, 255).astype(
                np.uint8)]


def _run(ctx, frames):
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    rows = []
    while True:
        _, p = ctx.receive_packet()
        if p is None:
            return rows
        rows.append((p.frame_type, p.input_frameno, p.qp, p.data))


def test_aq_keyframe_and_session_equal_reference():
    """The AQ keyframe at speeds 6 and 10: packet and recon equal the JAX
    package's, the four segments all used, and both decoders decode it
    to the recon; the segment map is the reference's quartiles of the
    blocks' f64 variances. Then a reordered speed-10 `aq` session on
    moving copies of the content (7 frames, q 110) equals the JAX
    Context's packets and decodes on both decoders."""
    from rav1e_tpu.api import Config as JConfig
    from rav1e_tpu.pipeline.tpu_intra import encode_keyframe_tpu as jkey
    from rav1e_tpu_torch.api import Config
    planes = _aq_content()
    for speed in (6, 10):
        pkt_j, rec_j = jkey(planes, qindex=100, speed=speed, aq=True)
        pkt, rec = tti.encode_keyframe_tpu(planes, qindex=100, speed=speed,
                                           aq=True, device="cpu")
        assert pkt == pkt_j, speed
        for a, b in zip(rec, rec_j):
            np.testing.assert_array_equal(a, np.asarray(b))
        d, a = dav1d.decode_all([pkt]), aom.decode_all([pkt])
        for j in range(3):
            np.testing.assert_array_equal(np.asarray(d[0].planes[j]),
                                          rec[j])
            np.testing.assert_array_equal(np.asarray(a[0][j]), rec[j])
    seg_map, alt, _ = tti._aq_segments(planes[0], 100)
    assert sorted(set(seg_map.ravel().tolist())) == [0, 1, 2, 3]
    assert alt[:4] == list(tti.KF_SEG_ALT_Q)
    frames = [[np.roll(p, 4 * t >> (j > 0), axis=1)
               for j, p in enumerate(planes)] for t in range(7)]
    kw = dict(width=128, height=96, speed=10, quantizer=110,
              extra={"aq": "1"})
    want = _run(JConfig(**kw).new_context(), frames)
    got = _run(Config(**kw).new_context(device="cpu"), frames)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for x, y in zip(got, want):
        assert x[3] == y[3], x[:3]
    pkts = [r[3] for r in got]
    d, a = dav1d.decode_all(pkts), aom.decode_all(pkts)
    assert len(d) == len(a) == len(frames)
    for i in range(len(frames)):
        for j in range(3):
            np.testing.assert_array_equal(np.asarray(d[i].planes[j]),
                                          np.asarray(a[i][j]))
