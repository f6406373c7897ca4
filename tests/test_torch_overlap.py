"""The GOP overlap's shared state and schedule, on the CPU (plain torch,
no JAX): the kernels' launch counters under worker threads, the
overlapped encode_gop_tpu against the same frames encoded in order,
pack_keyframe's two walks, and a packer error raised from a worker."""

import sys
import threading

import numpy as np
import pytest

import chip_smoke
from rav1e_tpu_torch import nvcc
from rav1e_tpu_torch.pipeline import tpu_inter, tpu_intra

CDEF = (0, 0, 0, 0, 3)


def test_launch_counts_survive_threads():
    """nvcc.count_launch from more threads than cores, with the
    interpreter switching threads as often as it can, loses no add."""

    def kernel():
        pass

    kernel.launches = 0
    threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [nvcc.count_launch(kernel)
                                               for _ in range(each)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == threads * each


def test_overlapped_gop_equals_frames_in_order():
    """encode_gop_tpu (the keyframe's host half, pack_src and each P
    frame's fetch + pack on worker threads) gives the packets and recons
    of the same frames encoded one after another: the keyframe, then
    each P frame on the previous recon with the speed-7 GOP's tools."""
    frames = chip_smoke.squares(chip_smoke.synth(64, 64, n=3))
    timings: list = []
    pkts, recs = tpu_inter.encode_gop_tpu(frames, 100, speed=7, cdef=CDEF,
                                          device="cpu", timings=timings)
    pkt, rec = tpu_intra.encode_keyframe_tpu(frames[0], 100, speed=7,
                                             cdef=CDEF, device="cpu")
    assert pkts[0] == pkt
    for a, b in zip(recs[0], rec):
        np.testing.assert_array_equal(a, b)
    ref = None
    for i in (1, 2):
        pkt, rec, ref = tpu_inter.encode_pframe_tpu(
            frames[i], rec, 100, order_hint=i, ref_dev=ref,
            return_device=True, cdef=CDEF, refine16=False, search=8,
            device="cpu")
        assert pkts[i] == pkt, i
        for a, b in zip(recs[i], rec):
            np.testing.assert_array_equal(a.numpy(), b)
    assert len(timings) == 3 and timings[0]["gop_wall"] > 0
    for t in timings:
        assert {"fetch_unpack", "tile_walk", "ec_kernel", "finish"} <= set(t)


@pytest.mark.parametrize("speed", [7, 10])
def test_pack_keyframe_walks_agree(speed):
    """pack_keyframe's C++ packer walk and its Python TileWriter walk
    (use_native=False) give the same packet and recon."""
    planes = chip_smoke.squares(chip_smoke.synth(96, 64))[0]
    kd = tpu_intra.analyze_keyframe(planes, 100, speed, cdef=CDEF,
                                    device="cpu")
    t_n, t_p = {}, {}
    pkt_n, rec_n = tpu_intra.pack_keyframe(kd, planes, 100, device="cpu",
                                           timings=t_n)
    pkt_p, rec_p = tpu_intra.pack_keyframe(kd, planes, 100, device="cpu",
                                           timings=t_p, use_native=False)
    assert pkt_n == pkt_p
    for a, b in zip(rec_n, rec_p):
        np.testing.assert_array_equal(a, b)
    assert {"tile_walk", "ir_upload", "ec_kernel", "finish"} <= set(t_n)
    assert {"tile_walk", "ec_kernel", "finish"} <= set(t_p)


def test_packer_errors_raise_through_the_pipelines(monkeypatch):
    """A packer error is not swallowed: an IR buffer too small for the
    tile raises out of encode_pframe_tpu and, from the worker threads,
    out of encode_gop_tpu."""
    from rav1e_tpu_torch.entropy.native import NativeTileWriter
    frames = chip_smoke.synth(64, 64, n=2)
    monkeypatch.setattr(NativeTileWriter, "ir_cap", 1)
    with pytest.raises(ValueError, match="IR has"):
        tpu_inter.encode_pframe_tpu(frames[1], frames[0], device="cpu",
                                    use_split=False, refine16=False,
                                    search=8, subpel=False)
    with pytest.raises(ValueError, match="IR has"):
        tpu_inter.encode_gop_tpu(frames, 100, speed=10, device="cpu")
