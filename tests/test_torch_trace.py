"""The port's span recorder (rav1e_tpu_torch/trace.py) on the CPU: spans
nest and keep their frame in worker threads; with tracing off nothing is
recorded and the clock is never read; with `timings` each stage's time
is its span's; idle_under on hand-worked intervals; and Context sessions
at speeds 10 and 6 give one `frame` span a coded frame, of the route's
kind, with the pipeline's stages inside. One case runs on the card: a
span around a kernel holds the kernel's start on the profiler's clock.
No JAX: the card's machine has none."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_content import session
from rav1e_tpu_torch import trace
from rav1e_tpu_torch.api import Config, EncoderStatus
from rav1e_tpu_torch.pipeline import tpu_inter


@pytest.fixture
def tracing():
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def _planes(rng, h=64, w=64):
    return [rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)]


def _p_frame(timings=None):
    """A 64x64 speed-10 P frame on the CPU: its stage names in order."""
    rng = np.random.default_rng(7)
    tpu_inter.encode_pframe_tpu(_planes(rng), _planes(rng), 100,
                                use_split=False, subpel=False, device="cpu",
                                timings=timings)


def _nest():
    with trace.frame(3, "bframe"):
        st = trace.stages("cpu", None)
        st.mark("upload")
        with st.span("ec_kernel", 2):
            st.mark("ir_upload")
        with trace.span("host32"):
            pass
    with trace.span("receive_packet"):
        with trace.span("rc"):
            pass
    sp = trace.spans()
    assert [s.name for s in sp] == ["upload", "ir_upload", "ec_kernel",
                                    "host32", "frame", "rc",
                                    "receive_packet"]
    assert [(s.frame, s.kind) for s in sp[:5]] == [(3, "bframe")] * 5
    assert (sp[5].frame, sp[5].kind) == (-1, "")
    assert sp[2].n == 2 and sp[0].n is None
    assert trace.paths(sp) == ["bframe/upload", "bframe/ec_kernel/ir_upload",
                               "bframe/ec_kernel", "bframe/host32", "bframe",
                               "receive_packet/rc", "receive_packet"]
    # stages tile their call: each starts where the one before ended
    assert sp[0].t1_ns == sp[2].t0_ns == sp[1].t0_ns
    assert sp[1].t1_ns <= sp[2].t1_ns <= sp[3].t0_ns <= sp[4].t1_ns
    assert sp[4].t0_ns <= sp[0].t0_ns


def _carry():
    main = threading.get_ident()

    def work(k):
        with trace.span("walk", k):
            time.sleep(0.001)
        return threading.get_ident()

    with trace.frame(5, "pframe"):
        with ThreadPoolExecutor(3) as ex:
            tids = set(ex.map(trace.carry(work), range(6)))
        with ThreadPoolExecutor(1) as ex:     # not carried: no frame
            ex.submit(work, 9).result()
    walks = [s for s in trace.spans() if s.name == "walk"]
    assert main not in tids and len(walks) == 7
    assert {(s.frame, s.kind) for s in walks if s.n != 9} == {(5, "pframe")}
    assert [(s.frame, s.kind) for s in walks if s.n == 9] == [(-1, "")]
    sp = trace.spans()
    assert {p for s, p in zip(sp, trace.paths(sp))
            if s.name == "walk"} == {"pframe/walk", "walk"}


def _stress():
    """More threads than cores record at once, at a short switch
    interval: no span is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def record(k):
            with trace.frame(k, "pframe"):
                for _ in range(200):
                    with trace.span("s"):
                        pass
        with ThreadPoolExecutor(32) as ex:
            list(ex.map(trace.carry(record), range(64)))
    finally:
        sys.setswitchinterval(old)
    sp = trace.spans()
    assert sum(s.name == "s" for s in sp) == 64 * 200
    assert sorted(s.frame for s in sp if s.name == "frame") == list(range(64))


@pytest.mark.parametrize("case", ["nest", "carry", "stress"])
def test_spans(tracing, case):
    {"nest": _nest, "carry": _carry, "stress": _stress}[case]()


@pytest.mark.parametrize("case", ["recorder", "pframe"])
def test_tracing_off_reads_no_clock(monkeypatch, case):
    """With tracing off and no timings, nothing is recorded and
    time.time_ns is never called: not by the recorder's objects, not in a
    whole P frame."""
    trace.disable()
    trace.clear()

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "time_ns", no_clock)
    if case == "recorder":
        st = trace.stages("cpu", None)
        assert st is trace.OFF
        st.mark("x", 3)
        with st.span("y"), trace.span("z"), trace.frame(1, "pframe"):
            pass
        fn = len
        assert trace.carry(fn) is fn
    else:
        _p_frame()
    assert trace.spans() == []


def test_timings_are_the_spans(tracing):
    """In sync mode (a timings dict), every timings value is the duration
    of the span of the same name, and each stage recorded one span."""
    t: dict = {}
    _p_frame(t)
    sp = trace.spans()
    assert sorted(s.name for s in sp) == sorted(t)
    for s in sp:
        assert t[s.name] == (s.t1_ns - s.t0_ns) / 1e9, s.name
    assert {"upload", "search", "tile_walk", "ec_kernel", "finish"} <= set(t)


def _span(name, t0, t1, tid=1, kind=""):
    return trace.Span(name, 0 if kind else -1, kind, tid, t0, t1, None)


IDLE_CASES = {
    # gaps [-10, -2), [1, 10), [20, 30), [50, 60) in [-10, 60) around a
    # frame [5, 58) whose stages are [5, 25) and [25, 50)
    "stages": ([_span("upload", 5, 25, kind="pframe"),
                _span("search", 25, 50, kind="pframe"),
                _span("frame", 5, 58, kind="pframe")],
               [(10, 20), (-2, 1), (30, 50)], -10, 60,
               {"outside": 8e-9, "pframe/upload": 9e-9,
                "pframe/search": 10e-9, "pframe": 10e-9}),
    # overlapping, unsorted busy intervals clipped to the window (gaps
    # [30, 80) and [95, 100)); the innermost span is the one that
    # started last, whatever its thread
    "threads": ([_span("receive_packet", 0, 100),
                 _span("walk", 40, 90, tid=2, kind="bframe")],
                [(80, 95), (-5, 20), (10, 30)], 0, 100,
                {"bframe/walk": 50e-9, "receive_packet": 5e-9}),
    # a gap's middle decides: [20, 80)'s middle 50 lies in b, not a
    "middle": ([_span("a", 0, 45), _span("b", 45, 100)],
               [(0, 20), (80, 100)], 0, 100, {"b": 60e-9}),
    "no spans": ([], [(0, 50)], 0, 100, {"outside": 50e-9}),
}


@pytest.mark.parametrize("case", list(IDLE_CASES))
def test_idle_under(case):
    spans, busy, t0, t1, want = IDLE_CASES[case]
    got = trace.idle_under(spans, busy, t0, t1)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12)


ROUTES = {10: {0: "keyframe", **{i: "pframe" for i in range(1, 5)}},
          6: {0: "keyframe", 1: "bframe", 2: "bframe", 3: "bframe",
              4: "pframe"}}


@pytest.mark.parametrize("speed", [10, 6])
def test_session_frames(tracing, speed):
    """A 128x96 session of 5 frames on the CPU (speed 10 IPPP, speed 6 a
    keyframe and a reordered group): one frame span per coded frame, of
    its route's kind, each holding its pipeline's stages on its frame;
    the session's spans around them."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = Config(width=128, height=96, speed=speed,
                     low_latency=speed == 10).new_context(device="cpu")
        coded = []
        for f in session(128, 96, 5) + [None]:
            ctx.send_frame(f)
            while True:
                st, pkt = ctx.receive_packet()
                if st != EncoderStatus.SUCCESS:
                    break
                if pkt.frame_type != "SHOW_EXISTING":
                    coded.append(pkt.input_frameno)
    finally:
        torch.set_num_threads(torch_threads)
    sp = trace.spans()
    frames = [s for s in sp if s.name == "frame"]
    assert [s.frame for s in frames] == coded
    assert {s.frame: s.kind for s in frames} == ROUTES[speed]
    for fr in frames:
        inner = {s.name: s for s in sp if s.frame == fr.frame
                 and s.name != "frame"}
        assert all(s.kind == fr.kind and fr.t0_ns <= s.t0_ns
                   and s.t1_ns <= fr.t1_ns for s in inner.values())
        assert inner["tile_walk"].n > 0 and "ec_kernel" in inner
        if fr.kind == "keyframe":
            # the anti-diagonals of 3 x 4 32-blocks: i + j at speed 10,
            # 2i + j with speed 6's D45 / D67 modes
            assert inner["recon_wavefront"].n == {10: 6, 6: 8}[speed]
        else:
            assert {"upload", "search", "code", "fetch_unpack"} <= set(inner)
    names = [s.name for s in sp]
    assert names.count("send_frame") == 6 and names.count("pad") == 5
    assert {"scenechange", "rc", "receive_packet"} <= set(names)
    assert ("lookahead" in names) == (speed == 6)


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_profilers_clock(tracing):
    """A span around one kernel (launched and waited for inside it), under
    torch.profiler: the kernel's device start lies in the span, within
    50 us: the spans and the device's events share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 24, device="cuda")
    x.mul_(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        with trace.span("kernel"):
            x.mul_(2)
            torch.cuda.synchronize()
        time.sleep(0.01)
    s, = trace.spans()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")]
    assert len(starts) == 1, starts
    assert s.t0_ns - 50_000 <= starts[0] <= s.t1_ns + 50_000, (s, starts)
