"""The card's idle time under the inter pipeline's device step, read
from the port's spans (rav1e_tpu_torch.trace) and the profiler's device
activity over the profiled part of a traced window (no stage
synchronizes there): trace.idle_under's seconds under the P and B
frames' stage spans from `upload` up to the first packing stage (the
stages inter_step_ms sums), in ms an inter frame (their `frame` spans
there). The card waiting on the step's host work and launches. None on
a port without the span recorder."""

try:
    from rav1e_tpu_torch import trace
except ImportError:
    trace = None
else:
    trace.enable()

INTER = {"pframe", "pframe2", "bframe"}
STEP = {"upload", "search", "cand", "code", "split", "merge64", "intra",
        "filt", "cdef"}


def read(run):
    if trace is None or run.trace is None:
        return None
    t0, t1 = run.trace.t0_ns, run.trace.t1_ns
    sp = [s for s in trace.spans() if t0 <= s.t0_ns and s.t1_ns <= t1]
    frames = sum(1 for s in sp if s.name == "frame" and s.kind in INTER)
    if not frames:
        return None
    idle = trace.idle_under(sp, run.trace.intervals(), t0, t1)
    return sum(v for p, v in idle.items() if _under_step(p)) / frames * 1e3


def _under_step(path: str) -> bool:
    """An inter frame's step stage, or a span inside one."""
    parts = path.split("/")
    return len(parts) > 1 and parts[0] in INTER and parts[1] in STEP
