"""The lookahead and scene detection (analysis/lookahead.py,
analysis/scenechange.py) in ms a frame sent, read from the port's spans
(rav1e_tpu_torch.trace) over the profiled part of a traced window: the
Context's `lookahead` spans (pack_src and push_packed, scales or
scales_at, pop) and `scenechange` spans, summed, over its send_frame
spans there. None on a port without the span recorder."""

try:
    from rav1e_tpu_torch import trace
except ImportError:
    trace = None
else:
    trace.enable()


def read(run):
    if trace is None or run.trace is None:
        return None
    t0, t1 = run.trace.t0_ns, run.trace.t1_ns
    sp = [s for s in trace.spans() if t0 <= s.t0_ns and s.t1_ns <= t1]
    sent = sum(1 for s in sp if s.name == "send_frame")
    if not sent:
        return None
    t = sum(s.t1_ns - s.t0_ns for s in sp
            if s.name in ("lookahead", "scenechange"))
    return t / sent / 1e6
