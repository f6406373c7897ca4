"""The session layer's own host time a frame, read from the port's spans
(rav1e_tpu_torch.trace) over the profiled part of a traced window (no
stage synchronizes there): the time inside the Context's send_frame and
receive_packet spans less the pipeline calls' `frame` spans inside
them, in ms, over the frames coded there (their `frame` spans: numerator
and denominator cover the same stretch of the session). The Context's
routing, padding, lookahead, scene detection, rate control and recon
round trips; unlike session_host_ms, none of the harness's own work.
None on a port without the span recorder."""

from bisect import bisect_right

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
    outer = sorted((s.t0_ns, s.t1_ns, s.tid) for s in sp
                   if s.name in ("send_frame", "receive_packet"))
    frames = [s for s in sp if s.name == "frame"]
    if not outer or not frames:
        return None
    starts = [o[0] for o in outer]
    inside = 0
    for s in frames:
        j = bisect_right(starts, s.t0_ns) - 1
        if j >= 0 and s.t1_ns <= outer[j][1] and s.tid == outer[j][2]:
            inside += s.t1_ns - s.t0_ns
    return (sum(e - b for b, e, _ in outer) - inside) / len(frames) / 1e6
