"""The keyframe's recon wavefront (pipeline/tpu_intra.py's
recon_wavefront, a host loop over the frame's anti-diagonals), in device
events a diagonal, read from the port's spans (rav1e_tpu_torch.trace)
and the profiler's device activity over the profiled part of a traced
window: the device events (kernels, copies, sets) that start inside the
`recon_wavefront` spans, over those spans' diagonals (each span's work
count). None on a port without the span recorder."""

from bisect import bisect_left, bisect_right

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
    waves = [s for s in trace.spans()
             if s.name == "recon_wavefront" and s.n
             and t0 <= s.t0_ns and s.t1_ns <= t1]
    if not waves:
        return None
    starts = sorted(start for _, start, _ in run.trace.events)
    n = sum(bisect_right(starts, s.t1_ns) - bisect_left(starts, s.t0_ns)
            for s in waves)
    return n / sum(s.n for s in waves)
