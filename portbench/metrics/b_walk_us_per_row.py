"""The B frames' Python tile walk (entropy/tile.py's TileWriter into
od_ec IR) in us an IR row, read from the port's spans
(rav1e_tpu_torch.trace) over the profiled part of a traced window: the
B frames' `tile_walk` spans over the IR rows they wrote (each span's
work count), which tells a slower walk from more symbols. None on a
port without the span recorder."""

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
    walks = [s for s in trace.spans()
             if s.name == "tile_walk" and s.kind == "bframe" and s.n
             and t0 <= s.t0_ns and s.t1_ns <= t1]
    rows = sum(s.n for s in walks)
    if not rows:
        return None
    return sum(s.t1_ns - s.t0_ns for s in walks) / rows / 1e3
