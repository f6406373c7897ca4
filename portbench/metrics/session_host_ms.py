"""The session layer's host time a frame (api/context.py, the lookahead,
scene detection, rate control, and the harness's own send and drain):
over the profiled part of the window (no stage synchronizes), the wall
from its start to its last display packet minus the time spent inside
the pipeline calls there, over the frames displayed there."""


def read(run):
    shown, start, t_last, calls = run.profiled()
    if not shown:
        return None
    inside = sum(c.t1 - c.t0 for c in calls)
    return (t_last - start - inside) / len(shown) * 1e3
