"""The end-to-end metrics (the harness's own host clock and packet
counts) and the per-layer metrics (one reader file each under
`portbench/metrics/`, found by the metric's name)."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

METRICS = Path(__file__).resolve().parent.parent / "metrics"


@dataclass
class RunData:
    """What a per-layer reader reads: the session's log and window, the
    pipeline calls, and in a traced run the trace and the launches each
    capturing reader kept over the profiled part of the window, which
    starts at `t_switch` (the calls before it carry stage `timings`)."""

    log: object               # session.SessionLog
    window: object            # session.Window
    calls: list               # spans.Call, coding order
    trace: object | None      # trace.Trace
    launches: list            # spans.Launch
    t_switch: float | None = None

    def timed_calls(self) -> list:
        """The calls of the timed part of a traced window: those that
        filled stage `timings`."""
        return [c for c in self.calls if c.timings]

    def profiled(self) -> tuple:
        """(frames displayed, the part's start, the last of their display
        times, the calls inside) over the profiled part of the window
        (the whole window when it was not split)."""
        start = self.t_switch or self.log.t0
        t = {f: self.log.t_send[f] + self.window.latency[f]
             for f in self.window.frames}
        shown = [f for f in self.window.frames if t[f] > start]
        t_last = max((t[f] for f in shown), default=start)
        calls = [c for c in self.calls if start <= c.t0 and c.t1 <= t_last]
        return shown, start, t_last, calls

    def launches_of(self, metric: str) -> list:
        return [x.kept for x in self.launches if x.metric == metric]


def reader(name: str):
    """The reader module of per-layer metric `name`."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(log, win, setup_s: float) -> dict:
    """fps: the frames displayed by packets that arrived in the window
    over the time from its start to the last of those packets;
    kbit_per_frame: every packet bit that arrived in the window over
    those frames; setup_s."""
    n = len(win.frames)
    span = win.t_last - log.t0
    bits = sum(8 * len(log.packets[k].data) for k in win.packets)
    out = {"setup_s": setup_s}
    if n and span > 0:
        out["fps"] = n / span
        out["kbit_per_frame"] = bits / n / 1000
    return out
