"""The harness's spans around the pipeline entries the Context calls, and,
in a traced run, the inputs of each launch of the kernels whose roofline
shares it reports.

The Context imports each pipeline entry from its module inside the method
that calls it, so replacing the module's attribute puts the wrapper on
the session's path. Each call is logged in coding order with its kind,
its host times, its packet and recon (what the reference judges), and,
while `timed` is set (the first part of a traced window, before the
profiler starts), the `timings` it was asked to fill (stage wall times,
each after a synchronize). A per-layer metric's reader that names a
kernel launcher in its `CAPTURE` = (module, function) has its
`keep(args, kwargs, out)` called on each launch while `capture` is set
(the profiled part), and reads what it kept. Nothing is changed in what
the calls compute.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import sys
import time
from dataclasses import dataclass, field

# kind -> (module, function): the entries the cells' Context routes a
# frame to. A frame coded by any other entry has no call, and the judge
# counts the packet without one as a fault.
ENTRIES = {
    "keyframe": ("rav1e_tpu_torch.pipeline.tpu_intra", "encode_keyframe_tpu"),
    "pframe": ("rav1e_tpu_torch.pipeline.tpu_inter", "encode_pframe_tpu"),
    "bframe": ("rav1e_tpu_torch.pipeline.tpu_inter", "encode_bframe_tpu"),
}

@dataclass
class Call:
    kind: str
    t0: float                 # perf_counter at entry
    t1: float                 # perf_counter at return
    t0_ns: int                # time_ns at entry (the profiler's clock)
    data: bytes
    rec: list
    timings: dict | None


@dataclass
class Launch:
    metric: str
    t_ns: int
    kept: object              # what the metric's `keep` took of the launch


@dataclass
class Spans:
    calls: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    traced: bool = False
    captures: dict = field(default_factory=dict)  # metric -> reader module
    capture: bool = False     # keep kernel inputs (the profiled part)
    timed: bool = False       # ask each call for `timings` (the timed part)
    _undo: list = field(default_factory=list)

    def _wrap_entry(self, kind, fn):
        takes_timings = "timings" in inspect.signature(fn).parameters

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tm = None
            if self.timed and takes_timings and kw.get("timings") is None:
                tm = kw["timings"] = {}
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            data, rec = fn(*a, **kw)
            self.calls.append(Call(kind, t0, time.perf_counter(), t0_ns,
                                   bytes(data), rec, tm))
            return data, rec

        return wrapper

    def _wrap_kernel(self, metric, fn, keep):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            if self.capture:
                kept = keep(a, kw, out)
                if kept is not None:
                    self.launches.append(Launch(metric, time.time_ns(), kept))
            return out

        return wrapper

    def install(self):
        """Put the wrappers on the session's path (every module of the
        port that holds the original under any name): one on each
        pipeline entry and, traced, one on the launcher each capturing
        per-layer metric names in its CAPTURE."""
        todo = [(mod, name, functools.partial(self._wrap_entry, kind))
                for kind, (mod, name) in ENTRIES.items()]
        if self.traced:
            for metric, rd in self.captures.items():
                mod, name = rd.CAPTURE
                todo.append((mod, name, lambda fn, m=metric, k=rd.keep:
                             self._wrap_kernel(m, fn, k)))
        for mod, name, wrap in todo:
            orig = getattr(importlib.import_module(mod), name)
            new = wrap(orig)
            for m in list(sys.modules.values()):
                if not getattr(m, "__name__", "").startswith(
                        "rav1e_tpu_torch"):
                    continue
                for attr, val in list(vars(m).items()):
                    if val is orig:
                        setattr(m, attr, new)
                        self._undo.append((m, attr, orig))

    def uninstall(self):
        for m, attr, orig in reversed(self._undo):
            setattr(m, attr, orig)
        self._undo.clear()
