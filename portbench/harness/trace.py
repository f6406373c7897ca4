"""The profiled part of a traced window: torch.profiler's device activity
(kernels, copies, sets), reduced to the busy time, the idle share, the
device time by kernel name, and the idle gaps by what the host was doing
(the harness's spans: the pipeline call of each kind, or the session
between them). Kineto's timestamps are the host's wall clock in ns, the
clock the spans record with time.time_ns()."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

class Trace:
    def __init__(self, device: str = "cuda"):
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.events = []          # (name, start_ns, end_ns) on the device

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device == "cuda"
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.events = _device_events(self.prof)
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def intervals(self) -> np.ndarray:
        """The union of the device's busy intervals in the window, [n, 2]
        ns, sorted and disjoint."""
        if not self.events:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, e) for _, s, e in self.events], np.int64)
        iv = np.clip(iv, self.t0_ns, self.t1_ns)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        s, run_end = iv[:, 0], np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, len(s) - 1)
        return np.stack([s[first], run_end[last]], 1)

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def kernel_seconds(self, names) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of `names`."""
        t = n = 0
        for name, s, e in self.events:
            if any(k in name for k in names):
                t += e - s
                n += 1
        return t / 1e9, n

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(int)
        for name, s, e in self.events:
            tot[name[:120]] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def idle_by_host(self, segments, k: int = 10) -> list:
        """Idle seconds of the device by what the host was doing at each
        gap's middle; segments: disjoint [(start_ns, end_ns, label)]
        (host_segments), "session" outside them."""
        iv = self.intervals()
        edges = np.concatenate([[self.t0_ns], iv.ravel(), [self.t1_ns]])
        gs, ge = edges[0::2], edges[1::2]
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        mid = (gs + ge) // 2
        segments = sorted(segments)
        labels = ["session"] + sorted({lab for _, _, lab in segments})
        code = {lab: i for i, lab in enumerate(labels)}
        st = np.array([s for s, _, _ in segments], np.int64)
        en = np.array([e for _, e, _ in segments], np.int64)
        lab = np.array([code[x] for _, _, x in segments], np.int64)
        j = np.searchsorted(st, mid, side="right") - 1
        inside = (j >= 0) & (mid < en[np.maximum(j, 0)])
        which = np.where(inside, lab[np.maximum(j, 0)], 0)
        tot = np.bincount(which, weights=(ge - gs).astype(np.float64),
                          minlength=len(labels))
        top = np.argsort(-tot)[:k]
        return [[labels[i], float(tot[i]) / 1e9] for i in top if tot[i] > 0]


def _device_events(prof) -> list:
    """(name, start_ns, end_ns) of each device activity the profiler
    recorded."""
    out = []
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        for e in res.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out
    for e in prof.events():           # older profilers: FunctionEvents
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            s = int(e.time_range.start * 1e3)
            out.append((e.name, s, int(e.time_range.end * 1e3)))
    return out


def host_segments(calls) -> list:
    """Disjoint [(start_ns, end_ns, label)]: each pipeline call, labelled
    by its kind."""
    return [(c.t0_ns, c.t0_ns + int((c.t1 - c.t0) * 1e9), c.kind)
            for c in calls]
