"""The port's one recorder of where a call's time goes: stage times and
spans, from the same two clock reads.

- `timings`: a pipeline call handed a dict fills it through
  `stages(dev, timings)`: each `mark(name)` first synchronizes the current
  stream of `dev` (the stage's device work done) and stores the time since
  the previous mark, in seconds, under `name`.
- spans: while tracing is enabled (`enable()`), each stage, `span(name)`
  and `frame(frameno, kind)` also records a `Span` (name, frame, kind,
  tid, t0_ns, t1_ns, n) into a bounded process-wide buffer (`spans()`,
  the newest CAPACITY kept). Times are `time.time_ns()`, the clock of
  torch.profiler's device events, so spans and the device's activity
  share one time line. A mark adds no synchronize unless `timings` was
  passed: the spans show the pipeline as it runs.

`frame` and `kind` are those of the innermost `frame(...)` open in the
recording thread's context (a `contextvars` variable; -1 and "" outside
one): the Context's input frame number and the route it took. A worker
thread gets them by running a function wrapped by `carry`.

With tracing off, `stages(dev, None)`, `span`, `frame` and `carry` cost
one test of the module flag and hand back shared no-op objects (or the
function itself): no clock read, no allocation, no lock.

`idle_under(spans, busy, t0_ns, t1_ns)` puts the device's idle gaps down
to the span open at each gap's middle, by span path (`paths`).
"""

from __future__ import annotations

import contextvars
import heapq
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import NamedTuple

import torch

CAPACITY = 1 << 18          # spans kept, the newest: about 50 MB at most


class Span(NamedTuple):
    name: str
    frame: int              # the Context's input frame number, or -1
    kind: str               # the route's frame kind, or ""
    tid: int                # threading.get_ident() of the recording thread
    t0_ns: int
    t1_ns: int
    n: int | None           # a work count: IR rows, diagonals, tiles


_on = False
_lock = threading.Lock()
_buf: deque = deque(maxlen=CAPACITY)
_frame = contextvars.ContextVar("rav1e_tpu_torch_trace_frame",
                                default=(-1, ""))


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def clear():
    with _lock:
        _buf.clear()


def spans() -> list:
    """The recorded spans, in the order they ended."""
    with _lock:
        return list(_buf)


def _record(name: str, t0: int, t1: int, n: int | None = None):
    fr, kind = _frame.get()
    s = Span(name, fr, kind, threading.get_ident(), t0, t1, n)
    with _lock:
        _buf.append(s)


class _Off:
    """The recorder, span and frame of a call with tracing off and no
    `timings`: each does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, name: str, n: int | None = None):
        pass

    def span(self, name: str, n: int | None = None):
        return self


OFF = _Off()
nomark = OFF.mark           # the step functions' default `mark`


class Stages:
    """A pipeline call's stages, each from the previous mark (or the
    recorder's start) to its own mark. With `out` (a timings dict) each
    mark synchronizes `dev`'s current stream (the stream of the thread
    that runs the stage) first and stores the stage's seconds under its
    name; with tracing on it records the stage as a span of the same two
    clock reads."""

    def __init__(self, dev: torch.device | str, out: dict | None):
        self.dev, self.out = torch.device(dev), out
        self.t = time.time_ns()

    def _close(self, name: str, t0: int, n: int | None):
        if self.out is not None and self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()
        t1 = time.time_ns()
        if self.out is not None:
            self.out[name] = (t1 - t0) / 1e9
        if _on:
            _record(name, t0, t1, n)
        self.t = t1

    def mark(self, name: str, n: int | None = None):
        """Close stage `name` (n: its work count, where it has one)."""
        self._close(name, self.t, n)

    @contextmanager
    def span(self, name: str, n: int | None = None):
        """Stage `name`, from the previous mark to the end of the body;
        marks inside the body close stages inside it."""
        t0 = self.t
        yield
        self._close(name, t0, n)


def stages(dev: torch.device | str, out: dict | None):
    """The recorder of a call's stages: a `Stages`, or `OFF` when there
    is nothing to record (no timings asked for, tracing off)."""
    if out is None and not _on:
        return OFF
    return Stages(dev, out)


class _Span:
    __slots__ = ("name", "n", "t0")

    def __init__(self, name: str, n: int | None):
        self.name, self.n = name, n

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _record(self.name, self.t0, time.time_ns(), self.n)
        return False


def span(name: str, n: int | None = None):
    """A span around the body of a `with` (tracing on), else `OFF`."""
    if not _on:
        return OFF
    return _Span(name, n)


class _Frame:
    __slots__ = ("frameno", "kind", "t0", "token")

    def __init__(self, frameno: int, kind: str):
        self.frameno, self.kind = frameno, kind

    def __enter__(self):
        self.token = _frame.set((self.frameno, self.kind))
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        try:
            _record("frame", self.t0, time.time_ns())
        finally:
            _frame.reset(self.token)
        return False


def frame(frameno: int, kind: str):
    """The pipeline call that codes input frame `frameno` as `kind`: the
    spans recorded inside carry both, and it records a `frame` span."""
    if not _on:
        return OFF
    return _Frame(frameno, kind)


def carry(fn):
    """`fn`, run under the caller's frame wherever it runs (a worker
    thread's spans then keep their frame)."""
    if not _on:
        return fn
    cur = _frame.get()

    def run(*a, **kw):
        token = _frame.set(cur)
        try:
            return fn(*a, **kw)
        finally:
            _frame.reset(token)

    return run


# ---- analysis ---------------------------------------------------------------

def paths(spans: list) -> list:
    """Each span's path: the names of the spans that enclose it on its
    own thread, outermost first, from the innermost `frame` span (written
    as its kind: "bframe/ec_kernel/ir_upload"); a span of a worker thread
    that carries a frame but has no frame span around it starts with the
    kind ("pframe/fetch_unpack"); outside any frame, from the thread's
    outermost span ("receive_packet/host32")."""
    parent = [-1] * len(spans)
    by_tid = defaultdict(list)
    for i, s in enumerate(spans):
        by_tid[s.tid].append(i)
    for idx in by_tid.values():
        # outer before inner: by start, then the later end, then the later
        # record (a span is recorded after those inside it)
        idx.sort(key=lambda i: (spans[i].t0_ns, -spans[i].t1_ns, -i))
        stack: list = []
        for i in idx:
            while stack and spans[stack[-1]].t1_ns < spans[i].t1_ns:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
    out = []
    for i, s in enumerate(spans):
        names, j = [], i
        while j >= 0:
            if spans[j].name == "frame":
                names.append(spans[j].kind)
                break
            names.append(spans[j].name)
            j = parent[j]
        else:
            if s.kind:
                names.append(s.kind)
        out.append("/".join(reversed(names)))
    return out


def idle_under(spans: list, busy, t0_ns: int, t1_ns: int) -> dict:
    """The device's idle seconds in [t0_ns, t1_ns] by span path: `busy`
    holds the device's busy intervals (start_ns, end_ns), in any order and
    overlapping; each gap between them is put down to the innermost span
    open at the gap's middle (of the spans open there, on any thread, the
    one that started last), under its path (`paths`), or to "outside"."""
    cur, gaps = t0_ns, []
    for s, e in sorted((max(int(s), t0_ns), min(int(e), t1_ns))
                       for s, e in busy):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1_ns:
        gaps.append((cur, t1_ns))
    order = sorted(range(len(spans)), key=lambda i: spans[i].t0_ns)
    names = None
    heap: list = []
    out: dict = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(order) and spans[order[j]].t0_ns <= mid:
            i = order[j]
            heapq.heappush(heap, (-spans[i].t0_ns, spans[i].t1_ns, i))
            j += 1
        while heap and heap[0][1] <= mid:     # ended: never open again
            heapq.heappop(heap)
        if heap:
            if names is None:
                names = paths(spans)
            key = names[heap[0][2]]
        else:
            key = "outside"
        out[key] += (g1 - g0) / 1e9
    return dict(out)
