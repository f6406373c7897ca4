"""Runs one cell of the port's benchmark once, on the machine it is
started on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration (an encoder
deployment, `portbench/configs/`) and a traffic mix (`portbench/traffic/`).
Set-up makes the content from the seed, opens a `rav1e_tpu_torch` Context
on cuda and codes the stream's first frames; the window then drives the
Context in a closed loop for `--seconds`. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics:
from the pipeline's stage timings over the first part of the window, and
from the profiler's trace and the harness's spans over the rest),
`device`, with
--trace 1 `breakdown`, and last `checks`, each number the reference
compared beside its limit. A run without CUDA, or with fewer devices
than the cell asks for, exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# a traced window: the stage timings (a synchronize at each stage) over
# the first share of it, then the profiler and the launch captures over
# the rest, so that neither perturbs what the other reads; the profiler
# stops, and reduces its trace, after the window has closed
TIMED = 0.4
FORBIDDEN = {"jax", "jaxlib", "flax", "rav1e_tpu"}


def _env():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc and g++ builds go to rav1e_tpu_torch/build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load,
    compared whole (`rav1e_tpu_torch` is not `rav1e_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        encoder_overrides: dict | None = None) -> dict:
    """One run of `cell` (a cells.Cell). Returns the result object."""
    import torch

    from portbench.harness.content import Content
    from portbench.harness.measure import RunData, end_to_end, reader
    from portbench.harness.session import Session, encoder_config, window_of
    from portbench.harness.spans import Spans
    from portbench.harness.trace import Trace, host_segments
    from portbench.reference.judge import judge

    cfg = cell.config
    enc = dict(cfg["encoder"], **(encoder_overrides or {}))
    readers = {m["name"]: reader(m["name"]) for m in cell.per_layer} \
        if trace else {}
    spans = Spans(traced=trace,
                  captures={n: r for n, r in readers.items()
                            if hasattr(r, "CAPTURE")})
    spans.install()
    content = Content(cell.traffic, enc["width"], enc["height"], seed,
                      device)
    ctx = encoder_config(cfg, encoder_overrides).new_context(device=device)
    sess = Session(ctx, content)
    sess.warm(int(cfg["warm_frames"]))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    tr = Trace(device) if trace else None
    t_switch = None
    if tr:
        def to_profiled():
            nonlocal t_switch
            spans.timed = False
            tr.start()
            spans.capture = True
            t_switch = time.perf_counter()

        spans.timed = True
        sess.window(seconds, switch=(TIMED * seconds, to_profiled))
        tr.stop()
        spans.capture = False
    else:
        sess.window(seconds)
    log = sess.log
    win = window_of(log, cell.traffic.shot_frames)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device == "cuda" else 0)}
    e2e = end_to_end(log, win, setup_s)
    kf = [log.packets[k].frameno for k in win.packets
          if log.packets[k].ftype == "KEY"]
    print(f"# window: {len(win.frames)} frames displayed in "
          f"{win.t_last - log.t0:.3f} s, {log.sent} sent in all; "
          f"{len(kf)} keyframes: {kf}", file=sys.stderr)
    out = {"correct": False, "attempted": len(win.frames), "failed": 0}
    if trace:
        data = RunData(log, win, spans.calls, tr, spans.launches, t_switch)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(),
                     "idle_gaps": tr.idle_by_host(host_segments(spans.calls))}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    spans.uninstall()
    calls = spans.calls
    del ctx, sess, tr
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    v = judge([(p.data, p.frameno) for p in log.packets], calls, content,
              log.sent, cfg["guarantees"], cell.limits, seed, win.packets)
    for note in v.notes:
        print(f"# {note}", file=sys.stderr)
    out.update(correct=bool(v.correct),
               failed=len(v.failed_frames & set(win.frames)),
               metrics=metrics, device=dev)
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": val, "limit": lim}
                     for n, (val, lim) in v.numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _env()
    from portbench.harness.cells import load_cell
    cell = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port may not",
              file=sys.stderr)
        return 4
    for n, c in out["checks"].items():
        print(f"check {n} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
