"""Finds a cell's pieces by the names in BENCHMARK.json: its configuration
(`BENCHMARK.json` configs[].file), its traffic mix
(`portbench/traffic/<traffic>.json`), its correctness limits
(`portbench/limits/<cell>.json`) and the metrics it reports."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from portbench.harness.content import Traffic

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: Traffic
    limits: dict          # number -> limit
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=Traffic.from_dict(traffic),
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])
