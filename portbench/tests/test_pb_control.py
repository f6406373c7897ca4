"""On the card, at each cell's own size, over three seeds: the control
and the planted fault that sets the fidelity limits' upper readings.

The control breaks the configuration's quantizer guarantee by one bit of
precision (quantizer 143, whose AC step is twice quantizer 100's: 224
against 112), everything else as the cell runs it, over a full window.
The faults, each over a 15-s window: the state left unchanged (the P and
B steps return their reference's planes as the frame's reconstruction),
and the deblocking filter or CDEF left out of the reconstructions while
the headers still signal what the port's search chose. Each run has to
come out not correct; the readings they print set the limits (PERF.md).
Run on the card:

    python -m pytest portbench/tests/test_pb_control.py -m cuda -q -s
"""

import json

import numpy as np
import pytest

import portbench.run as R
from portbench.harness.cells import ROOT, load_cell
from portbench.tests.test_pb_faults import skip_filter

CELLS = ["s6-1080p.pan", "s10-live-1080p.cuts"]
CONTROL = {"quantizer": 143}
SEEDS = [3_000_000_001, 3_000_000_002, 3_000_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name):
    R._env()
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    cell = load_cell(name)
    for seed in SEEDS:
        out = R.run(cell, seed, seconds, False, encoder_overrides=CONTROL)
        print(f"control {name} seed {seed}: " + json.dumps(out["checks"]))
        assert out["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_is_not_correct(cuda, name, monkeypatch):
    import rav1e_tpu_torch.pipeline.tpu_inter as ti
    R._env()
    for fn in ("encode_pframe_tpu", "encode_bframe_tpu"):
        orig = getattr(ti, fn)

        def unchanged(*a, _orig=orig, **kw):
            data, _ = _orig(*a, **kw)
            return data, [np.asarray(r, np.int32).copy() for r in a[1]]

        monkeypatch.setattr(ti, fn, unchanged)
    cell = load_cell(name)
    for seed in SEEDS:
        out = R.run(cell, seed, 15, False)
        print(f"state unchanged {name} seed {seed}: "
              + json.dumps(out["checks"]))
        assert out["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name,which", [("s6-1080p.pan", "deblock"),
                                        ("s6-1080p.pan", "cdef"),
                                        ("s10-live-1080p.cuts", "deblock")])
def test_a_skipped_loop_filter_is_not_correct(cuda, name, which,
                                              monkeypatch):
    R._env()
    skip_filter(monkeypatch, which)
    cell = load_cell(name)
    for seed in SEEDS:
        out = R.run(cell, seed, 15, False)
        print(f"skipped {which} {name} seed {seed}: "
              + json.dumps(out["checks"]))
        assert out["correct"] is False
        assert out["checks"]["decode_mismatch"]["value"] > 0
