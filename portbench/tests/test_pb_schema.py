"""The last line's schema, and the refusal to run without a card."""

import json

import pytest

import portbench.run as R
from portbench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert R.main(["--workload", "s6-1080p.pan", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace):
    cell = tiny_cell("s10-live-1080p.cuts")
    out = json.loads(json.dumps(R.run(cell, 2**32 + 5, 6.0, bool(trace),
                                      device="cpu")))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = [m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)]
    assert set(out["metrics"]) <= set(names)
    for m in out["metrics"].values():
        assert list(m) == ["value", "unit"] and isinstance(m["value"], float)
    if not trace:
        assert set(out["metrics"]) == {"fps", "kbit_per_frame", "setup_s"}
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert list(c) == ["value", "limit"]
