"""Nothing a run imports is JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the port."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

RUN = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.run as R
from portbench.tests.tiny import tiny_cell
R._env()
R.run(tiny_cell("s6-1080p.pan"), 3, 1.0, True, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.judge, portbench.reference.stream
import portbench.reference.fidelity, portbench.reference.av1
import portbench.reference.decode
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code):
    res = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(RUN)
    assert "rav1e_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rav1e_tpu"}


def test_reference_imports_nothing_of_the_port():
    assert "rav1e_tpu_torch" not in _top_names(REF)
    for f in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] in {"__future__", "dataclasses",
                                           "math", "numpy", "pathlib",
                                           "portbench", "random",
                                           "time"}, (f, m)
                if m.startswith("portbench"):
                    assert m.startswith("portbench.reference"), (f, m)


def test_no_file_imports_jax_or_reads_the_jax_bench():
    """No source imports JAX or the JAX package, and no string in one
    names the JAX package's bench or tools."""
    pat = re.compile(r"(?<![\w/])(bench\.py|bench/|tools/)")
    for f in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                mods = []
                if isinstance(node, ast.Constant) and isinstance(
                        node.value, str) and f.name != Path(__file__).name:
                    assert not pat.search(node.value), (f, node.value)
            for m in mods:
                assert m.split(".")[0] not in {"jax", "jaxlib", "flax",
                                               "rav1e_tpu"}, (f, m)
