"""Nothing a run of the benchmark loads is JAX or the JAX package: a tiny
CPU run of each cell in a process of its own, then the top-level names
(before the first dot, compared whole: the port's name begins with the
JAX package's) of every module loaded; and no file of the harness imports
the root `bench.py`, the root `benchmarks/` or the port's own bench."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from perfbench.tests.tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "nnue_vision_tpu"}

SCRIPT = """
import json, sys, tempfile
from pathlib import Path
import torch
from perfbench import run, spec
from perfbench.tests.tiny import make_root
root = make_root(Path(tempfile.mkdtemp()))
line = run.execute(spec.load_cell(root, sys.argv[1]), 7, 0.2, False,
                   torch.device("cpu"), lambda m: None)
print(json.dumps({"correct": line["correct"],
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


@pytest.mark.parametrize("name", CELLS)
def test_run_loads_no_jax(name):
    out = subprocess.run([sys.executable, "-c", SCRIPT, name], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert "nnue_vision_tpu_torch" in res["tops"]
    assert not FORBIDDEN & set(res["tops"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_harness_imports_no_other_bench():
    for path in (REPO / "perfbench").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN | {"bench", "benchmarks"}, (path, mod)
            assert mod != "nnue_vision_tpu_torch.bench", path
            assert not mod.startswith("nnue_vision_tpu_torch.benchmarks"), path


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in {"__future__", "typing", "math", "numpy",
                                         "torch", "perfbench"}, (path, mod)
            if mod.startswith("perfbench"):
                assert mod.startswith("perfbench.reference"), (path, mod)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "nnue_vision_tpu_torch_x", sys)
    assert "nnue_vision_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()
