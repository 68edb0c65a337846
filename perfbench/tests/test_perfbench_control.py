"""The control of each cell fails its check on the card: the reference in
the next lower precision than the configuration states, standing in the
program's place (float32 → TF32, bfloat16 → float8 operands, int8 → int4
weights), at a size a test run holds. On the CPU TF32 does not exist, so
these run on the card only:

    python -m pytest -m gpu perfbench/tests/test_perfbench_control.py
"""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import readings, spec
from perfbench.tests.tiny import REPO, make_root

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control's precisions are the card's (no CUDA card here)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tmp_path, card, name):
    cell = spec.load_cell(make_root(tmp_path), name)
    for seed in (1, 2, 2**31 + 3):
        r = readings.readings(cell, seed, 0.2, card)
        assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
        assert any(v > cell.limits[k] for k, v in r["low"].items()), r
