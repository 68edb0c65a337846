"""The readers of the program's spans, counters and gauges
(`perfbench/program_spans.py` and the metrics that use it) on the CPU at
tiny sizes: in a traced run each reads a number where the CPU records
what it reads (the draws, the serving wrappers) and nothing where it
cannot (no chunk graph, no replay); the host draw calls are exact; and a
program without the tracing module gives nothing, without raising."""

from __future__ import annotations

import sys

import pytest
import torch

from perfbench import run, spec
from perfbench.tests.tiny import RECIPE, REPO, make_root

SEED = 2**31 + 777
CPU = torch.device("cpu")
TRAIN = ("draws_host_ms_per_step", "replay_host_ms_per_step",
         "host_draw_calls_per_step", "input_nodes_per_step",
         "model_nodes_per_step", "update_nodes_per_step")
SERVE = ("serve_kernel_host_ms_per_call", "serve_plain_host_ms_per_call")
# host generator calls a step, by cell (the fused chunk draws 8 a chunk)
CALLS = {"etiny_train_heavy": 70, "etiny_train_medium": 39,
         "etiny_train_none": 0,
         "nnue_train_light": 8 / RECIPE["nnue_hard"]["steps_per_dispatch"]}
ON_CPU = {"draws_host_ms_per_step", "host_draw_calls_per_step",
          "serve_kernel_host_ms_per_call", "serve_plain_host_ms_per_call"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _listed(cell):
    return {m["name"] for m in cell.per_layer} & set(TRAIN + SERVE)


@pytest.mark.parametrize("name", list(CALLS) + ["nnue_serve_b8192",
                                                "etiny_serve_b8192"])
def test_span_readers_in_a_traced_run(root, name):
    cell = spec.load_cell(root, name)
    line = run.execute(cell, SEED, 0.2, True, CPU, lambda _msg: None)
    assert line["correct"]
    listed = _listed(cell)
    assert listed == set(TRAIN if name in CALLS else SERVE[:1] if
                         name.startswith("nnue") else SERVE)
    got = {k: v["value"] for k, v in line["metrics"].items() if k in listed}
    assert set(got) == listed & ON_CPU
    assert all(v >= 0 for v in got.values())
    if name in CALLS:
        assert got["host_draw_calls_per_step"] == pytest.approx(CALLS[name])
        if name == "etiny_train_none":
            assert got["draws_host_ms_per_step"] < 0.1 * line["metrics"][
                "dispatch_host_ms_per_step"]["value"]


def _ctx(graph=None):
    return {"trace": {"steps": 8, "calls": 4}, "graph": graph}


def test_phase_readers_divide_the_gauge_by_the_graphs_steps(monkeypatch):
    from nnue_vision_tpu_torch import tracing
    monkeypatch.setitem(tracing.GAUGES, "chunk_graph_nodes",
                        {"input": 16, "model": 800, "update": 400, "tail": 2})
    graph = {"nodes": 1218, "steps": 8}
    read = {p: spec.metric_reader(REPO, f"{p}_nodes_per_step").read
            for p in ("input", "model", "update")}
    assert {p: r(_ctx(graph)) for p, r in read.items()} == {
        "input": 2.0, "model": 100.0, "update": 50.0}
    assert all(r(_ctx(None)) is None for r in read.values())


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    """The parent of the tracing module: every reader returns None."""
    import nnue_vision_tpu_torch
    monkeypatch.delattr(nnue_vision_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "nnue_vision_tpu_torch.tracing", None)
    for name in TRAIN + SERVE:
        assert spec.metric_reader(REPO, name).read(
            _ctx({"nodes": 10, "steps": 2})) is None, name
