"""The port's evaluation CLI (`nnue_vision_tpu_torch/evaluate.py`) held to
the repository's root `evaluate.py` (the JAX package's, run on the CPU) on
one tiny checkpoint and synthetic split: every printed `int8-sim` metric
but `ms_per_sample` identical, the `float:` metrics at the NNUE bar (the
loss to atol 1e-4 / rtol 1e-5 in process, one printed digit on the line),
an EtinyNet checkpoint too, and the `engine:` line equal to `int8-sim`."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import loaders as jloaders
from nnue_vision_tpu.training import evaluate as jeval
from nnue_vision_tpu_torch import evaluate as teval
from nnue_vision_tpu_torch import serialize as tser
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.data import loaders as tloaders
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from nnue_vision_tpu_torch.training import evaluate as tevaluate
from tests.test_torch_serialize import _nnue_params, _port_etiny_ckpt

REPO = Path(__file__).resolve().parent.parent
SPLIT = ["--dataset", "synthetic-hard", "--synthetic_size", "96",
         "--batch_size", "16", "--seed", "3"]
CFG = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 6), l1_size=16,
                       l2_size=8, l3_size=4, num_classes=10, input_size=32)


@pytest.fixture(autouse=True)
def _no_download(monkeypatch, tmp_path):
    monkeypatch.setenv("NV_NO_DOWNLOAD", "1")
    monkeypatch.setenv("NV_DATA_DIR", str(tmp_path / "empty"))


def _root_module(name):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


def _nnue_ckpt(path, qat):
    import dataclasses

    cfg = dataclasses.replace(CFG, qat=qat)
    p = _nnue_params(11)
    p["out_w"] = np.random.default_rng(12).uniform(-0.5, 0.5, (10, 4)).astype(np.float32)
    p["out_b"] = np.zeros(10, np.float32)
    model = nnue_from_jax_params(p, cfg, device="cpu")
    tckpt.save_checkpoint(path, model_type="nnue", model_config=cfg, model=model,
                          epoch=0, metrics={})
    return path


def _lines(out):
    """{"float": {name: text}, "int8-sim": ..., "engine": ...} of a CLI's
    printed lines."""
    parsed = {}
    for line in out.splitlines():
        tag, _, rest = line.partition(": ")
        if tag in ("float", "int8-sim", "engine"):
            parsed[tag] = dict(kv.split("=") for kv in rest.split())
    return parsed


def _run_both(capsys, monkeypatch, ckpt, *extra):
    assert teval.main([str(ckpt), *SPLIT, *extra, "--device", "cpu"]) == 0
    ours = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", str(ckpt), *SPLIT])
    assert _root_module("evaluate").main() == 0
    theirs = _lines(capsys.readouterr().out)
    return ours, theirs


def _same_lines(ours, theirs, float_digits=1e-4):
    sim_o, sim_t = ours["int8-sim"], theirs["int8-sim"]
    assert set(sim_o) == set(sim_t)
    for k in sim_t:
        if k != "ms_per_sample":
            assert sim_o[k] == sim_t[k], (k, sim_o, sim_t)
    assert set(ours["float"]) == set(theirs["float"])
    for k, v in theirs["float"].items():  # one printed digit of slack
        assert abs(float(ours["float"][k]) - float(v)) <= float_digits * 1.01, k


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_nnue_cli_lines_match_root(tmp_path, capsys, monkeypatch, qat):
    ours, theirs = _run_both(capsys, monkeypatch,
                             _nnue_ckpt(tmp_path / "best_model.ckpt", qat))
    _same_lines(ours, theirs)
    assert "engine" not in ours


def test_etinynet_cli_lines_match_root(tmp_path, capsys, monkeypatch):
    ckpt = _port_etiny_ckpt(tmp_path / "best_model.ckpt", engine_friendly=True,
                            seed=13)
    ours, theirs = _run_both(capsys, monkeypatch, ckpt)
    _same_lines(ours, theirs)
    assert ours["int8-sim"]["latent_density"] == "0.0000"


def test_nnue_float_eval_at_the_bar(tmp_path):
    """In process, unprinted: the float loss at the NNUE bar and the
    classification metrics equal, on the model each CLI loads."""
    ckpt = _nnue_ckpt(tmp_path / "best_model.ckpt", qat=True)
    _, model, _ = tser.load_checkpoint_auto(ckpt, device="cpu")
    mtype, params, stats, jcfg = _root_module("serialize").load_checkpoint_auto(ckpt)
    kw = dict(dataset_name="synthetic-hard", batch_size=16, use_augmentation=False,
              seed=3, synthetic_size=96)
    tl, tm = tevaluate.evaluate_model(model, tloaders.create_data_loaders(**kw)[2])
    jl, jm = jeval.evaluate_model(params, stats, jloaders.create_data_loaders(**kw)[2],
                                  model_type=mtype, model_cfg=jcfg)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-5)
    assert tm == jm


def test_engine_line_equals_int8_sim(tmp_path, capsys):
    ckpt = _nnue_ckpt(tmp_path / "best_model.ckpt", qat=True)
    assert teval.main([str(ckpt), *SPLIT, "--compiled", "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    for k in ("acc", "f1", "precision", "recall"):
        assert lines["engine"][k] == lines["int8-sim"][k], k


def test_reexports_the_evaluation_api():
    for name in ("evaluate_compiled_model", "evaluate_int8_sim", "evaluate_model",
                 "evaluate_model_comprehensive"):
        assert getattr(teval, name) is getattr(tevaluate, name)
    assert teval.compute_metrics(torch.eye(3).numpy(), np.arange(3))["acc"] == 1.0
