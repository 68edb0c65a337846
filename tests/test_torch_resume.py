"""The port's step checkpoints and resume (`checkpoint_backend="orbax"`):
the ports of the JAX package's `tests/test_checkpoint_orbax.py` (round
trip, retention, an empty restore, a resume that runs no finished epoch),
and a run interrupted after an epoch and resumed, bit-equal on the CPU to
the same run without a break (losses, params, norm statistics, optimizer
state): an NNUE on the light tier (the fused K3 path) and on the medium
tier (device noise), a QAT NNUE resumed at and past its warm-up switch,
and an engine_friendly EtinyNet resumed past its switch. A resumed run
keeps a better best model.

The JAX package's resumed run re-seeds its key and restarts its loader's
epoch counter, so it replays epoch 0's shuffle and augmentation draws; the
port's step carries the generators and the loader's epoch, which these
tests hold it to.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from config import load_config
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training.checkpoint import StepCheckpointer, load_checkpoint
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import make_train_state

REPO = Path(__file__).resolve().parent.parent
CFG = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 4), l1_size=16,
                       l2_size=8, l3_size=4, num_classes=3, input_size=16)


class OptCfg:
    learning_rate = 0.01
    weight_decay = 0.0
    momentum = 0.9
    optimizer_type = "sgd"
    max_grad_norm = 1.0
    use_cosine_scheduler = False
    max_epochs = 1
    decay_lr = False
    use_cyclical_lr = False


def _state(seed):
    model = tnnue.nnue_init(CFG, torch.Generator().manual_seed(seed), device="cpu")
    state = make_train_state(model, create_optimizer(OptCfg()))
    state.opt_state["count"] = 5
    for t in state.opt_state["trace"].values():
        t.normal_(generator=torch.Generator().manual_seed(seed))
    return model, state


def test_roundtrip_preserves_structure(tmp_path):
    model, state = _state(0)
    ck = StepCheckpointer(tmp_path / "orbax", max_to_keep=2)
    ck.save(0, {"model": model.state_dict(), "opt_state": state.opt_state},
            metadata={"model_type": "nnue", "epoch": 0, "val_f1": 0.5})
    restored, meta = ck.restore()
    assert meta == {"model_type": "nnue", "epoch": 0, "val_f1": 0.5}
    for k, v in model.state_dict().items():
        assert torch.equal(restored["model"][k], v), k
    opt = restored["opt_state"]
    assert set(opt) == set(state.opt_state) and opt["count"] == 5
    assert set(opt["trace"]) == set(state.opt_state["trace"])
    for k, v in state.opt_state["trace"].items():
        assert torch.equal(opt["trace"][k], v), k
    assert not list(tmp_path.glob("orbax/.*"))  # the temporary name is gone


def test_retention_and_latest(tmp_path):
    model, _ = _state(1)
    ck = StepCheckpointer(tmp_path / "orbax", max_to_keep=2)
    for step in range(4):
        ck.save(step, {"model": model.state_dict()}, metadata={"epoch": step})
    assert ck.latest_step() == 3
    assert ck.all_steps() == [2, 3]  # retention enforced
    assert ck.restore()[1] == {"epoch": 3}


def test_restore_empty_raises(tmp_path):
    ck = StepCheckpointer(tmp_path / "orbax")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()


def _cfg(tmp_path, name="train_nnue_test.py", **kw):
    cfg = load_config(str(REPO / "config" / name))
    cfg.log_dir = str(tmp_path / "logs")
    cfg.checkpoint_backend = "orbax"
    cfg.orbax_dir = str(tmp_path / "orbax")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_train_model_orbax_backend_and_resume(tmp_path, monkeypatch, capsys):
    """Two epochs with the step backend, then resume=True: the run restores
    epoch 1 and trains no further step."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    cfg = _cfg(tmp_path, max_epochs=2)
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    ck = StepCheckpointer(tmp_path / "orbax")
    assert ck.all_steps() == [0, 1]
    assert "step checkpoint 1 written in" in capsys.readouterr().out

    calls = []
    monkeypatch.setattr(tloop, "gathered_train_step",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tloop, "scanned_train_steps",
                        lambda *a, **k: calls.append(1))
    cfg.resume = True
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    assert calls == [], "resume re-ran finished epochs"
    assert "resumed from step checkpoint 1 → epoch 2" in capsys.readouterr().out


def test_default_step_directory_is_under_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    cfg = _cfg(tmp_path)
    del cfg.orbax_dir
    cfg.orbax_max_to_keep = 1
    assert tloop.train_model(cfg, "nnue", "myrun", device="cpu") == 0
    assert StepCheckpointer(tmp_path / "logs" / "orbax" / "myrun").all_steps() == [0]


class _Stop(Exception):
    pass


def _run(cfg, run_id, monkeypatch, stop_after=None, model_type="nnue"):
    """train_model; with `stop_after`, the process 'dies' right after that
    epoch's step checkpoint is written."""
    real = StepCheckpointer.save

    def save(self, step, state, metadata=None):
        real(self, step, state, metadata)
        if step == stop_after:
            raise _Stop

    monkeypatch.setattr(StepCheckpointer, "save", save)
    try:
        tloop.train_model(cfg, model_type, run_id, device="cpu")
    except _Stop:
        assert stop_after is not None
    monkeypatch.setattr(StepCheckpointer, "save", real)


def _losses(tmp_path, run_id):
    path = tmp_path / "logs" / "runs" / run_id / "metrics.jsonl"
    return [(r["step"], r["train/loss"]) for r in map(json.loads, path.read_text(
        ).splitlines()) if "train/loss" in r]


def _final_state(tmp_path, tag):
    ck = StepCheckpointer(tmp_path / tag)
    return ck.restore()


CASES = {
    "nnue-light-fused": dict(use_augmentation=True, steps_per_dispatch=2,
                             max_epochs=2, stop=0),
    "nnue-medium": dict(use_augmentation=True, augmentation_strength="medium",
                        max_epochs=2, stop=0),
    "nnue-qat-at-switch": dict(use_augmentation=True, qat=True, ef_warmup_epochs=1,
                               use_cosine_scheduler=True, max_epochs=2, stop=0),
    "nnue-qat-past-switch": dict(use_augmentation=True, qat=True, ef_warmup_epochs=1,
                                 use_cosine_scheduler=True, max_epochs=3, stop=1),
    "etinynet-ef-past-switch": dict(config="train_etinynet_test.py",
                                    use_augmentation=True, engine_friendly=True,
                                    ef_warmup_epochs=1, max_epochs=3, stop=1),
}


@pytest.mark.parametrize("case", CASES)
def test_resumed_run_equals_an_unbroken_one(tmp_path, monkeypatch, case):
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    kw = dict(CASES[case])
    stop = kw.pop("stop")
    name = kw.pop("config", "train_nnue_test.py")
    model_type = "etinynet" if "etinynet" in name else "nnue"
    whole = _cfg(tmp_path, name, orbax_dir=str(tmp_path / "whole"), **kw)
    _run(whole, "whole", monkeypatch, model_type=model_type)
    broken = _cfg(tmp_path, name, orbax_dir=str(tmp_path / "broken"), **kw)
    _run(broken, "broken", monkeypatch, stop_after=stop, model_type=model_type)
    assert StepCheckpointer(tmp_path / "broken").latest_step() == stop
    broken.resume = True
    _run(broken, "broken", monkeypatch, model_type=model_type)

    assert _losses(tmp_path, "broken") == _losses(tmp_path, "whole")
    (a, ma), (b, mb) = _final_state(tmp_path, "whole"), _final_state(tmp_path, "broken")
    assert ma["epoch"] == mb["epoch"] == kw["max_epochs"] - 1
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    assert a["opt_state"]["count"] == b["opt_state"]["count"] > 0
    for key in set(a["opt_state"]) - {"count"}:
        for n, v in a["opt_state"][key].items():
            assert torch.equal(b["opt_state"][key][n], v), (key, n)
    assert torch.equal(a["host_generator"], b["host_generator"])
    assert a["loader_epoch"] == b["loader_epoch"] == kw["max_epochs"]
    if kw.get("augmentation_strength") == "medium":
        assert torch.equal(a["noise_generator"], b["noise_generator"])


def test_resume_keeps_a_better_best(tmp_path, monkeypatch):
    """Epoch 0 is the best (val F1 0.6); the run stops after epoch 1 (0.4);
    the resumed epoch 2 (0.5) beats the last epoch but not the best, so the
    best model stays epoch 0's."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    val_f1 = iter([0.3, 0.6, 0.3, 0.4, 0.3, 0.5, 0.3])  # (train, val) per epoch
    monkeypatch.setattr(tloop, "evaluate_model", lambda *a, **k: (
        1.0, {"f1": next(val_f1), "acc": 0.5}))
    cfg = _cfg(tmp_path, max_epochs=3)
    _run(cfg, "run", monkeypatch, stop_after=1)
    best = tmp_path / "logs" / "checkpoints" / "run" / "best_model.ckpt"
    assert load_checkpoint(best)["epoch"] == 0
    assert StepCheckpointer(tmp_path / "orbax").restore()[1]["best_val_f1"] == 0.6
    cfg.resume = True
    _run(cfg, "run", monkeypatch)
    assert load_checkpoint(best)["epoch"] == 0
    meta = StepCheckpointer(tmp_path / "orbax").restore()[1]
    assert meta["epoch"] == 2 and meta["best_val_f1"] == 0.6
