"""The port's `train_model` and CLI run end to end on the CPU at the test
config's size, and what they write is what the JAX package's tools read:
`serialize.py` loads the port's best-model checkpoint and writes the same
`.nnue` bytes as the port's own quantizer."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from config import load_config
from nnue_vision_tpu import formats
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.models.nnue import nnue_quantize
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import step as tstep
from nnue_vision_tpu_torch.training.checkpoint import (
    load_checkpoint,
    nnue_from_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
TEST_CONFIG = str(REPO / "config" / "train_nnue_test.py")


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config(TEST_CONFIG)
    cfg.log_dir = str(tmp_path / "logs")
    return cfg, tmp_path


def _records(tmp_path):
    metrics = next((tmp_path / "logs" / "runs").rglob("metrics.jsonl"))
    return [json.loads(line) for line in metrics.read_text().splitlines()]


def _best(tmp_path):
    return next((tmp_path / "logs" / "checkpoints").rglob("best_model.ckpt"))


@pytest.mark.parametrize("fused", [False, True], ids=["as-is", "fused-light"])
def test_train_model_runs(env, monkeypatch, capsys, fused):
    cfg, tmp_path = env
    calls = []
    if fused:
        cfg.use_augmentation = True
        cfg.steps_per_dispatch = 2  # 8 batches of 4 → 4 fused chunks
        real = tstep.fused_light_pipeline
        monkeypatch.setattr(tstep, "fused_light_pipeline",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    out = capsys.readouterr().out
    assert ("fused input pipeline active" in out) == fused
    assert len(calls) == (8 if fused else 0)
    records = _records(tmp_path)
    keys = {k for r in records for k in r}
    for expected in ("train/loss", "val/f1", "compiled/f1", "test/f1",
                     "compiled/latent_density"):
        assert expected in keys, expected
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 8 and np.isfinite(losses).all()

    payload = load_checkpoint(_best(tmp_path))
    assert payload["model_type"] == "nnue" and payload["epoch"] == 0
    assert set(payload["opt_state"]["trace"]) == set(payload["params"])
    assert payload["opt_state"]["count"] == 8
    assert payload["params"]["nnue2score"].dtype == np.float32


def test_serialize_reads_the_port_checkpoint(env):
    """The JAX package's `serialize.py` loads the port's checkpoint and
    writes the same `.nnue` bytes as `nnue_quantize` + `write_nnue`."""
    cfg, tmp_path = env
    cfg.qat = True
    cfg.weight_decay = 2e-4
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    ckpt = _best(tmp_path)
    sys.path.insert(0, str(REPO))
    try:
        import serialize
    finally:
        sys.path.remove(str(REPO))
    model_type, params, _, jcfg = serialize.load_checkpoint_auto(ckpt)
    assert model_type == "nnue" and jcfg.l1_size == 32
    out = serialize.serialize_checkpoint(ckpt, tmp_path / "jax.nnue")
    model = nnue_from_checkpoint(load_checkpoint(ckpt), device="cpu")
    assert float(model.nnue2score.detach()) < 600.0  # decayed (F1)
    formats.write_nnue(nnue_quantize(model), tmp_path / "port.nnue")
    assert out.read_bytes() == (tmp_path / "port.nnue").read_bytes()


@pytest.mark.parametrize("metric,best_epoch", [("val_f1", 0),
                                               ("compiled_f1", 1)])
def test_best_model_follows_checkpoint_metric(env, monkeypatch, metric,
                                              best_epoch):
    """Epoch 1 improves the int8 F1 but not the float val F1: only the
    compiled_f1 gate saves it (the JAX package's manager gated on val_f1
    again and kept epoch 0)."""
    cfg, tmp_path = env
    cfg.max_epochs = 2
    cfg.checkpoint_metric = metric
    val_f1 = iter([0.5, 0.5, 0.4, 0.4, 0.4])  # (train, val) per epoch, test
    compiled_f1 = iter([0.3, 0.6])
    monkeypatch.setattr(tloop, "evaluate_model", lambda *a, **k: (
        1.0, {"f1": next(val_f1), "acc": 0.5}))
    monkeypatch.setattr(tloop, "evaluate_int8_sim", lambda *a, **k: {
        "f1": next(compiled_f1), "acc": 0.5, "ms_per_sample": 0.0,
        "latent_density": 0.1})
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    payload = load_checkpoint(_best(tmp_path))
    assert payload["epoch"] == best_epoch


def test_cli_trains(env, capsys):
    _, tmp_path = env
    rc = tcli.main(["nnue", "--config", TEST_CONFIG, "--log_dir",
                    str(tmp_path / "logs"), "--max_epochs", "1", "--seed", "3",
                    "--device", "cpu"])
    assert rc == 0
    assert "Test: loss" in capsys.readouterr().out
    assert _best(tmp_path).is_file()


@pytest.mark.parametrize("attr,value,match", [
    ("max_devices", 4, "mesh"),
])
def test_unported_options_raise(env, capsys, attr, value, match):
    """The loop refuses no option now: a data-parallel width
    (`max_devices` > 1) in one process trains on its one device, as the
    JAX loop does on one chip; only a `compiled_backend` that is none
    (here "mesh") raises, before any work."""
    cfg, tmp_path = env
    setattr(cfg, attr, value)
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    assert "Data-parallel" not in capsys.readouterr().out
    cfg.compiled_backend = match
    cfg.log_dir = str(tmp_path / "refused")
    with pytest.raises(ValueError, match="compiled_backend"):
        tloop.train_model(cfg, "nnue", device="cpu")
    assert not (tmp_path / "refused").exists()  # raised before any work


def test_cuda_request_raises_without_cuda(env):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg, _ = env
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.train_model(cfg, "nnue", device="cuda")


def test_profile_probe_runs_on_cpu(tmp_path):
    """The train-step profile probe runs the fused chunk (eager and, on a
    card, graphed; both eager here), the phases and the profiler; on the
    CPU its device and graph numbers are null."""
    from nnue_vision_tpu_torch import profile_train_step

    out = profile_train_step.profile(TEST_CONFIG, "cpu", tmp_path / "prof")
    assert out["steps"] == 8 and out["batch"] == 4
    assert out["card"] is None and out["graph"] is None
    for which in ("eager", "graphed"):
        assert len(out["step_ms"][which]) == 2
        assert all(v > 0 for v in out["step_ms"][which])
        assert out["profile"][which]["device_busy_share"] is None
        assert "aten::" in (tmp_path / "prof" /
                            f"profile_table_{which}.txt").read_text()
    assert set(out["phase_ms"]) == {"k3", "forward_loss", "backward",
                                    "optimizer", "weight_clip"}
    assert profile_train_step._busy_us([(0, 2), (1, 3), (5, 6)]) == 4
