"""The port trains an EtinyNet end to end on the CPU: `train_model` on a
micro, heavy-tier, bf16 config for two epochs (finite losses, a checkpoint,
a compiled int8 eval that the checkpoint reproduces), the CLI, and the
repair of F3: an EtinyNet on the light tier takes the gathered step, not
the NNUE-only fused K3 path, and `train_step` clips no EtinyNet weight.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from config import load_config
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig, etinynet_init
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import step as tstep
from nnue_vision_tpu_torch.training.checkpoint import (
    etinynet_from_checkpoint,
    load_checkpoint,
)
from nnue_vision_tpu_torch.training.evaluate import evaluate_int8_sim
from nnue_vision_tpu_torch.training.optim import create_optimizer

REPO = Path(__file__).resolve().parent.parent
TEST_CONFIG = str(REPO / "config" / "train_etinynet_test.py")


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


def test_train_model_heavy_bf16(env, monkeypatch):
    """Two epochs of 8 gathered steps; each step warps twice and runs both
    photometric blocks; the checkpoint's int8 sim reproduces the compiled
    metrics of the epoch it saved."""
    cfg, tmp_path = env
    cfg.max_epochs = 2
    cfg.use_augmentation = True
    cfg.augmentation_strength = "heavy"
    cfg.dtype = "bfloat16"
    cfg.optimizer_type = "sgd"
    cfg.momentum = 0.9
    cfg.learning_rate = 0.05
    calls = {"warp": 0, "medium": 0, "heavy_extra": 0}
    real_warp, real_photo = taug.warp_bilinear, taug.photometric_block

    def warp(x, params):
        calls["warp"] += 1
        return real_warp(x, params)

    def photo(x, noise, f, i, *, variant):
        calls[variant] += 1
        return real_photo(x, noise, f, i, variant=variant)

    monkeypatch.setattr(taug, "warp_bilinear", warp)
    monkeypatch.setattr(taug, "photometric_block", photo)
    assert tloop.train_model(cfg, "etinynet", device="cpu") == 0
    assert calls == {"warp": 32, "medium": 16, "heavy_extra": 16}
    records = _records(tmp_path)
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 16 and all(math.isfinite(v) for v in losses)
    epochs = [r for r in records if "compiled/f1" in r]
    assert len(epochs) == 2
    assert epochs[-1]["compiled/latent_density"] == 0.0
    payload = load_checkpoint(_best(tmp_path))
    assert payload["model_type"] == "etinynet"
    assert payload["model_config"]["dtype"] == "bfloat16"
    assert set(payload["batch_stats"]) == {"stem_bn", "blocks", "final_bn"}
    model = etinynet_from_checkpoint(payload, device="cpu")
    assert next(model.parameters()).dtype == torch.float32
    loader = tloop.create_data_loaders(
        dataset_name=cfg.dataset_name, batch_size=cfg.batch_size,
        max_samples_per_split=cfg.max_samples_per_split, seed=cfg.seed)[1]
    metrics = evaluate_int8_sim(model, loader)
    best = epochs[payload["epoch"]]
    assert metrics["acc"] == best["compiled/accuracy"]
    assert metrics["f1"] == best["compiled/f1"]


def test_f3_light_tier_etinynet_takes_the_gathered_step(env, monkeypatch):
    """F3: the fused light-tier path (K3, then the NNUE weight clip) is for
    an NNUE only, as in the JAX loop; an EtinyNet on the light tier trains
    through `gathered_train_step`."""
    cfg, _ = env
    cfg.use_augmentation = True
    cfg.augmentation_strength = "light"
    cfg.steps_per_dispatch = 2
    fused, gathered = [], []
    monkeypatch.setattr(tloop, "scanned_train_steps_fused",
                        lambda *a, **k: fused.append(1))
    real = tloop.gathered_train_step
    monkeypatch.setattr(tloop, "gathered_train_step",
                        lambda *a, **k: gathered.append(1) or real(*a, **k))
    before = dict(ip.LAUNCHES)
    assert tloop.train_model(cfg, "etinynet", device="cpu") == 0
    assert fused == [] and len(gathered) == 8
    assert ip.LAUNCHES == before


def test_f3_train_step_clips_no_etinynet_weight():
    """The JAX step clips NNUE weights only (`training/step.py:100` there):
    an EtinyNet's norm scales and classifier keep values beyond ±1."""
    cfg = EtinyNetConfig(variant="micro", num_classes=10, input_size=16)
    model = etinynet_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.stem_bn.scale.fill_(1.5)
        model.cls_b.fill_(-2.0)
    opt = create_optimizer(type("C", (), dict(
        optimizer_type="sgd", learning_rate=1e-4, momentum=0.0, weight_decay=0.0,
        max_grad_norm=0.0, use_cosine_scheduler=False, decay_lr=False,
        max_epochs=1))(), 1)
    state = tstep.make_train_state(model, opt)
    x = torch.randn((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    m = tstep.train_step(state, x, torch.tensor([0, 1, 2, 3]), optimizer=opt)
    assert math.isfinite(float(m["loss"]))
    assert float(model.stem_bn.scale.detach().min()) > 1.4
    assert float(model.cls_b.detach().max()) < -1.9


def test_cli_trains_etinynet(env, capsys):
    _, tmp_path = env
    rc = tcli.main(["etinynet", "--config", TEST_CONFIG, "--log_dir",
                    str(tmp_path / "logs"), "--augmentation_strength", "medium",
                    "--use_augmentation", "true", "--seed", "3",
                    "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Model: etinynet" in out and "Test: loss" in out
    assert _best(tmp_path).is_file()


def test_profile_probe_runs_an_etinynet_on_cpu(tmp_path):
    """The train-step probe takes the gathered heavy-tier path for an
    EtinyNet; on the CPU its device numbers are null."""
    from nnue_vision_tpu_torch import profile_train_step

    out = profile_train_step.profile(
        TEST_CONFIG, "cpu", tmp_path / "prof", "etinynet",
        {"augmentation_strength": "heavy", "steps_per_dispatch": 2})
    assert out["model_type"] == "etinynet" and out["steps"] == 2
    assert out["step_ms"] > 0 and out["card"] is None
    assert set(out["phase_ms"]) == {"augment", "forward_loss", "backward",
                                    "optimizer"}
    assert out["device_busy_share"] is None
