"""The port's distillation held against the JAX package's: the loss and
every gradient of `training/step.py`'s teacher term against JAX's
`_loss_and_logits` with a teacher, for an NNUE student and for an
engine_friendly EtinyNet student with a float teacher; the teacher's
statistics unchanged by a step; a teacher checkpoint written by the JAX
package driving the port's `train_model` and CLI; a teacher of the other
model type refused.

Tolerances: the loss to rtol 1e-5 and each gradient to atol 1e-5 for the
NNUE (`test_torch_train.py`'s bar: the inputs keep every conv output 1e-3
from the threshold), 1e-4 × max(1, the gradient's scale) for the EtinyNet
(`test_torch_etinynet.py`'s bar). The quantized EtinyNet student runs JAX
on the port's rounding decisions, the flips counted and held below 1%
(`test_torch_ef_etinynet.py::test_loss_grads_match_jax`).
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from config import load_config
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import checkpoint as jckpt
from nnue_vision_tpu.training import step as jstep
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import step as tstep
from nnue_vision_tpu_torch.training.checkpoint import load_checkpoint
from nnue_vision_tpu_torch.training.optim import create_optimizer
from tests.test_torch_ef_etinynet import _cfgs as ef_cfgs
from tests.test_torch_ef_etinynet import _force_port_decisions, _images
from tests.test_torch_ef_etinynet import _model as ef_model

REPO = Path(__file__).resolve().parent.parent
GRID, CH, H = 4, 4, 12
WIDTHS = dict(l1_size=32, l2_size=16, l3_size=8, num_classes=10, input_size=H)
ALPHA, TEMP = 0.3, 4.0


def _nnue_cfgs(**kw):
    j = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    t = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    return j, t


def _nnue_params(rng):
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    f, l1, l2, l3, c = GRID * GRID * CH, 32, 16, 8, 10
    return {
        "conv_w": u((CH, 3, 3, 3), 27),
        "visual_threshold": np.asarray([0.1, 0.14, 0.06, 0.1], np.float32),
        "ft_w": (rng.standard_normal((f, l1)) * 0.1).astype(np.float32),
        "ft_b": (rng.standard_normal(l1) * 0.05).astype(np.float32),
        "fc1_w": u((l2, l1), l1), "fc1_b": u((l2,), l1),
        "fc2_w": u((l3, l2), l2), "fc2_b": u((l3,), l2),
        "out_w": u((c, l3), l3), "out_b": u((c,), l3),
        "nnue2score": np.float32(600.0),
    }


def _margin(p, x, cfg):
    """Per image, min |conv - threshold| in float64 with the weights and
    threshold the forward uses."""
    w = p["conv_w"].astype(np.float64)
    t = p["visual_threshold"].astype(np.float64)
    if cfg.qat:
        t = np.full_like(t, t.mean())
        w = np.round(np.clip(w, -127 / 64, 127 / 64) * 64) / 64
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                    torch.from_numpy(w), stride=cfg.conv_stride, padding=1)
    return np.abs(conv.permute(0, 2, 3, 1).numpy() - t).min(axis=(1, 2, 3))


def _float_teacher(seed):
    """(numpy params, numpy stats) of a plain micro EtinyNet with
    non-trivial norm affines and running statistics."""
    jcfg = jetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=32)
    params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = perturb(v)
                continue
            lo, hi = {"scale": (0.6, 1.4), "bias": (-0.3, 0.3), "mean": (-0.3, 0.3),
                      "var": (0.5, 2.0)}.get(k, (None, None))
            out[k] = (np.asarray(v) if lo is None
                      else rng.uniform(lo, hi, v.shape).astype(np.float32))
        return out

    return jcfg, perturb(params), perturb(stats)


def _assert_grads(model, want, atol_scale=None, atol=None):
    flat = bridge._flatten(jax.device_get(want))
    for name, p in model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        tol = atol if atol is not None else atol_scale * max(
            1.0, float(np.abs(flat[name]).max()))
        np.testing.assert_allclose(got, flat[name], rtol=0, atol=tol, err_msg=name)


def test_nnue_distillation_loss_and_grads_match_jax():
    """A QAT NNUE student and a float NNUE teacher of other params."""
    rng = np.random.default_rng(91)
    jcfg, tcfg = _nnue_cfgs(qat=True)
    jtcfg, ttcfg = _nnue_cfgs()
    p, pt = _nnue_params(rng), _nnue_params(rng)
    raw = rng.random((64, H, H, 3), dtype=np.float32)
    x = normalize_images(torch.from_numpy(raw)).numpy()
    x = x[(_margin(p, x, tcfg) > 1e-3) & (_margin(pt, x, ttcfg) > 1e-3)][:8]
    assert len(x) == 8
    y = rng.integers(0, 10, 8).astype(np.int32)

    jp = jax.tree_util.tree_map(jnp.asarray, p)
    teacher = (jtcfg, jax.tree_util.tree_map(jnp.asarray, pt), None, ALPHA, TEMP)
    (want, _), grads = jax.value_and_grad(jstep._loss_and_logits, argnums=2,
                                          has_aux=True)(
        "nnue", jcfg, jp, None, jnp.asarray(x), jnp.asarray(y), teacher)
    plain, _ = jstep._loss_and_logits("nnue", jcfg, jp, None, jnp.asarray(x),
                                      jnp.asarray(y))

    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    t_model = bridge.nnue_from_jax_params(pt, ttcfg, device="cpu")
    xt = torch.from_numpy(x)
    loss = tstep.distillation_loss(model(xt), torch.from_numpy(y).long(), xt,
                                   tstep.Teacher(t_model, ALPHA, TEMP))
    loss.backward()
    assert abs(float(want) - float(plain)) > 1e-2  # the teacher term counts
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(model, grads, atol=1e-5)
    assert all(p.grad is None for p in t_model.parameters())


@pytest.mark.parametrize("quantizers", [False, True],
                         ids=["continuous", "quantized"])
def test_ef_etinynet_distillation_loss_and_grads_match_jax(monkeypatch, quantizers):
    """An engine_friendly micro EtinyNet student (training mode) and a
    float micro teacher (eval mode, on its running statistics)."""
    jcfg, tcfg = ef_cfgs(quantizers=quantizers)
    params, stats = ef_model(seed=3)
    t_jcfg, t_params, t_stats = _float_teacher(seed=7)
    x = _images(seed=4)
    labels = np.random.default_rng(5).integers(0, 10, len(x))

    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").train()
    t_model = bridge.etinynet_from_jax(
        t_params, t_stats, tetiny.EtinyNetConfig(variant="micro", num_classes=10,
                                                 input_size=32), device="cpu")
    decisions = []
    real_ste = tetiny._ste

    def record(v, quantized):
        decisions.append(quantized.detach().numpy().copy())
        return real_ste(v, quantized)

    monkeypatch.setattr(tetiny, "_ste", record)
    xt = torch.from_numpy(x)
    loss = tstep.distillation_loss(model(xt), torch.from_numpy(labels), xt,
                                   tstep.Teacher(t_model, ALPHA, TEMP))
    loss.backward()

    teacher = (t_jcfg, t_params, t_stats, ALPHA, TEMP)

    def loss_fn(p):
        return jstep._loss_and_logits("etinynet", jcfg, p, stats, jnp.asarray(x),
                                      jnp.asarray(labels), teacher)[0]

    if quantizers:
        flips = _force_port_decisions(monkeypatch, decisions)
        loss_fn(params)  # counts the flips
        assert sum(flips) * 100 < sum(d.size for d in decisions), flips
    want, grads = jax.value_and_grad(loss_fn)(params)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(model, grads, atol_scale=1e-4)


def test_teacher_statistics_unchanged_by_a_step():
    """A train step with an EtinyNet teacher: the student's running
    statistics move, the teacher's params and statistics do not, and the
    teacher stays in eval mode with no gradients."""
    _, t_params, t_stats = _float_teacher(seed=8)
    cfg = tetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=32)
    t_model = bridge.etinynet_from_jax(t_params, t_stats, cfg, device="cpu")
    t_model.requires_grad_(False)
    before = {k: v.clone() for k, v in t_model.state_dict().items()}
    student = tetiny.etinynet_init(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    s_before = {k: v.clone() for k, v in student.state_dict().items()}

    class Opt:
        learning_rate, optimizer_type, weight_decay, max_grad_norm = 1e-3, "adam", 0, 0

    opt = create_optimizer(Opt())
    state = tstep.make_train_state(student, opt)
    x = torch.from_numpy(_images(seed=9))
    y = torch.randint(0, 10, (len(x),), generator=torch.Generator().manual_seed(1))
    m = tstep.train_step(state, x, y, optimizer=opt,
                         teacher=tstep.Teacher(t_model, ALPHA, TEMP))
    assert math.isfinite(float(m["loss"]))
    assert not t_model.training
    for k, v in t_model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in t_model.parameters())
    moved = [k for k, v in student.state_dict().items()
             if k.endswith(("mean", "var")) and not torch.equal(v, s_before[k])]
    assert moved


def _jax_teacher_checkpoint(path: Path) -> None:
    jcfg, params, stats = _float_teacher(seed=10)
    jckpt.save_checkpoint(path, model_type="etinynet", model_config=jcfg,
                          params=params, batch_stats=stats, epoch=3, metrics={})


def test_jax_teacher_drives_the_distill_config_through_the_cli(
        tmp_path, monkeypatch, capsys):
    """`config/train_etinynet_distill.py` (micro, engine_friendly, alpha
    0.3) with a JAX-written float teacher, cut to two epochs with one
    warm-up on 256 synthetic-hard images, the engine probe on: every step
    gets the teacher, the losses are finite and the quantized epoch is the
    best model."""
    _jax_teacher_checkpoint(tmp_path / "teacher.ckpt")
    monkeypatch.delenv("NV_SKIP_ENGINE", raising=False)
    monkeypatch.chdir(tmp_path)
    teachers = []
    real = tloop.gathered_train_step

    def spy(*a, **kw):
        teachers.append(kw["teacher"])
        return real(*a, **kw)

    monkeypatch.setattr(tloop, "gathered_train_step", spy)
    rc = tcli.main(["etinynet", "--config",
                    str(REPO / "config/train_etinynet_distill.py"),
                    "--distill_from", str(tmp_path / "teacher.ckpt"),
                    "--synthetic_size", "256", "--batch_size", "64",
                    "--max_epochs", "2", "--ef_warmup_epochs", "1",
                    "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "distilling from" in out and "alpha=0.3" in out and "Engine OK" in out
    assert len(teachers) == 8 and all(t is teachers[0] for t in teachers)
    t = teachers[0]
    assert isinstance(t.model, tetiny.EtinyNet) and not t.model.cfg.engine_friendly
    assert (t.alpha, t.temp) == (0.3, 4.0) and not t.model.training
    metrics = next((tmp_path / "logs" / "runs").rglob("metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 8 and np.isfinite(losses).all()
    payload = load_checkpoint(next((tmp_path / "logs" / "checkpoints").rglob(
        "best_model.ckpt")))
    assert payload["epoch"] == 1 and payload["model_config"]["ef_quantizers"]


def test_nnue_distillation_turns_the_fused_path_off(tmp_path, monkeypatch, capsys):
    """An NNUE on the light tier with a teacher trains through
    `scanned_train_steps` and `gathered_train_step` (the JAX loop's gate),
    with the default alpha and temperature."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(REPO / "config" / "train_nnue_test.py"))
    cfg.log_dir = str(tmp_path / "teacher_logs")
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    teacher_ckpt = next((tmp_path / "teacher_logs" / "checkpoints").rglob(
        "best_model.ckpt"))
    capsys.readouterr()
    cfg = load_config(str(REPO / "config" / "train_nnue_test.py"))
    cfg.log_dir = str(tmp_path / "logs")
    cfg.use_augmentation = True
    cfg.steps_per_dispatch = 2
    cfg.distill_from = str(teacher_ckpt)
    teachers = []
    real, real_scanned = tloop.gathered_train_step, tloop.scanned_train_steps
    monkeypatch.setattr(tloop, "gathered_train_step", lambda *a, **kw: (
        teachers.append(kw["teacher"]), real(*a, **kw))[1])
    monkeypatch.setattr(tloop, "scanned_train_steps", lambda *a, **kw: (
        teachers.extend([kw["teacher"]] * len(a[3])), real_scanned(*a, **kw))[1])
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    out = capsys.readouterr().out
    assert "fused input pipeline active" not in out
    assert len(teachers) == 8 and isinstance(teachers[0].model, tnnue.NNUE)
    assert (teachers[0].alpha, teachers[0].temp) == (0.5, 4.0)


def test_teacher_of_the_other_model_type_raises(tmp_path, monkeypatch):
    _jax_teacher_checkpoint(tmp_path / "teacher.ckpt")
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    cfg = load_config(str(REPO / "config" / "train_nnue_test.py"))
    cfg.log_dir = str(tmp_path / "logs")
    cfg.distill_from = str(tmp_path / "teacher.ckpt")
    with pytest.raises(ValueError, match="etinynet model; training a nnue"):
        tloop.train_model(cfg, "nnue", device="cpu")
