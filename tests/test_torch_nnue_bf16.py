"""The port's NNUE with `dtype="bfloat16"` held against the JAX package's
`nnue_apply` with the same dtype, on the same numpy params.

bf16 compute rounds the conv, the FT and every dense layer to 8 bits of
mantissa, and XLA and torch sum in another order before that rounding, so
the two bf16 results differ by a bf16 rounding here and there. The bound
on the logits and on each gradient is the JAX package's own bf16-against-
float32 error on the same inputs, twice over, plus 1e-3 of the values'
scale (the pattern of `test_torch_etinynet.py::test_bf16_forward_matches_jax`).
The threshold compare sees bf16 conv outputs; mask bits that differ between
the two packages are counted and held to at most 1% of the mask. The
`.nnue` of a bf16-trained model is quantized from its float32 params, so its
bytes equal JAX's exactly.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from nnue_vision_tpu import formats
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training.checkpoint import (
    load_checkpoint,
    nnue_from_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
GRID, CH, H = 4, 4, 12
WIDTHS = dict(l1_size=32, l2_size=16, l3_size=8, num_classes=10, input_size=H)
MAX_FLIP_SHARE = 0.01


def _cfgs(**kw):
    j = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    t = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    return j, t


def _params(rng):
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


def _batch(rng, b=16):
    raw = rng.random((b, H, H, 3), dtype=np.float32)
    return (normalize_images(torch.from_numpy(raw)).numpy(),
            rng.integers(0, 10, b).astype(np.int32))


def _jax(p, x, y, jcfg):
    """(loss, grads, logits, mask) of JAX's nnue_apply."""
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def loss_fn(params):
        logits, aux = jnnue.nnue_apply(params, jnp.asarray(x), jcfg,
                                       return_aux=True)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, aux["mask"])

    (loss, (logits, mask)), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
            np.asarray(logits), np.asarray(mask, np.float32))


def _port(p, x, y, tcfg):
    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    logits, aux = model(torch.from_numpy(x), return_aux=True)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    grads = {n: (np.zeros(t.shape, np.float32) if t.grad is None
                 else t.grad.numpy()) for n, t in model.named_parameters()}
    return (loss.item(), grads, logits.detach().numpy(),
            aux["mask"].detach().float().numpy(), model, aux)


def _bound(want, want_f32):
    own = float(np.abs(want - want_f32).max())
    return 2 * own + 1e-3 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_forward_and_grads_match_jax_bf16(qat):
    rng = np.random.default_rng(81)
    p = _params(rng)
    x, y = _batch(rng)
    jcfg32, _ = _cfgs(qat=qat)
    jcfg, tcfg = _cfgs(qat=qat, dtype="bfloat16")
    wl32, wg32, wlog32, _ = _jax(p, x, y, jcfg32)
    wl, wg, wlog, wmask = _jax(p, x, y, jcfg)
    gl, gg, glog, gmask, model, aux = _port(p, x, y, tcfg)

    # the compare runs on bf16 conv outputs; the mask is bf16, the logits,
    # the density and every gradient float32
    assert aux["mask"].dtype == torch.bfloat16
    assert glog.dtype == np.float32 and aux["density"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in model.parameters())
    flips = int((gmask != wmask).sum())
    assert flips <= MAX_FLIP_SHARE * gmask.size, (flips, gmask.size)
    assert not np.array_equal(wlog, wlog32)  # bf16 really computes in bf16

    np.testing.assert_allclose(glog, wlog, rtol=0, atol=_bound(wlog, wlog32))
    np.testing.assert_allclose(gl, wl, rtol=0, atol=_bound(np.float32(wl),
                                                           np.float32(wl32)))
    for name, want in wg.items():
        np.testing.assert_allclose(gg[name], want, rtol=0,
                                   atol=_bound(want, wg32[name]), err_msg=name)
    assert np.abs(gg["visual_threshold"]).max() > 0  # the STE's gradient


def test_ste_gradient_in_the_threshold_dtype():
    """The straight-through compare returns x's dtype; the threshold's
    gradient comes back in the threshold's dtype (JAX's custom VJP)."""
    x = torch.randn(2, 3, 3, 4, dtype=torch.bfloat16, requires_grad=True)
    t = torch.full((4,), 0.1, dtype=torch.bfloat16, requires_grad=True)
    m = tnnue.binary_activation_ste(x, t)
    assert m.dtype == torch.bfloat16
    m.sum().backward()
    assert x.grad.dtype == torch.bfloat16 and t.grad.dtype == torch.bfloat16
    tf = torch.full((4,), 0.1, requires_grad=True)
    tnnue.binary_activation_ste(x.detach(), tf.to(torch.bfloat16)).sum().backward()
    assert tf.grad.dtype == torch.float32 and tf.grad.abs().max() > 0


def test_bf16_dtype_is_checked():
    with pytest.raises(ValueError, match="dtype"):
        _cfgs(dtype="float16")


def test_nnue_bytes_equal_jax_from_bf16_config(tmp_path):
    """A bf16 model's `.nnue` is quantized from its float32 params: the
    same bytes as the JAX package's quantizer on the same params."""
    rng = np.random.default_rng(82)
    p = _params(rng)
    jcfg, tcfg = _cfgs(qat=True, dtype="bfloat16")
    formats.write_nnue(jnnue.nnue_quantize(p, jcfg), tmp_path / "jax.nnue")
    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    formats.write_nnue(tnnue.nnue_quantize(model), tmp_path / "port.nnue")
    assert (tmp_path / "port.nnue").read_bytes() == \
        (tmp_path / "jax.nnue").read_bytes()


def test_qat_bf16_config_trains_through_the_cli(tmp_path, monkeypatch, capsys):
    """`config/train_nnue_qat_bf16.py` at its full width, cut to one epoch
    of 8 light-tier steps (the fused K3 path, its plain version on the
    CPU), with the engine probe: finite losses, a bf16 checkpoint whose
    params are float32, the engine's int8 metrics on the val split."""
    monkeypatch.delenv("NV_SKIP_ENGINE", raising=False)
    monkeypatch.chdir(tmp_path)
    rc = tcli.main(["nnue", "--config", str(REPO / "config/train_nnue_qat_bf16.py"),
                    "--dataset_name", "synthetic-hard", "--synthetic_size", "256",
                    "--batch_size", "32", "--max_epochs", "1",
                    "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])
    assert rc == 0
    log = capsys.readouterr().out
    assert "Engine OK" in log and "fused input pipeline active" in log
    metrics = next((tmp_path / "logs" / "runs").rglob("metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 8 and np.isfinite(losses).all()
    payload = load_checkpoint(next((tmp_path / "logs" / "checkpoints").rglob(
        "best_model.ckpt")))
    assert payload["model_config"]["dtype"] == "bfloat16"
    assert payload["model_config"]["l1_size"] == 1024
    assert all(v.dtype == np.float32 for v in payload["params"].values())
    model = nnue_from_checkpoint(payload, device="cpu")
    assert model.cfg.dtype == "bfloat16" and model.cfg.qat
