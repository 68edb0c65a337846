"""ImageNet-size inputs in the port, held against the JAX package on the
same numpy inputs: the warp dispatch (JAX `_warp`'s shape rule: the
two-pass resample for small squares, the single-pass bilinear gather
otherwise), an augmentation tier at 224×224, EtinyNet-1.0 with 1000
classes (forward logits and `.etiny` bytes), and `train_model` on
`config/train_etinynet_imagenet.py` cut to the micro variant, on the
device-resident and on the host-batch branch.

Tolerances: the gather computes JAX's float32 expressions in the same
order, and the two-pass matches JAX's one-hot matmuls to float32 rounding
(XLA may contract a multiply-add): atol 1e-5. The EtinyNet logits sum in
another order in XLA and torch: atol 1e-5, as at 32×32 in
tests/test_torch_etinynet.py. The `.etiny` bytes are exact.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from config import load_config
from nnue_vision_tpu import formats
from nnue_vision_tpu.data import augment as jaug
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.ops import photometric_kernel as tpk
from nnue_vision_tpu_torch.ops import warp_kernel as twk
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import step as tstep
from nnue_vision_tpu_torch.training.checkpoint import (
    StepCheckpointer,
    load_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
IMAGENET_CONFIG = str(REPO / "config" / "train_etinynet_imagenet.py")


def _jax_warp(x, mv):
    return np.asarray(jaug._warp(jnp.asarray(x), (jnp.asarray(mv[0].numpy()),
                                                  jnp.asarray(mv[1].numpy()))))


@pytest.mark.parametrize("tier", ["medium", "heavy"])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 40), (32, 32)])
def test_warp_dispatch_matches_jax(h, w, tier):
    """The port's `warp` on drawn maps equals JAX `_warp` on the same (M,
    v): the gather at 64×64 and 48×40, the two-pass at 32×32."""
    gen = torch.Generator().manual_seed(h * w)
    draw = taug.draw_medium_geometry if tier == "medium" else taug.draw_heavy_geometry
    mv = draw(gen, 8, h, w)
    x = np.random.default_rng(h + w).random((8, h, w, 3), dtype=np.float32)
    assert taug.two_pass_warp(h, w) == (h == w == 32)
    got = taug.warp(torch.from_numpy(x), taug._warp_params(mv, h, w)).numpy()
    np.testing.assert_allclose(got, _jax_warp(x, mv), rtol=0, atol=1e-5)


def test_two_pass_range_is_jaxs():
    """Squares up to 50×50 take the two-pass (K4 on the card), everything
    else the gather, as JAX decides off the TPU."""
    assert [n for n in range(3, 80) if taug.two_pass_warp(n, n)] == list(range(3, 51))
    assert not taug.two_pass_warp(32, 30) and not taug.two_pass_warp(224, 224)
    mv = taug.draw_heavy_geometry(torch.Generator().manual_seed(0), 4, 50, 50)
    x = np.random.default_rng(0).random((4, 50, 50, 3), dtype=np.float32)
    got = taug.warp(torch.from_numpy(x), taug._warp_params(mv, 50, 50)).numpy()
    np.testing.assert_allclose(got, _jax_warp(x, mv), rtol=0, atol=1e-5)


def test_gather_identity_and_out_of_frame():
    """The identity map gives the input bit for bit; a map off the frame
    gives zeros (each corner's own zero fill)."""
    x = torch.rand((3, 40, 56, 3), generator=torch.Generator().manual_seed(1))
    eye = torch.eye(2).expand(3, 2, 2)
    same = taug.warp_gather(x, taug.pack_gather_params(eye, torch.zeros((3, 2))))
    assert torch.equal(same, x)
    off = taug.pack_gather_params(eye, torch.tensor([[70.0, -90.0]]).expand(3, 2))
    assert torch.equal(taug.warp_gather(x, off), torch.zeros_like(x))
    half = taug.pack_gather_params(eye, torch.tensor([[0.0, 0.5]]).expand(3, 2))
    want = (x[:, :, :-1] * 0.5 + x[:, :, 1:] * 0.5)
    torch.testing.assert_close(taug.warp_gather(x, half)[:, :, :-1], want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("tier", ["medium", "heavy"])
def test_tier_at_224_is_gather_then_k5_plain(tier):
    """augment_batch at 224×224 on the CPU: each block's gather warp, then
    its photometric block, on the drawn parameters and noise."""
    b = 3
    images = torch.rand((b, 224, 224, 3), generator=torch.Generator().manual_seed(2))
    got = taug.augment_batch(torch.Generator().manual_seed(3), images, tier,
                             noise_gen=torch.Generator().manual_seed(4))
    draws = taug.draw_tier(torch.Generator().manual_seed(3), tier, b, 224, 224, "cpu")
    noise_gen = torch.Generator().manual_seed(4)
    x = taug.warp_gather(images, draws.warp1)
    x = tpk.photometric_block_reference(
        x, torch.randn(x.shape, generator=noise_gen), *draws.photo1, variant="medium")
    if tier == "heavy":
        x = taug.warp_gather(x, draws.warp2)
        x = tpk.photometric_block_reference(
            x, torch.randn(x.shape, generator=noise_gen), *draws.photo2,
            variant="heavy_extra")
    assert torch.equal(got, x)
    assert got.shape == images.shape and bool(torch.isfinite(got).all())
    assert twk.LAUNCHES["warp_kernel"] == 0


def _etiny_1_0(seed=0, size=64):
    kw = dict(variant="1.0", num_classes=1000, input_size=size)
    jcfg, tcfg = jetiny.EtinyNetConfig(**kw), tetiny.EtinyNetConfig(**kw)
    params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), stats)
    return jcfg, tcfg, params, stats


def test_etinynet_1_0_at_64_matches_jax(tmp_path):
    """Full width (stem 32, stages 32/128/192/256, final 1280), 1000
    classes: eval logits on the carried-over weights, and the `.etiny`."""
    jcfg, tcfg, params, stats = _etiny_1_0()
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want, _ = jetiny.etinynet_apply(params, stats, jnp.asarray(x), jcfg, train=False)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").eval()
    assert model.cls_w.shape == (1000, 1280) and model.stem_w.shape[-1] == 32
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    formats.write_etiny(jetiny.etinynet_quantize(params, stats, jcfg),
                        tmp_path / "jax.etiny")
    formats.write_etiny(tetiny.etinynet_quantize(model), tmp_path / "port.etiny")
    assert (tmp_path / "port.etiny").read_bytes() == (tmp_path / "jax.etiny").read_bytes()


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host-batch"])
def test_train_model_on_the_imagenet_config(tmp_path, monkeypatch, capsys, resident):
    """The ImageNet config, cut to the micro variant, batch 4, 8 synthetic
    images and one epoch: 224×224 batches into a 1000-class head, finite
    loss, float and int8 evals, a step checkpoint (best_model.ckpt is
    written only where the epoch's val F1 beats 0, which a one-epoch run at
    1000 classes need not reach); `device_resident_max_bytes` 0 takes the
    host-batch branch."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.setenv("NV_DATA_DIR", str(tmp_path / "no-data"))
    monkeypatch.chdir(tmp_path)
    cfg = load_config(IMAGENET_CONFIG)
    assert (cfg.dataset_name, cfg.batch_size, cfg.augmentation_strength,
            cfg.num_classes) == ("imagenet", 256, "medium", 1000)
    cfg.etinynet_variant = "micro"
    cfg.batch_size = 4
    cfg.synthetic_size = 8
    cfg.max_epochs = 1
    cfg.log_dir = str(tmp_path / "logs")
    cfg.checkpoint_backend = "orbax"
    cfg.orbax_dir = str(tmp_path / "steps")
    if not resident:
        cfg.device_resident_max_bytes = 0
    seen = []
    real = tstep.train_step

    def spy(state, images, labels, **kw):
        seen.append((tuple(images.shape), tuple(labels.shape)))
        return real(state, images, labels, **kw)

    monkeypatch.setattr(tstep, "train_step", spy)
    monkeypatch.setattr(tloop, "train_step", spy)
    assert tloop.train_model(cfg, "etinynet", "im", device="cpu") == 0
    out = capsys.readouterr().out
    assert ("training set resident on device" in out) == resident
    assert seen == [((4, 224, 224, 3), (4,))] * 2
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "runs" / "im" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    epoch = next(r for r in records if "compiled/f1" in r)
    assert math.isfinite(epoch["val/loss"]) and 0.0 <= epoch["compiled/accuracy"] <= 1.0
    saved, meta = StepCheckpointer(tmp_path / "steps").restore()
    assert meta["epoch"] == 0 and saved["model"]["cls_w"].shape == (1000, 128)
    best = tmp_path / "logs" / "checkpoints" / "im" / "best_model.ckpt"
    assert best.is_file() == (epoch["val/f1"] > 0)
    if best.is_file():
        payload = load_checkpoint(best)
        assert payload["model_config"]["input_size"] == 224
        np.testing.assert_array_equal(payload["params"]["cls_w"],
                                      saved["model"]["cls_w"].numpy())


def test_cli_takes_imagenet_and_a_variant():
    args = tcli.setup_argument_parser().parse_args(
        ["etinynet", "--config", IMAGENET_CONFIG, "--dataset_name", "imagenet",
         "--etinynet_variant", "micro", "--synthetic_size", "8"])
    cfg = tcli.load_and_setup_config(args, "etinynet")
    assert (cfg.dataset_name, cfg.etinynet_variant, cfg.synthetic_size) == \
        ("imagenet", "micro", 8)
    assert cfg.input_size == (224, 224) and cfg.num_classes == 1000
