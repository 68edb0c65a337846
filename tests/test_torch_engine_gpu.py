"""The C++ engine held to the card's serving kernels, and a bf16 NNUE
training step through K3, on a card.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it (the package's
`tests/conftest.py` imports jax, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_engine_gpu.py

The engine prints its logits with `%.10f`, which moves a logit below
2^-10 by up to 1 ulp: a kernel's logits are compared as the engine prints
them (`as_engine_prints`), exactly, and the kernel's with the sim's
`torch.equal`.
"""

import math

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.training.engine_build import compile_cpp_engine
from nnue_vision_tpu_torch.training.evaluate import (
    as_engine_prints,
    engine_logits,
    normalize_host,
)
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    make_train_state,
    scanned_train_steps_fused,
)

pytestmark = pytest.mark.gpu
FLAGSHIP = dict(feature_set=tnnue.GridFeatureSet(10, 8), l1_size=1024,
                l2_size=128, l3_size=32, num_classes=10, input_size=32, qat=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for tool in ("nnue", "etinynet"):
        compile_cpp_engine(tool)
    return torch.device("cuda")


def _flagship_params(rng):
    cfg = tnnue.NNUEConfig(**FLAGSHIP)
    fs = cfg.feature_set

    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "conv_w": u((8, 3, 3, 3), 27),
        "visual_threshold": np.full((8,), 0.1, np.float32),
        "ft_w": (rng.standard_normal((fs.num_features, 1024)) * 0.1).astype(np.float32),
        "ft_b": np.zeros((1024,), np.float32),
        "fc1_w": u((128, 1024), 1024), "fc1_b": u((128,), 1024),
        "fc2_w": u((32, 128), 128), "fc2_b": u((32,), 128),
        "out_w": u((10, 32), 32), "out_b": u((10,), 32),
        "nnue2score": np.float32(600.0),
    }


@pytest.mark.parametrize("batch", [37, 512])
def test_engine_equals_k1_on_a_flagship_model(cuda, batch):
    rng = np.random.default_rng(71)
    model = nnue_from_jax_params(_flagship_params(rng), tnnue.NNUEConfig(**FLAGSHIP),
                                 device=cuda)
    images = rng.random((batch, 32, 32, 3), dtype=np.float32)
    got, _, densities, _ = engine_logits(
        model, [(images, np.zeros(batch, np.int64))])
    sim, cfg = tsim.nnue_sim_params(tnnue.nnue_quantize(model), device=cuda)
    mega = nk.mega_head_params(sim, cfg, 32, 32)
    x = torch.from_numpy(normalize_host(images)).to(cuda)
    kw = dict(cfg=cfg, image_h=32, image_w=32)
    nk.reset_launch_counts()
    logits, _, count = nk.nnue_engine_forward_mega(mega, x.reshape(batch, -1), **kw)
    assert nk.LAUNCHES["nnue_mega_kernel"] == 1
    ref = tsim.nnue_engine_forward(sim, x, **kw)
    assert torch.equal(logits, ref[0]) and torch.equal(count, ref[2])
    np.testing.assert_array_equal(got, as_engine_prints(logits.cpu().numpy()))
    np.testing.assert_allclose(densities, count.cpu().numpy() / cfg.num_features,
                               atol=1e-9)


def test_engine_equals_k6_on_a_0_98m_etiny(cuda):
    rng = np.random.default_rng(72)
    model = tetiny.EtinyNet(tetiny.EtinyNetConfig(variant="0.98M", num_classes=10,
                                                  input_size=32), device="cpu")
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        lo, hi = (0.5, 1.5) if leaf in ("scale", "var") else (-0.3, 0.3)
        state[name] = torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32))
    model.load_state_dict(state)
    images = rng.random((64, 32, 32, 3), dtype=np.float32)
    got, _, _, _ = engine_logits(model.eval(), [(images, np.zeros(64, np.int64))])
    sim, cfg = tsim.etiny_sim_params(tetiny.etinynet_quantize(model), device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = torch.from_numpy(normalize_host(images)).to(cuda)
    kw = dict(cfg=cfg, image_h=32, image_w=32)
    logits = ek.etiny_forward_kernel(kp, x, **kw)
    assert torch.equal(logits, tsim.etiny_engine_forward(sim, x, **kw))
    np.testing.assert_array_equal(got, as_engine_prints(logits.cpu().numpy()))


def test_bf16_nnue_step_through_k3(cuda):
    """Four fused light-tier steps of a full-width bf16 QAT NNUE: one K3
    launch each, finite losses, float32 params that moved."""
    rng = np.random.default_rng(73)
    cfg = tnnue.NNUEConfig(**FLAGSHIP, dtype="bfloat16")
    model = nnue_from_jax_params(_flagship_params(rng), cfg, device=cuda)
    before = model.ft_w.detach().clone()
    images = torch.from_numpy(rng.random((512, 32, 32, 3), dtype=np.float32))
    dataset = ip.prepare_gather_dataset(images.to(cuda))
    labels = torch.from_numpy(rng.integers(0, 10, 512)).to(cuda)

    class Cfg:
        learning_rate, optimizer_type, momentum = 0.02, "sgd", 0.9
        weight_decay, max_grad_norm = 2e-4, 1.0

    opt = create_optimizer(Cfg())
    state = make_train_state(model, opt)
    ip.reset_launch_counts()
    out = scanned_train_steps_fused(
        state, dataset, labels, rng.permutation(512).reshape(4, 128),
        torch.Generator().manual_seed(0), optimizer=opt, height=32, width=32)
    assert ip.LAUNCHES["light_pipeline_kernel"] == 4
    assert bool(torch.isfinite(out["loss"]).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not torch.equal(model.ft_w, before)
    logits = model(normalize_images(images[:8].to(cuda)))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
