"""The port's `evaluate_int8_sim`, metrics and normalization held against the
JAX package."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as jaug
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import evaluate as jeval
from nnue_vision_tpu.training import metrics as jmetrics
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import evaluate as teval
from nnue_vision_tpu_torch.training import metrics as tmetrics

KW = dict(feature_set=None, l1_size=16, l2_size=8, l3_size=4, num_classes=3,
          input_size=16)


def _params(rng):
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "conv_w": u((4, 3, 3, 3), 27),
        "visual_threshold": np.full((4,), 0.1, np.float32),
        "ft_w": (rng.standard_normal((64, 16)) * 0.1).astype(np.float32),
        "ft_b": np.zeros((16,), np.float32),
        "fc1_w": u((8, 16), 16), "fc1_b": u((8,), 16),
        "fc2_w": u((4, 8), 8), "fc2_b": u((4,), 8),
        "out_w": u((3, 4), 4), "out_b": u((3,), 4),
        "nnue2score": np.float32(600.0),
    }


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(41)
    p = _params(rng)
    jcfg = jnnue.NNUEConfig(**dict(KW, feature_set=jnnue.GridFeatureSet(4, 4)))
    tcfg = tnnue.NNUEConfig(**dict(KW, feature_set=tnnue.GridFeatureSet(4, 4)))
    loader = [
        (rng.random((n, 16, 16, 3), dtype=np.float32),
         rng.integers(0, 3, n).astype(np.int64))
        for n in (8, 5)
    ]
    return p, jcfg, bridge.nnue_from_jax_params(p, tcfg), loader


def test_int8_sim_metrics_match_jax(setup):
    p, jcfg, model, loader = setup
    ref = jeval.evaluate_int8_sim({k: jnp.asarray(v) for k, v in p.items()},
                                  None, loader, model_type="nnue",
                                  model_cfg=jcfg)
    for use_pallas in (False, True, "mega"):
        got = teval.evaluate_int8_sim(model, loader, use_pallas=use_pallas)
        for key in ("acc", "f1", "precision", "recall", "latent_density"):
            assert got[key] == ref[key], (use_pallas, key)
        assert got["ms_per_sample"] > 0


def test_int8_sim_rejects_bad_arguments(setup):
    _, _, model, loader = setup
    with pytest.raises(ValueError, match="use_pallas"):
        teval.evaluate_int8_sim(model, loader, use_pallas="fused")
    with pytest.raises(ValueError, match="0 batches"):
        teval.evaluate_int8_sim(model, [])


def test_normalize_matches_jax_within_one_ulp():
    """XLA's f32 division may be 1 ulp off a correctly rounded one (the
    engine-parity gotcha), so normalization is held to 1 ulp."""
    x = np.random.default_rng(42).random((4, 8, 8, 3), dtype=np.float32)
    got = taug.normalize_images(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaug.normalize_images(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    assert taug.IMAGENET_MEAN == jaug.IMAGENET_MEAN
    assert taug.IMAGENET_STD == jaug.IMAGENET_STD


@pytest.mark.parametrize("cols", [1, 4])
def test_metrics_match_jax(cols):
    rng = np.random.default_rng(43)
    outputs = rng.standard_normal((50, cols)).astype(np.float32)
    targets = rng.integers(0, max(cols, 2), 50)
    assert tmetrics.compute_metrics(outputs, targets) == \
        jmetrics.compute_metrics(outputs, targets)
