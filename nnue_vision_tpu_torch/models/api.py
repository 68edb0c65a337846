"""Object-style model facade over the port's modules (port of
`nnue_vision_tpu/models/api.py`).

Upstream-style ergonomics (`model = NNUE(feature_set=..., l1_size=...)`,
`model(images)`, `model.count_parameters()`, nnue.py:447-526 upstream):
each facade holds its config and an `nn.Module` (`.module`) on `device`,
the card unless the caller names another (raises without one). `seed`
seeds an explicit `torch.Generator` for the init; `params=` (and, for an
EtinyNet, `batch_stats=`) take the JAX package's numpy pytrees instead,
through `bridge.py`. `.params` / `.batch_stats` give them back in that
layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nnue_vision_tpu_torch.bridge import (
    etinynet_from_jax,
    etinynet_to_numpy,
    nnue_from_jax_params,
    nnue_to_numpy,
)
from nnue_vision_tpu_torch.models import etinynet as _etiny
from nnue_vision_tpu_torch.models import nnue as _nnue
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet, NNUEConfig
from nnue_vision_tpu_torch.ops.engine_sim import resolve_device


def _images(images, device: torch.device) -> torch.Tensor:
    """A batch (tensor, numpy or nested lists) as a tensor on `device`."""
    if isinstance(images, torch.Tensor):
        return images.to(device)
    return torch.from_numpy(np.asarray(images, np.float32)).to(device)


class NNUE:
    """NNUE model object: config + module, callable on NHWC image batches."""

    def __init__(
        self,
        feature_set: Optional[GridFeatureSet] = None,
        l1_size: int = _nnue.DEFAULT_L1,
        l2_size: int = _nnue.DEFAULT_L2,
        l3_size: int = _nnue.DEFAULT_L3,
        num_classes: int = 1,
        input_size: int = 32,
        weight_decay: float = 5e-4,
        seed: int = 0,
        params=None,
        device="cuda",
    ):
        if feature_set is None:
            feature_set = GridFeatureSet(10, 8)
        self.cfg = NNUEConfig(
            feature_set=feature_set,
            l1_size=l1_size,
            l2_size=l2_size,
            l3_size=l3_size,
            num_classes=num_classes,
            input_size=input_size,
        )
        self.weight_decay = weight_decay
        self.device = resolve_device(device)
        self.module = (
            nnue_from_jax_params(params, self.cfg, device=self.device)
            if params is not None
            else _nnue.nnue_init(self.cfg, torch.Generator().manual_seed(seed),
                                 device=self.device)
        )

    # -- upstream-style attributes
    @property
    def feature_set(self) -> GridFeatureSet:
        return self.cfg.feature_set

    @property
    def l1_size(self) -> int:
        return self.cfg.l1_size

    @property
    def l2_size(self) -> int:
        return self.cfg.l2_size

    @property
    def l3_size(self) -> int:
        return self.cfg.l3_size

    @property
    def num_classes(self) -> int:
        return self.cfg.num_classes

    @property
    def input_size(self) -> int:
        return self.cfg.input_size

    @property
    def params(self) -> Dict[str, np.ndarray]:
        return nnue_to_numpy(self.module)

    @property
    def visual_threshold(self) -> np.ndarray:
        return self.params["visual_threshold"]

    def set_visual_threshold(self, value: float) -> None:
        with torch.no_grad():
            self.module.visual_threshold.fill_(value)

    def __call__(self, images, return_aux: bool = False):
        return self.module(_images(images, self.device), return_aux=return_aux)

    def count_parameters(self) -> int:
        return _nnue.count_parameters(self.module)

    def quantize(self):
        return _nnue.nnue_quantize(self.module)

    def get_quantized_model_data(self) -> dict:
        """Upstream-shaped quantized dict (nnue.py:541-588)."""
        q = self.quantize()
        return {
            "metadata": {
                "feature_set": self.feature_set,
                "L1": q.l1, "L2": q.l2, "L3": q.l3,
                "num_classes": q.num_classes,
                "nnue2score": q.nnue2score,
                "quantized_one": q.quantized_one,
                "visual_threshold": q.visual_threshold,
            },
            "conv_layer": {"weight": q.conv.weight, "bias": q.conv.bias,
                           "scale": q.conv.scale},
            "feature_transformer": {"weight": q.ft.weight, "bias": q.ft.bias,
                                    "scale": q.ft.scale},
            "classifier": {
                "layers": [
                    {"weight": lay.weight, "bias": lay.bias, "scale": lay.scale}
                    for lay in (q.fc1, q.fc2, q.out)
                ]
            },
        }


def count_mac_operations(cfg: EtinyNetConfig) -> Dict[str, int]:
    """An EtinyNet's multiply-adds per inference: {"conv",
    "feature_transformer", "linear", "total"}, by the rule of
    `benchmarks/mcu_simulation.py`'s `count_mac_operations`: the stem at
    stride 2, each block's pw-expand at its input's size, its depthwise
    and pw-project at the strided size (ceil division), the final 1×1
    conv and the classifier."""
    h = w = cfg.input_size if isinstance(cfg.input_size, int) else cfg.input_size[0]
    t = cfg.table
    h, w = (h + 1) // 2, (w + 1) // 2  # stem stride 2
    conv = t["conv_channels"] * 3 * 9 * h * w
    for _, in_c, mid, out, stride, _ in cfg.block_specs():
        conv += mid * in_c * h * w  # pw expand (pre-stride spatial size)
        h2, w2 = (h + stride - 1) // stride, (w + stride - 1) // stride
        conv += mid * 9 * h2 * w2  # depthwise
        conv += out * mid * h2 * w2  # pw project
        h, w = h2, w2
    conv += t["final_channels"] * t["stage4"][-1][2] * h * w  # final 1x1
    linear = t["final_channels"] * cfg.num_classes
    return {"conv": conv, "feature_transformer": 0, "linear": linear,
            "total": conv + linear}


class EtinyNet:
    """EtinyNet model object (variant tables per upstream nnue.py:199-296)."""

    def __init__(
        self,
        variant: str = "1.0",
        num_classes: int = 1000,
        input_size: int = 112,
        weight_decay: float = 1e-4,
        use_asq: bool = False,
        asq_bits: int = 4,
        seed: int = 0,
        params=None,
        batch_stats=None,
        device="cuda",
    ):
        self.cfg = EtinyNetConfig(
            variant=variant,
            num_classes=num_classes,
            input_size=input_size,
            use_asq=use_asq,
            asq_bits=asq_bits,
        )
        self.weight_decay = weight_decay
        self.device = resolve_device(device)
        self.module = (
            etinynet_from_jax(params, batch_stats, self.cfg, device=self.device)
            if params is not None
            else _etiny.etinynet_init(self.cfg, torch.Generator().manual_seed(seed),
                                      device=self.device)
        )

    @property
    def variant(self) -> str:
        return self.cfg.variant

    @property
    def num_classes(self) -> int:
        return self.cfg.num_classes

    @property
    def input_size(self) -> int:
        return self.cfg.input_size

    @property
    def use_asq(self) -> bool:
        return self.cfg.use_asq

    @property
    def final_channels(self) -> int:
        return self.cfg.table["final_channels"]

    @property
    def configs(self) -> dict:
        return dict(self.cfg.table)

    @property
    def params(self):
        return etinynet_to_numpy(self.module)[0]

    @property
    def batch_stats(self):
        return etinynet_to_numpy(self.module)[1]

    def __call__(self, images, train: bool = False):
        """Logits; `train=True` normalizes with the batch's statistics and
        updates the running ones, as the JAX facade keeps its new
        batch_stats."""
        return self.module.train(train)(_images(images, self.device))

    def count_parameters(self) -> int:
        return _etiny.count_parameters(self.module)

    def count_flops(self) -> int:
        """Approximate multiply-adds for one forward pass (the upstream CLI
        calls a nonexistent count_flops — serialize.py:904 upstream — this
        implements it)."""
        return count_mac_operations(self.cfg)["total"]

    def quantize(self):
        return _etiny.etinynet_quantize(self.module)
