"""NNUE for vision as a torch `nn.Module` (init, forward, quantization).

Port of `nnue_vision_tpu/models/nnue.py:60-476`. `NNUE.forward` is the JAX
package's `nnue_apply` (float and `qat` paths, `return_aux`): the binary
feature mask is the feature vector, the feature transformer is one dense
masked matmul, and the geometry follows the engine's stride rule and flat
placement of the conv output into the grid buffer, so the model computes
the features the int8 engine computes. The threshold compare goes through
`binary_activation_ste`, whose backward is the JAX package's custom VJP,
and the QAT clamps split the gradient at a bound as `jnp.clip` does.

The parameters carry the JAX package's names and layouts (`conv_w` OIHW,
`ft_w` (F, L1), `fc*_w` (out, in), `visual_threshold` (C,), the scalar
`nnue2score`), so `bridge.py` moves them across unchanged. `nnue2score` is
a parameter, as it is a leaf of the JAX params pytree: no loss reaches it,
but the optimizer's weight decay does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nnue_vision_tpu_torch.formats import (
    QConv,
    QFeatureTransformer,
    QLinear,
    QuantizedNNUE,
)
from nnue_vision_tpu_torch.quantize import (
    QUANT_SCALE,
    clip_unit,
    quantize_bias_i32,
    quantize_weight_i8,
)
from nnue_vision_tpu_torch.ops.engine_sim import engine_conv_stride, resolve_device

DEFAULT_L1 = 1024
DEFAULT_L2 = 128
DEFAULT_L3 = 32

_WEIGHTS = ("ft_w", "fc1_w", "fc2_w", "out_w")


@dataclasses.dataclass(frozen=True)
class LossParams:
    """Score-space loss shaping constants (nnue.py:60-73 of the JAX package;
    declared for config compatibility, the trainer uses cross-entropy)."""

    in_offset: float = 270.0
    out_offset: float = 270.0
    in_scaling: float = 340.0
    out_scaling: float = 380.0
    start_lambda: float = 1.0
    end_lambda: float = 1.0
    pow_exp: float = 2.5
    qp_asymmetry: float = 0.0


@dataclasses.dataclass(frozen=True)
class GridFeatureSet:
    """Grid-based feature set (reference nnue.py:81-91)."""

    grid_size: int = 10
    num_features_per_square: int = 8

    @property
    def num_features(self) -> int:
        return self.grid_size * self.grid_size * self.num_features_per_square


@dataclasses.dataclass(frozen=True)
class NNUEConfig:
    feature_set: GridFeatureSet = GridFeatureSet()
    l1_size: int = DEFAULT_L1
    l2_size: int = DEFAULT_L2
    l3_size: int = DEFAULT_L3
    num_classes: int = 10
    input_size: int = 32
    # Keep activations in the engine's quantized dynamic range (clipped ReLU
    # to [0,1] in float ≙ [0,127] int); with qat_rounding also fake-quantize
    # weights and biases to the serialized values.
    qat: bool = False
    qat_rounding: bool = True

    @property
    def conv_stride(self) -> int:
        return engine_conv_stride(self.input_size, self.feature_set.grid_size)

    @property
    def conv_out_hw(self) -> int:
        return (self.input_size + 2 - 3) // self.conv_stride + 1


class BinaryActivationSTE(torch.autograd.Function):
    """Hard threshold forward, straight-through backward (the JAX package's
    `binary_activation_ste` custom VJP, nnue.py:122-145).

    x: (B, H, W, C); threshold: (C,), broadcast per channel. Forward:
    (x > t) as x's dtype. Backward: dL/dx = g; dL/dt = -sum over B, H, W of
    g·k·σ'(k(x - t)) with k = 10.
    """

    @staticmethod
    def forward(ctx, x, threshold):
        ctx.save_for_backward(x, threshold)
        return (x > threshold).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, threshold = ctx.saved_tensors
        k = 10.0
        sig = torch.sigmoid(k * (x - threshold))
        grad_t = -(g * k * sig * (1.0 - sig)).sum(dim=(0, 1, 2))
        return g, grad_t.to(threshold.dtype)


def binary_activation_ste(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return BinaryActivationSTE.apply(x, threshold)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip`: max then min, which pass half the gradient to a value
    that equals a bound (`torch.clamp` passes all of it), to `x` and to a
    bound that is a tensor (per channel, broadcast against `x`). A float
    bound becomes a 0-dim CPU tensor, which a CUDA operand takes as a
    scalar: no copy."""
    lo_t = lo if isinstance(lo, torch.Tensor) else torch.tensor(lo, dtype=x.dtype)
    hi_t = hi if isinstance(hi, torch.Tensor) else torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _wq(w: torch.Tensor, scale: float) -> torch.Tensor:
    """Weight fake-quantization round(clip(w)·scale)/scale, straight-through."""
    q = torch.round(torch.clamp(w, -1.0, 1.0) * scale) / scale
    return w + (q - w).detach()


def _bq(b: torch.Tensor, scale: float) -> torch.Tensor:
    """Bias fake-quantization (int32 slot: rounded, never clipped)."""
    q = torch.round(b * scale) / scale
    return b + (q - b).detach()


class NNUE(nn.Module):
    """Conv frontend → binary grid features → FT → pairwise → dense head.

    `forward(images)` takes (B, H, W, 3) float NHWC and returns logits
    (B, classes) float32; with `return_aux=True` also
    {"density": (B,), "mask": (B, F)}.
    """

    def __init__(self, cfg: NNUEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        fs = cfg.feature_set
        ch, l1, l2, l3 = (fs.num_features_per_square, cfg.l1_size,
                          cfg.l2_size, cfg.l3_size)

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.conv_w = p(ch, 3, 3, 3)  # OIHW
        self.visual_threshold = p(ch)
        self.ft_w = p(fs.num_features, l1)
        self.ft_b = p(l1)
        self.fc1_w = p(l2, l1)
        self.fc1_b = p(l2)
        self.fc2_w = p(l3, l2)
        self.fc2_b = p(l3)
        self.out_w = p(cfg.num_classes, l3)
        self.out_b = p(cfg.num_classes)
        self.nnue2score = nn.Parameter(torch.tensor(600.0, device=device))

    def _qat_params(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        p = {name: t for name, t in self.named_parameters()}
        if not (cfg.qat and cfg.qat_rounding):
            return p
        half = cfg.l1_size // 2
        # conv weights are not clipped by the reference; quantize on the
        # ±127/64 representable grid
        cw = p["conv_w"]
        cq = torch.round(torch.clamp(cw, -127 / 64, 127 / 64) * 64) / 64
        p["conv_w"] = cw + (cq - cw).detach()
        p["ft_w"] = _wq(p["ft_w"], 64)
        p["ft_b"] = _bq(p["ft_b"], 64)
        p["fc1_w"] = torch.cat(
            [_wq(p["fc1_w"][:, :half], 64), _wq(p["fc1_w"][:, half:], 32)],
            dim=1,
        )
        p["fc1_b"] = _bq(p["fc1_b"], 2048)
        p["fc2_w"] = _wq(p["fc2_w"], 64)
        p["fc2_b"] = _bq(p["fc2_b"], 4096)
        p["out_w"] = _wq(p["out_w"], 64)
        p["out_b"] = _bq(p["out_b"], 4096)
        return p

    def forward(self, images: torch.Tensor, return_aux: bool = False):
        cfg = self.cfg
        fs = cfg.feature_set
        p = self._qat_params()
        x = images.to(torch.float32)

        thresh = p["visual_threshold"]
        deployed_thresh = None
        if cfg.qat:
            # Serialization collapses the per-channel thresholds to their
            # mean, so train the compare against that same scalar.
            deployed_thresh = thresh.mean(dim=0, keepdim=True)
            thresh = deployed_thresh.expand(thresh.shape)

        # Conv frontend, engine geometry; back to NHWC for the flat order.
        conv = F.conv2d(
            x.permute(0, 3, 1, 2), p["conv_w"],
            stride=cfg.conv_stride, padding=1,
        ).permute(0, 2, 3, 1)
        mask = binary_activation_ste(conv, thresh)

        # Engine flat placement: (B, oh, ow, C) → (B, F) with zero tail.
        b = mask.shape[0]
        flat = mask.reshape(b, -1)
        pad = fs.num_features - flat.shape[1]
        if cfg.qat and pad > 0:
            # The engine thresholds the whole zero-filled buffer: the tail
            # is active whenever the threshold is negative.
            tail = binary_activation_ste(
                x.new_zeros((b, 1, pad, 1)), deployed_thresh
            ).reshape(b, pad)
            features = torch.cat([flat, tail], dim=1)
        else:
            features = F.pad(flat, (0, pad))

        ft = features @ p["ft_w"] + p["ft_b"]
        half = cfg.l1_size // 2
        if cfg.qat:
            # int16 FT clipped to [0,127] at scale 64, pairwise products at
            # scale 32, hidden activations int8 [0,127] at scale 64.
            ft = _clip(ft, 0.0, 127.0 / 64.0)
            a, bb = ft[:, :half], ft[:, half:]
            l0 = torch.cat([_clip(a * bb, 0.0, 127.0 / 32.0), a], dim=1)
            h1 = _clip(self._linear(l0, p, "fc1"), 0.0, 127.0 / 64.0)
            h2 = _clip(self._linear(h1, p, "fc2"), 0.0, 127.0 / 64.0)
        else:
            # Reference float semantics: unclamped pairwise + ReLU.
            a, bb = ft[:, :half], ft[:, half:]
            l0 = torch.cat([a * bb, a], dim=1)
            h1 = torch.relu(self._linear(l0, p, "fc1"))
            h2 = torch.relu(self._linear(h1, p, "fc2"))
        logits = self._linear(h2, p, "out")

        if return_aux:
            density = features.sum(dim=1) / fs.num_features
            return logits, {"density": density, "mask": features}
        return logits

    @staticmethod
    def _linear(x, p, name):
        return x @ p[f"{name}_w"].T + p[f"{name}_b"]


def nnue_init(cfg: NNUEConfig, generator: torch.Generator, device="cuda"
              ) -> NNUE:
    """A new `NNUE` with the JAX package's init distributions (nnue.py:157-184):
    fan-in uniform conv and dense weights and biases, FT weights N(0, 0.1²),
    FT bias 0, threshold 0.1 per channel, nnue2score 600.

    Drawn on the host from `generator` (a CPU `torch.Generator`), so a seed
    gives the same model on every device; the streams differ from
    `jax.random`'s, so tests hand both packages numpy-made params. Built on
    `device`: the card unless the caller names another (raises without one).
    """
    fs = cfg.feature_set
    ch, l1, l2, l3, nc = (fs.num_features_per_square, cfg.l1_size,
                          cfg.l2_size, cfg.l3_size, cfg.num_classes)

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (2 * bound) - bound

    params = {
        "conv_w": uniform((ch, 3, 3, 3), 27),
        "visual_threshold": torch.full((ch,), 0.1),
        "ft_w": torch.randn((fs.num_features, l1), generator=generator) * 0.1,
        "ft_b": torch.zeros(l1),
        "fc1_w": uniform((l2, l1), l1),
        "fc1_b": uniform((l2,), l1),
        "fc2_w": uniform((l3, l2), l2),
        "fc2_b": uniform((l3,), l2),
        "out_w": uniform((nc, l3), l3),
        "out_b": uniform((nc,), l3),
        "nnue2score": torch.tensor(600.0),
    }
    model = NNUE(cfg, device=resolve_device(device))
    model.load_state_dict(params)
    return model


def nnue_clip_weights(model: NNUE) -> NNUE:
    """Clamp FT + classifier weights to [-1, 1] (nnue.py:528-539), in place
    (the JAX package returns a new pytree)."""
    with torch.no_grad():
        for name in _WEIGHTS:
            getattr(model, name).clamp_(-1.0, 1.0)
    return model


def nnue_quantize(model: NNUE) -> QuantizedNNUE:
    """float model → engine-domain QuantizedNNUE (serialize-ready).

    The JAX package's engine-faithful scheme, computed with the same numpy
    expressions on the same numpy arrays so the `.nnue` bytes are identical
    (a torch mean sums in another order than `np.mean`):
    FT and fc2/out weights at 64, fc1 product columns at 64 and linear
    columns at 32, biases at 64/2048/4096/4096, file scales 32/64/4096, the
    threshold as the channel mean times 64.
    """
    from nnue_vision_tpu_torch.bridge import nnue_to_numpy

    cfg = model.cfg
    p = nnue_to_numpy(model)
    fs = cfg.feature_set
    half = cfg.l1_size // 2

    fc1_w = clip_unit(p["fc1_w"])
    fc1_q = np.concatenate(
        [
            quantize_weight_i8(fc1_w[:, :half], scale=64.0),
            quantize_weight_i8(fc1_w[:, half:], scale=32.0),
        ],
        axis=1,
    )
    return QuantizedNNUE(
        grid_size=fs.grid_size,
        num_features_per_square=fs.num_features_per_square,
        l1=cfg.l1_size,
        l2=cfg.l2_size,
        l3=cfg.l3_size,
        nnue2score=float(p["nnue2score"]),
        visual_threshold=float(np.mean(p["visual_threshold"])) * 64.0,
        conv=QConv(
            weight=quantize_weight_i8(p["conv_w"]),
            bias=np.zeros(fs.num_features_per_square, np.int32),
        ),
        ft=QFeatureTransformer(
            weight=quantize_weight_i8(clip_unit(p["ft_w"])).astype(np.int16),
            bias=quantize_bias_i32(p["ft_b"]),
        ),
        fc1=QLinear(
            weight=fc1_q,
            bias=quantize_bias_i32(p["fc1_b"], scale=2048.0),
            scale=32.0,
        ),
        fc2=QLinear(
            weight=quantize_weight_i8(clip_unit(p["fc2_w"])),
            bias=quantize_bias_i32(p["fc2_b"], scale=4096.0),
            scale=64.0,
        ),
        out=QLinear(
            weight=quantize_weight_i8(clip_unit(p["out_w"])),
            bias=quantize_bias_i32(p["out_b"], scale=4096.0),
            scale=4096.0,
        ),
    ).validate()


def nnue_from_quantized(q: QuantizedNNUE, device="cuda") -> NNUE:
    """Dequantize a QuantizedNNUE back into a float model on `device` (the
    card unless the caller names another; raises without one)."""
    from nnue_vision_tpu_torch.bridge import nnue_from_jax_params

    cfg = NNUEConfig(
        feature_set=GridFeatureSet(q.grid_size, q.num_features_per_square),
        l1_size=q.l1,
        l2_size=q.l2,
        l3_size=q.l3,
        num_classes=q.num_classes,
    )
    s = np.float32(QUANT_SCALE)
    half = q.l1 // 2
    fc1 = np.asarray(q.fc1.weight, np.float32)
    # invert the faithful column scaling: product columns at 64, linear at 32
    fc1_w = np.concatenate([fc1[:, :half] / 64.0, fc1[:, half:] / 32.0], axis=1)
    params = {
        "conv_w": np.asarray(q.conv.weight, np.float32) / s,
        "visual_threshold": np.full(
            (q.num_features_per_square,), q.visual_threshold / 64.0, np.float32
        ),
        "ft_w": np.asarray(q.ft.weight, np.float32) / s,
        "ft_b": np.asarray(q.ft.bias, np.float32) / s,
        "fc1_w": fc1_w.astype(np.float32),
        "fc1_b": np.asarray(q.fc1.bias, np.float32) / np.float32(2048.0),
        "fc2_w": np.asarray(q.fc2.weight, np.float32) / s,
        "fc2_b": np.asarray(q.fc2.bias, np.float32) / np.float32(4096.0),
        "out_w": np.asarray(q.out.weight, np.float32) / s,
        "out_b": np.asarray(q.out.bias, np.float32) / np.float32(4096.0),
        "nnue2score": np.float32(q.nnue2score),
    }
    return nnue_from_jax_params(params, cfg, device=device)


def count_parameters(model: NNUE) -> int:
    """Number of values in the model, `nnue2score` included, like the JAX
    package's count over its params pytree."""
    return sum(t.numel() for t in model.state_dict().values())
