"""EtinyNet (LB / DLB tinyML CNN) as a torch module, and its quantization to
the shared `.etiny` format.

Port of `nnue_vision_tpu/models/etinynet.py:44-287, 366-501, 509-676`: the
same variant tables and `block_specs`, the same init distributions, the
same forward (stem conv 3×3 s2 → BN → ReLU6; per block pw-expand → BN →
ReLU6 → dw 3×3 → BN → ReLU6 → pw-project → BN, a residual when stride 1
and in == out, and for dense stages a 1×1 projection of [identity, h];
final 1×1 conv → BN → ReLU6 → global mean → linear), and the same
quantizer, so a model makes the same `.etiny` bytes in both packages.

Parameters keep the JAX package's layouts (convs HWIO, depthwise
(3, 3, 1, mid), the classifier (classes, final)), so the bridge is a copy
and the quantizer reads what it reads there. Activations are NHWC; the
3×3 convs run as `F.conv2d` on an NCHW view, the 1×1 convs as matmuls.

BatchNorm is written out: the JAX package normalizes with the *biased*
batch variance and updates the running statistics with it, `new = 0.9·old
+ 0.1·batch` (`F.batch_norm` would use the unbiased one). The statistics
and the affine run in float32 and the output is cast back to the
activation dtype. The running statistics are buffers, updated in place by
a forward in training mode (`model.train()`), which is what JAX's
`new_stats` carries out of `etinynet_apply`.

With `dtype="bfloat16"` the convs and matmuls take bf16 operands (cast
explicitly at each, as JAX does; no autocast), while params, the norm
statistics and the logits stay float32. ReLU6 is `_clip` (jnp.clip's half
gradient at a bound).

`engine_friendly=True` (LSQ quantizers, scale-only norms, progressive QAT)
is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nnue_vision_tpu_torch.formats import (
    QConv,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
)
from nnue_vision_tpu_torch.models.nnue import _clip
from nnue_vision_tpu_torch.quantize import quantize_bias_i32, quantize_weight_i8

ETINYNET_VARIANTS = {
    "1.0": {
        "conv_channels": 32,
        "stage1": [(32, 32, 32)] * 4,
        "stage2": [(32, 128, 128)] + [(128, 128, 128)] * 3,
        "stage3": [(128, 192, 192)] + [(192, 192, 192)] * 2,
        "stage4": [(192, 256, 256)] + [(256, 256, 256)] * 1,
        "final_channels": 1280,
    },
    "0.75": {
        "conv_channels": 24,
        "stage1": [(24, 24, 24)] * 3,
        "stage2": [(24, 96, 96)] + [(96, 96, 96)] * 2,
        "stage3": [(96, 144, 144)] + [(144, 144, 144)] * 2,
        "stage4": [(144, 192, 192)] + [(192, 192, 192)] * 1,
        "final_channels": 960,
    },
    "0.98M": {
        "conv_channels": 28,
        "stage1": [(28, 28, 28)] * 3,
        "stage2": [(28, 112, 112)] + [(112, 112, 112)] * 2,
        "stage3": [(112, 168, 168)] + [(168, 168, 168)] * 2,
        "stage4": [(168, 224, 224)] + [(224, 224, 224)] * 1,
        "final_channels": 1120,
    },
    "micro": {
        "conv_channels": 8,
        "stage1": [(8, 8, 8)],
        "stage2": [(8, 16, 16), (16, 16, 16)],
        "stage3": [(16, 24, 24), (24, 24, 24)],
        "stage4": [(24, 32, 32), (32, 32, 32)],
        "final_channels": 128,
    },
}

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class EtinyNetConfig:
    """The JAX package's EtinyNetConfig, field for field (checkpoints
    carry it as a dict)."""
    variant: str = "1.0"
    num_classes: int = 1000
    input_size: int = 112
    use_asq: bool = False
    asq_bits: int = 4
    dtype: str = "float32"
    engine_friendly: bool = False
    ef_quantizers: bool = True

    @property
    def table(self) -> dict:
        if self.variant not in ETINYNET_VARIANTS:
            raise ValueError(f"unknown EtinyNet variant: {self.variant}")
        return ETINYNET_VARIANTS[self.variant]

    def block_specs(self) -> List[Tuple[str, int, int, int, int, bool]]:
        """[(kind, in, mid, out, stride, dense)] in forward order; the first
        block of every stage has stride 2, stages 3-4 are dense."""
        t = self.table
        specs = []
        prev = t["conv_channels"]
        for stage, dense in (("stage1", False), ("stage2", False),
                             ("stage3", True), ("stage4", True)):
            for i, (_, mid, out) in enumerate(t[stage]):
                stride = 2 if i == 0 else 1
                specs.append(("dlb" if dense else "lb", prev, mid, out, stride,
                              dense))
                prev = out
        return specs


def _check_config(cfg: EtinyNetConfig) -> None:
    if cfg.engine_friendly:
        raise NotImplementedError(
            "EtinyNet engine_friendly=True (LSQ quantizers, scale-only norms, "
            "progressive QAT) is not ported to nnue_vision_tpu_torch yet "
            "(ROADMAP Queue A item 5a)")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}: {cfg.dtype!r}")


class BatchNorm(nn.Module):
    """JAX's `_batch_norm` over NHWC: params `scale`, `bias`; running
    statistics `mean`, `var` as buffers."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.var(dim=(0, 1, 2), unbiased=False)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean.detach())
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS)
        y = (xf - mean) * (inv * self.scale) + self.bias
        return y.to(x.dtype)


class Block(nn.Module):
    """One LB / DLB block's params (HWIO weights) and norms."""

    def __init__(self, in_c: int, mid: int, out: int, dense_proj: bool,
                 device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.pw_expand_w = p(1, 1, in_c, mid)
        self.bn1 = BatchNorm(mid, device)
        self.dw_w = p(3, 3, 1, mid)
        self.bn2 = BatchNorm(mid, device)
        self.pw_project_w = p(1, 1, mid, out)
        self.bn3 = BatchNorm(out, device)
        if dense_proj:
            self.dense_proj_w = p(1, 1, in_c + out, out)
            self.dense_bn = BatchNorm(out, device)


def _pw(x: torch.Tensor, w_hwio: torch.Tensor, dtype) -> torch.Tensor:
    """1×1 conv on NHWC as a matmul over channels."""
    return x @ w_hwio[0, 0].to(dtype)


def _conv3x3(x: torch.Tensor, w_hwio: torch.Tensor, dtype, stride: int,
             groups: int = 1) -> torch.Tensor:
    """3×3 pad-1 conv on NHWC with an HWIO (or (3, 3, 1, C) depthwise)
    weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.to(dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=1, groups=groups)
    return y.permute(0, 2, 3, 1)


class EtinyNet(nn.Module):
    """forward((B, H, W, 3) float) → logits (B, classes) float32. In
    training mode the norms use batch statistics and update their running
    ones; in eval mode they use the running ones."""

    def __init__(self, cfg: EtinyNetConfig, device=None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        t = cfg.table
        specs = cfg.block_specs()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.stem_w = p(3, 3, 3, t["conv_channels"])
        self.stem_bn = BatchNorm(t["conv_channels"], device)
        self.blocks = nn.ModuleList(
            Block(in_c, mid, out, dense and stride == 1 and in_c == out, device)
            for _, in_c, mid, out, stride, dense in specs)
        self.final_w = p(1, 1, specs[-1][3], t["final_channels"])
        self.final_bn = BatchNorm(t["final_channels"], device)
        self.cls_w = p(cfg.num_classes, t["final_channels"])
        self.cls_b = p(cfg.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        x = images.to(dtype)
        x = self.stem_bn(_conv3x3(x, self.stem_w, dtype, stride=2))
        x = _clip(x, 0.0, 6.0)
        for (_, in_c, mid, out, stride, dense), bp in zip(cfg.block_specs(),
                                                          self.blocks):
            identity = x
            h = _clip(bp.bn1(_pw(x, bp.pw_expand_w, dtype)), 0.0, 6.0)
            h = _conv3x3(h, bp.dw_w, dtype, stride=stride, groups=mid)
            h = _clip(bp.bn2(h), 0.0, 6.0)
            h = bp.bn3(_pw(h, bp.pw_project_w, dtype))
            if stride == 1 and in_c == out:
                h = h + identity
                if dense:
                    cat = torch.cat([identity, h], dim=-1)
                    h = bp.dense_bn(_pw(cat, bp.dense_proj_w, dtype))
            x = h
        x = _clip(self.final_bn(_pw(x, self.final_w, dtype)), 0.0, 6.0)
        x = x.mean(dim=(1, 2))
        logits = x @ self.cls_w.T.to(dtype) + self.cls_b.to(dtype)
        return logits.to(torch.float32)


def etinynet_init(cfg: EtinyNetConfig, generator: torch.Generator,
                  device=None) -> EtinyNet:
    """A new `EtinyNet` with the JAX package's init distributions
    (etinynet.py:161-237): every conv U(±1/√fan_in) with fan_in = kh·kw·in
    of its HWIO shape, norms at scale 1, bias 0, running mean 0, var 1, the
    classifier's weight and bias U(±1/√final). Drawn on the host from
    `generator`, so a seed gives the same model on every device; the stream
    differs from `jax.random`'s."""
    model = EtinyNet(cfg)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias"):
                continue  # norm params keep their init
            if leaf in ("cls_w", "cls_b"):
                fan_in = cfg.table["final_channels"]
            else:
                fan_in = prm.shape[0] * prm.shape[1] * prm.shape[2]
            bound = 1.0 / math.sqrt(max(1, fan_in))
            u = torch.rand(prm.shape, generator=generator, dtype=torch.float32)
            prm.copy_(u * (2 * bound) - bound)
    return model.to(device)


def count_parameters(model: nn.Module) -> int:
    """Number of parameter values (the running statistics excluded), like
    the JAX package's count over its params pytree."""
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# quantization → QuantizedEtinyNet
# ---------------------------------------------------------------------------


def _fold_bn(w_hwio: np.ndarray, bn_p: Dict, bn_s: Dict):
    """Fold inference-time BN into the preceding conv: w·k and b - m·k
    with k = g/√(v+eps), in float64."""
    g = np.asarray(bn_p["scale"], np.float64)
    b = np.asarray(bn_p["bias"], np.float64)
    m = np.asarray(bn_s["mean"], np.float64)
    v = np.asarray(bn_s["var"], np.float64)
    k = g / np.sqrt(v + BN_EPS)
    return np.asarray(w_hwio, np.float64) * k, b - m * k


# every block boundary carries 16× its float value
_GAIN = 16


def etinynet_quantize(model: EtinyNet) -> QuantizedEtinyNet:
    """float model → engine-domain QuantizedEtinyNet, the JAX package's
    `etinynet_quantize` (etinynet.py:529-676) on the same numpy arrays:
    BN folded into stem and pw-expand with their biases, into dw and
    pw-project as scales only; the stem at weight scale 16 (output at 16·v),
    pw-expand at 64 with divisor 64·16, dw at 64, pw-project divisor 4, the
    classifier at 1024; stride-2 dense blocks tagged as plain LB; the final
    1×1 conv + BN + ReLU6 as a synthetic block (folded conv, identity
    depthwise, amplifying identity projection)."""
    from nnue_vision_tpu_torch.bridge import etinynet_to_numpy

    cfg = model.cfg
    p, s = etinynet_to_numpy(model)
    t = cfg.table

    stem_w, stem_b = _fold_bn(p["stem_w"], p["stem_bn"], s["stem_bn"])
    stem = QConv(
        weight=quantize_weight_i8(np.transpose(stem_w, (3, 2, 0, 1)),
                                  scale=float(_GAIN)),
        bias=quantize_bias_i32(stem_b, scale=64.0 * _GAIN),
    )
    # a plain model carries no LSQ scales: the JAX quantizer's folds of
    # them divide and multiply by exact ones, left out here
    blocks = []
    alpha = _GAIN
    for (_, _, _, _, stride, dense), bp, bs in zip(
            cfg.block_specs(), p["blocks"], s["blocks"]):
        pw_e, pw_e_bias = _fold_bn(bp["pw_expand_w"], bp["bn1"], bs["bn1"])
        dw, _ = _fold_bn(bp["dw_w"], bp["bn2"], bs["bn2"])
        pw_p, _ = _fold_bn(bp["pw_project_w"], bp["bn3"], bs["bn3"])
        s_expand = 64.0 * alpha
        blocks.append(QLBBlock(
            pw_expand=quantize_weight_i8(pw_e[0, 0].T),
            dw=quantize_weight_i8(np.transpose(dw[:, :, 0, :], (2, 0, 1))),
            pw_project=quantize_weight_i8(pw_p[0, 0].T),
            stride=stride,
            is_dense=bool(dense and stride == 1),
            pw_expand_scale=s_expand,
            dw_scale=64.0,
            pw_project_scale=64.0 / _GAIN,
            pw_expand_bias=quantize_bias_i32(pw_e_bias, scale=s_expand),
        ))
        alpha = _GAIN

    fin = t["final_channels"]
    final_w, final_b = _fold_bn(p["final_w"], p["final_bn"], s["final_bn"])
    dw_identity = np.zeros((fin, 3, 3), np.int8)
    dw_identity[:, 1, 1] = 64
    s_expand = 64.0 * alpha
    blocks.append(QLBBlock(
        pw_expand=quantize_weight_i8(final_w[0, 0].T),
        dw=dw_identity,
        pw_project=quantize_weight_i8(np.eye(fin)),
        stride=1,
        is_dense=False,
        pw_expand_scale=s_expand,
        dw_scale=64.0,
        pw_project_scale=64.0 / _GAIN,
        pw_expand_bias=quantize_bias_i32(final_b, scale=s_expand),
    ))

    return QuantizedEtinyNet(
        variant=cfg.variant,
        num_classes=cfg.num_classes,
        input_size=cfg.input_size,
        conv_channels=t["conv_channels"],
        final_channels=fin,
        stem=stem,
        blocks=blocks,
        classifier=QLinear(
            weight=quantize_weight_i8(p["cls_w"]),
            bias=quantize_bias_i32(p["cls_b"], scale=64.0 * _GAIN),
            scale=64.0 * _GAIN,
        ),
        use_asq=cfg.use_asq,
        asq_bits=cfg.asq_bits,
    ).validate()
