"""EtinyNet (LB / DLB tinyML CNN) as a torch module, and its quantization to
the shared `.etiny` format.

Port of `nnue_vision_tpu/models/etinynet.py:44-676`: the same variant tables
and `block_specs`, the same init distributions, the same forward (stem
conv 3×3 s2 → BN → ReLU6; per block pw-expand → BN → ReLU6 → dw 3×3 → BN →
ReLU6 → pw-project → BN, a residual when stride 1 and in == out, and for
dense stages a 1×1 projection of [identity, h]; final 1×1 conv → BN →
ReLU6 → global mean → linear), and the same quantizer, so a model makes
the same `.etiny` bytes in both packages.

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

`engine_friendly=True` trains the function the int8 engine computes: no
residual or dense path (their params stay in the module, unused), the
dw and pw-project norms scale-only (`BatchNorm.scale_only`, the running
mean square kept in `var`), and per-channel LSQ activation scales
`exp(qlog1)`, `exp(qlog2)` and `exp(final_qlog)`. With `ef_quantizers`
(the default) the weights are fake-quantized on the serializer's folded
int8 grids and the activations on the engine's 7-level and 1/16 grids,
straight through; without it the model keeps the engine's clamp ranges but
stays continuous, which is the warm-up function of progressive QAT
(`training/loop.py`, `ef_warmup_epochs`). The quantizer folds the LSQ
scales into the convs, so the `.etiny` format is unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
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
from nnue_vision_tpu_torch.ops.engine_sim import resolve_device
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

    def __post_init__(self):
        if (self.engine_friendly and self.ef_quantizers
                and self.dtype != "float32"):
            # the quantizer grids are the serializer's float32 ones
            warnings.warn(
                "engine_friendly QAT with dtype="
                f"{self.dtype!r}: the quantizer grids are defined in "
                "float32 — deployed bit-exactness is only validated for "
                "dtype='float32'",
                stacklevel=2,
            )

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

    def scale_only(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's `_rms_norm`: y = x·g·rsqrt(E[x²] + eps), foldable into the
        conv before it as a per-channel scale. The running mean square is
        kept in `var`; `mean` and `bias` are not used."""
        xf = x.to(torch.float32)
        if self.training:
            ms = (xf * xf).mean(dim=(0, 1, 2))
            with torch.no_grad():
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * ms.detach())
        else:
            ms = self.var
        y = xf * (self.scale * torch.rsqrt(ms + BN_EPS))
        return y.to(x.dtype)


class Block(nn.Module):
    """One LB / DLB block's params (HWIO weights) and norms."""

    def __init__(self, in_c: int, mid: int, out: int, dense_proj: bool,
                 engine_friendly: bool = False, device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.pw_expand_w = p(1, 1, in_c, mid)
        self.bn1 = BatchNorm(mid, device)
        if engine_friendly:
            # pre-activations start inside the 7-level [0, 6] grid, and the
            # LSQ scales (log space) at 1
            with torch.no_grad():
                self.bn1.bias.fill_(1.5)
            self.qlog1 = p(mid)
            self.qlog2 = p(mid)
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


# ---------------------------------------------------------------------------
# engine_friendly quantizers (JAX etinynet.py:290-363)
# ---------------------------------------------------------------------------

# the engine's block boundary: ±127 at 16× the value
_GRID16_LIM = 127.0 / 16.0


def _ste(x: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Straight-through: quantized forward, identity gradient. Written as
    JAX writes it: in float32, x + (q - x) is not always q."""
    return x + (quantized - x).detach()


class _Div(torch.autograd.Function):
    """x / s with JAX's gradient for the divisor, -((g·(1/(s·s)))·x), the
    transpose of its rule (torch computes -g·((x/s)/s)), so an LSQ scale's
    gradient is bit-equal to JAX's before its reduction over the broadcast
    dimensions."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return x / s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        gs = -((g * (1.0 / (s * s))) * x)
        return g / s, gs.sum_to_size(s.shape)


def _wq_folded(w_hwio: torch.Tensor, norm: BatchNorm, scale: float,
               out_mul=None, in_mul=None) -> torch.Tensor:
    """The serializer's int8 grid for w as it is folded, straight through:
    clip(round(w·f·scale), ±127) / (scale·f), f = the norm's gain from its
    RUNNING statistics times `out_mul` per output channel and `in_mul` per
    input channel (the LSQ scales the serializer folds into this conv),
    all without gradient. Call it before the norm runs in this forward: a
    training forward updates the statistics in place, and JAX folds the
    ones from before the step."""
    with torch.no_grad():
        k = norm.scale * torch.rsqrt(norm.var + BN_EPS)
        if out_mul is not None:
            k = k * out_mul
        f = k.reshape(1, 1, 1, -1)  # out-channel is last (HWIO)
        if in_mul is not None:
            f = f * in_mul.reshape(1, 1, -1, 1)
        q = torch.clamp(torch.round(w_hwio * f * scale), -127.0, 127.0) / (scale * f)
    return _ste(w_hwio, q)


def _wq_plain(w: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain int8-grid fake-quantization (the classifier: no norm to fold)."""
    q = torch.clamp(torch.round(w * scale), -127.0, 127.0) / scale
    return _ste(w, q)


def _q_act_lsq(x: torch.Tensor, s: torch.Tensor, round_fn,
               restore=None) -> torch.Tensor:
    """LSQ 7-level activation with a learnable per-channel scale s:
    clip(round_fn(x/s), 0, 6)·s (or ·`restore`, the final block's deployed
    multiplier). The clip comes after the straight-through step, so values
    that sit on the rails 0 and 6 pass half the gradient, as `jnp.clip`
    does; that decides the scale's LSQ gradient."""
    z = _Div.apply(x, s)
    zq = _clip(_ste(z, round_fn(z)), 0.0, 6.0)
    return zq * (s if restore is None else restore)


def _q_grid16(x: torch.Tensor) -> torch.Tensor:
    """Engine block boundary: trunc(16·v)/16, clamped to ±127/16."""
    q = torch.trunc(torch.clamp(x, -_GRID16_LIM, _GRID16_LIM) * 16.0) / 16.0
    return _ste(x, q)


def s3_deploy(s3: torch.Tensor) -> torch.Tensor:
    """The final activation's deployed restore multiplier round(64·s3)/64
    (the amplifier's diagonal), straight through to s3."""
    return _ste(s3, torch.round(s3 * 64.0) / 64.0)


class EtinyNet(nn.Module):
    """forward((B, H, W, 3) float) → logits (B, classes) float32. In
    training mode the norms use batch statistics and update their running
    ones; in eval mode they use the running ones. `cfg` may be replaced
    between forwards by one with another `ef_quantizers` (the warm-up
    switch): the params are the same in both modes."""

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
            Block(in_c, mid, out, dense and stride == 1 and in_c == out,
                  cfg.engine_friendly, device)
            for _, in_c, mid, out, stride, dense in specs)
        self.final_w = p(1, 1, specs[-1][3], t["final_channels"])
        self.final_bn = BatchNorm(t["final_channels"], device)
        if cfg.engine_friendly:
            self.final_qlog = p(t["final_channels"])
        self.cls_w = p(cfg.num_classes, t["final_channels"])
        self.cls_b = p(cfg.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        ef = cfg.engine_friendly
        # q: the quantized mode; ef alone: the engine's structure and clamp
        # ranges, continuous (the warm-up function)
        q = ef and cfg.ef_quantizers
        x = images.to(dtype)

        stem_w = self.stem_w
        if q:  # the serializer's grids: stem at 16, every other conv at 64
            stem_w = _wq_folded(stem_w, self.stem_bn, 16.0)
        x = self.stem_bn(_conv3x3(x, stem_w, dtype, stride=2))
        # the engine's stem has no ReLU6: its output is a block boundary
        if q:
            x = _q_grid16(x)
        elif ef:
            x = _clip(x, -_GRID16_LIM, _GRID16_LIM)
        else:
            x = _clip(x, 0.0, 6.0)

        for (_, in_c, mid, out, stride, dense), bp in zip(cfg.block_specs(),
                                                          self.blocks):
            identity = x
            pw_e_w, dw_w, pw_p_w = bp.pw_expand_w, bp.dw_w, bp.pw_project_w
            if ef:
                s1f, s2f = torch.exp(bp.qlog1), torch.exp(bp.qlog2)
                s1, s2 = s1f.to(dtype), s2f.to(dtype)
            if q:  # all three folds before the block's first norm runs
                pw_e_w = _wq_folded(pw_e_w, bp.bn1, 64.0, out_mul=1.0 / s1f)
                dw_w = _wq_folded(dw_w, bp.bn2, 64.0, out_mul=s1f / s2f)
                pw_p_w = _wq_folded(pw_p_w, bp.bn3, 64.0, in_mul=s2f)
            h = bp.bn1(_pw(x, pw_e_w, dtype))
            if q:
                h = _q_act_lsq(h, s1, torch.round)
            else:
                h = _clip(h, 0.0, 6.0 * s1 if ef else 6.0)
            h = _conv3x3(h, dw_w, dtype, stride=stride, groups=mid)
            h = bp.bn2.scale_only(h) if ef else bp.bn2(h)
            if q:
                h = _q_act_lsq(h, s2, torch.floor)
            else:
                h = _clip(h, 0.0, 6.0 * s2 if ef else 6.0)
            h = _pw(h, pw_p_w, dtype)
            h = bp.bn3.scale_only(h) if ef else bp.bn3(h)
            if q:
                h = _q_grid16(h)
            elif ef:
                h = _clip(h, -_GRID16_LIM, _GRID16_LIM)
            elif stride == 1 and in_c == out:
                h = h + identity
                if dense:
                    cat = torch.cat([identity, h], dim=-1)
                    h = bp.dense_bn(_pw(cat, bp.dense_proj_w, dtype))
            x = h

        final_w, cls_w = self.final_w, self.cls_w
        if ef:
            # |64·s3| must fit int8 in the serializer's amplifier diagonal
            s3f = _clip(torch.exp(self.final_qlog), 1.0 / 64.0, 127.0 / 64.0)
            s3 = s3f.to(dtype)
        if q:
            final_w = _wq_folded(final_w, self.final_bn, 64.0, out_mul=1.0 / s3f)
            cls_w = _wq_plain(cls_w, 64.0)
        x = self.final_bn(_pw(x, final_w, dtype))
        if q:
            x = _q_act_lsq(x, s3, torch.round, restore=s3_deploy(s3))
        else:
            x = _clip(x, 0.0, 6.0 * s3 if ef else 6.0)
        x = x.mean(dim=(1, 2))
        logits = x @ cls_w.T.to(dtype) + self.cls_b.to(dtype)
        return logits.to(torch.float32)


def etinynet_init(cfg: EtinyNetConfig, generator: torch.Generator,
                  device="cuda") -> EtinyNet:
    """A new `EtinyNet` with the JAX package's init distributions
    (etinynet.py:161-237): every conv U(±1/√fan_in) with fan_in = kh·kw·in
    of its HWIO shape, norms at scale 1, bias 0, running mean 0, var 1, the
    classifier's weight and bias U(±1/√final); engine_friendly, bn1's bias
    at 1.5 and the LSQ scales' logs at 0. Drawn on the host from
    `generator`, so a seed gives the same model on every device; the stream
    differs from `jax.random`'s. Built on `device`: the card unless the
    caller names another (raises without one)."""
    model = EtinyNet(cfg, device=resolve_device(device))
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias", "qlog1", "qlog2", "final_qlog"):
                continue  # norm params and LSQ scales keep their init
            if leaf in ("cls_w", "cls_b"):
                fan_in = cfg.table["final_channels"]
            else:
                fan_in = prm.shape[0] * prm.shape[1] * prm.shape[2]
            bound = 1.0 / math.sqrt(max(1, fan_in))
            u = torch.rand(prm.shape, generator=generator, dtype=torch.float32)
            prm.copy_(u * (2 * bound) - bound)
    return model


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
    depthwise, amplifying projection diag(64·s3)).

    The LSQ scales (ones for a plain model) are folded in float64: pw-expand
    divided by s1 per output channel, dw times s1/s2, pw-project times s2
    per input column, the final conv divided by s3 = clip(exp(final_qlog),
    1/64, 127/64). An engine_friendly model trained round-to-nearest at
    pw-expand and at the final block, so +0.5 goes into those biases
    (the engine truncates)."""
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

    def lsq_s(container, key, n):
        """exp(qlog) in float64, or ones for a model without LSQ scales."""
        if key in container:
            return np.exp(np.asarray(container[key], np.float64))
        return np.ones(n, np.float64)

    blocks = []
    alpha = _GAIN
    for (_, _, mid, _, stride, dense), bp, bs in zip(
            cfg.block_specs(), p["blocks"], s["blocks"]):
        pw_e, pw_e_bias = _fold_bn(bp["pw_expand_w"], bp["bn1"], bs["bn1"])
        dw, _ = _fold_bn(bp["dw_w"], bp["bn2"], bs["bn2"])
        pw_p, _ = _fold_bn(bp["pw_project_w"], bp["bn3"], bs["bn3"])
        s1 = lsq_s(bp, "qlog1", mid)
        s2 = lsq_s(bp, "qlog2", mid)
        pw_e = pw_e / s1
        pw_e_bias = pw_e_bias / s1
        dw = dw * (s1 / s2)
        pw_p = pw_p * s2.reshape(1, 1, -1, 1)
        if cfg.engine_friendly:
            pw_e_bias = pw_e_bias + 0.5
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
    s3 = np.clip(lsq_s(p, "final_qlog", fin), 1.0 / 64.0, 127.0 / 64.0)
    final_w = final_w / s3
    final_b = final_b / s3
    if cfg.engine_friendly:
        final_b = final_b + 0.5
    dw_identity = np.zeros((fin, 3, 3), np.int8)
    dw_identity[:, 1, 1] = 64
    s_expand = 64.0 * alpha
    blocks.append(QLBBlock(
        pw_expand=quantize_weight_i8(final_w[0, 0].T),
        dw=dw_identity,
        pw_project=quantize_weight_i8(np.diag(s3)),
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
