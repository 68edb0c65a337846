"""Bit-exact torch simulation of the int8 C++ inference engine.

Port of `nnue_vision_tpu/ops/engine_sim.py`. Given the arrays a `.nnue` or
`.etiny` file carries and a float image batch, `nnue_engine_forward` gives
the logits and active-feature counts of the C++ `nnue_inference` binary,
and `etiny_engine_forward` the logits of `etinynet_inference`, bit for bit.
They are the plain oracles the Hopper kernels of `nnue_kernels.py` and
`etiny_kernels.py` are held against, and the paths a CPU tensor takes.

The integer contract is the JAX module's (see its docstring for the engine
citations): `int32(x * 64.0f)` input quantization, int32 conv accumulation
with truncating `/scale` and a ±127 clamp, the engine's runtime stride rule
`ceil((H-1)/(grid-1))`, flat placement of the conv output into a zero-filled
grid²·C buffer, float threshold compare, int16 wraparound feature
transformer, truncating pairwise and dense requantization, float logits.

How exactness is kept here, on the CPU and on the card alike:

* every integer stage runs in int64, and truncating division is
  `torch.div(..., rounding_mode="trunc")` (torch's `//` floors);
* the conv, the FT and the dense products are float64 matmuls of
  integer-valued operands: every product and partial sum is an integer
  below 2^53, so any summation order gives the exact sum. (The JAX sim
  sums in float32 and is exact only below 2^24.) The conv is a GEMM over
  unfolded patches, never `F.conv2d`: cuDNN may run float32 in TF32 or
  pick Winograd/FFT.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from nnue_vision_tpu_torch.formats import QuantizedEtinyNet, QuantizedNNUE


@dataclasses.dataclass(frozen=True)
class NNUESimCfg:
    """Static NNUE architecture facts (the JAX package's jit statics)."""

    grid_size: int
    channels: int
    l1: int
    l2: int
    l3: int
    num_classes: int
    conv_scale: int
    fc1_scale: int
    fc2_scale: int
    out_scale: float
    quantized_one: int

    @property
    def num_features(self) -> int:
        return self.grid_size * self.grid_size * self.channels


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" means the current card and raises
    where there is none (entry points default to the card: a caller who
    wants the CPU says so)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                               "available on this host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    """C-style truncating integer division (toward zero), b > 0."""
    return torch.div(a, b, rounding_mode="trunc")


def _wrap_i16(a: torch.Tensor) -> torch.Tensor:
    """Reduce integers mod 2^16 into [-32768, 32767] (int16 wraparound)."""
    return ((a & 0xFFFF) ^ 0x8000) - 0x8000


def engine_conv_stride(image_h: int, grid_size: int) -> int:
    """The engine's runtime stride rule: ceil((H-1)/(grid-1))
    (nnue_engine.cpp:667-675)."""
    if grid_size <= 0:
        raise ValueError("grid_size must be positive")
    if grid_size == 1:
        return max(1, image_h)
    return max(1, -(-(image_h - 1) // (grid_size - 1)))


def conv_out_hw(image_h: int, image_w: int, stride: int) -> Tuple[int, int]:
    """Output height and width of the 3×3 pad-1 conv at `stride`."""
    return (image_h - 1) // stride + 1, (image_w - 1) // stride + 1


def _quantize_input(img: torch.Tensor, scale: float) -> torch.Tensor:
    """`static_cast<int32_t>(x * scale)`: f32 multiply, truncate toward zero."""
    s = torch.full((), scale, dtype=torch.float32, device=img.device)
    return torch.trunc(img.to(torch.float32) * s).to(torch.int32)


def _int_conv3x3(
    qin: torch.Tensor, weight_oihw: torch.Tensor, bias: torch.Tensor,
    stride: int,
) -> torch.Tensor:
    """Exact integer 3×3 conv, padding 1: (B, H, W, 3) → (B, oh, ow, C) int64.

    One float64 GEMM of the (B·oh·ow, 27) input patches with the (27, C)
    weights: every product and partial sum is an integer below 2^53, so the
    sum is exact in any order, and no library convolution (TF32, Winograd
    or FFT) is involved.
    """
    b, h, w, cin = qin.shape
    oh, ow = conv_out_hw(h, w, stride)
    c = weight_oihw.shape[0]
    qpad = torch.zeros((b, h + 2, w + 2, cin), dtype=torch.float64,
                       device=qin.device)
    qpad[:, 1:h + 1, 1:w + 1] = qin
    # (B, oh, ow, cin, kh, kw): the same (cin, kh, kw) order as OIHW rows
    patches = qpad.unfold(1, 3, stride).unfold(2, 3, stride)
    acc = patches.reshape(b * oh * ow, cin * 9) @ \
        weight_oihw.reshape(c, cin * 9).to(torch.float64).T
    return acc.to(torch.int64).reshape(b, oh, ow, c) + bias.to(torch.int64)


def conv_inputs_bf16_safe(images, scale) -> bool:
    """Is every |trunc(x·scale)| ≤ 256, the window where integers cast to
    bfloat16 exactly? Only `input_mode="qbf16"` needs it: the port's conv
    is exact in int32 for any input."""
    x = torch.as_tensor(images, dtype=torch.float32)
    m = float(x.abs().max()) if x.numel() else 0.0
    return m * float(scale) <= 256


# ---------------------------------------------------------------------------
# NNUE
# ---------------------------------------------------------------------------


def nnue_sim_params(
    q: QuantizedNNUE, device="cuda"
) -> Tuple[Dict[str, torch.Tensor], NNUESimCfg]:
    """Tensors on `device` (the card unless the caller names another; raises
    without one) + static config for `nnue_engine_forward`.

    Weights keep the `.nnue` integer types (int16 FT, int8 dense, int32
    biases); `visual_threshold` is the float32 the engine compares against.
    """
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device).contiguous()

    params = {
        "conv_w": t(q.conv.weight, torch.int32),
        "conv_b": t(q.conv.bias, torch.int32),
        "ft_w": t(q.ft.weight, torch.int16),
        "ft_b": t(q.ft.bias, torch.int32),
        "fc1_w": t(q.fc1.weight, torch.int8),
        "fc1_b": t(q.fc1.bias, torch.int32),
        "fc2_w": t(q.fc2.weight, torch.int8),
        "fc2_b": t(q.fc2.bias, torch.int32),
        "out_w": t(q.out.weight, torch.int8),
        "out_b": t(q.out.bias, torch.int32),
        "visual_threshold": t(q.visual_threshold, torch.float32),
    }
    cfg = NNUESimCfg(
        grid_size=q.grid_size,
        channels=q.num_features_per_square,
        l1=q.l1,
        l2=q.l2,
        l3=q.l3,
        num_classes=q.num_classes,
        conv_scale=int(q.conv.scale),
        fc1_scale=int(q.fc1.scale),
        fc2_scale=int(q.fc2.scale),
        out_scale=float(q.out.scale),
        quantized_one=int(q.quantized_one),
    )
    return params, cfg


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product x @ w in float64 (operands integer-valued,
    every partial sum below 2^53), returned as int64."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)


def conv_epilogue(acc: torch.Tensor, conv_scale: int) -> torch.Tensor:
    """`clamp(acc / scale, ±127)` with C truncating division
    (nnue_engine.cpp:92)."""
    return torch.clamp(_tdiv(acc.to(torch.int64), conv_scale), -127, 127)


def grid_buffer(conv_out_flat: torch.Tensor, num_features: int) -> torch.Tensor:
    """Flat conv output placed into the zero-filled grid²·C buffer
    (nnue_engine.cpp:679-683)."""
    pad = num_features - conv_out_flat.shape[1]
    if pad < 0:
        raise ValueError("conv output exceeds feature grid — invalid config")
    return torch.nn.functional.pad(conv_out_flat.to(torch.int64), (0, pad))


def feature_transform(
    params: Dict[str, torch.Tensor], buf: torch.Tensor,
    thresh: torch.Tensor, cfg: NNUESimCfg,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold → FT → int16 wrap → clipped ReLU from the (B, F) grid
    buffer: (ft (B, L1) int64 in [0, quantized_one], active mask (B, F)).
    `thresh` is a float32 scalar tensor (nnue_engine.h:246 compares floats).
    """
    mask = buf.to(torch.float32) > thresh
    # Feature transformer: int16 accumulator with wraparound
    # (simd_scalar.cpp:78-95) == exact sum reduced mod 2^16.
    ft = _dot(mask, params["ft_w"]) + params["ft_b"].to(torch.int64)
    return torch.clamp(_wrap_i16(ft), 0, cfg.quantized_one), mask


def nnue_tail(
    params: Dict[str, torch.Tensor], buf: torch.Tensor,
    thresh: torch.Tensor, cfg: NNUESimCfg,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Engine from the (B, F) grid buffer to (logits, active_count):
    `feature_transform`, then pairwise and the dense stack, with the
    weights in `.nnue` layout: `ft_w` (F, L1), `fc*_w` (out, in)."""
    ft, mask = feature_transform(params, buf, thresh, cfg)
    active_count = mask.sum(dim=1, dtype=torch.int32)

    # Pairwise interaction (nnue_engine.cpp:491-500).
    half = cfg.l1 // 2
    a, b = ft[:, :half], ft[:, half:]
    pairwise = torch.cat(
        [torch.clamp(_tdiv(a * b, 128), 0, 127), torch.clamp(a, 0, 127)],
        dim=1,
    )

    # Dense 1 (nnue_engine.cpp:503-509): /fc1_scale truncating, clamp [0,127].
    h1 = _dot(pairwise, params["fc1_w"].T) + params["fc1_b"].to(torch.int64)
    h1 = torch.clamp(_tdiv(h1, cfg.fc1_scale), 0, 127)
    # Dense 2 (nnue_engine.cpp:512-523): clamp ±127 then ReLU.
    h2 = _dot(h1, params["fc2_w"].T) + params["fc2_b"].to(torch.int64)
    h2 = torch.clamp(_tdiv(h2, cfg.fc2_scale), 0, 127)
    # Output (nnue_engine.cpp:526-533): float logits acc / output_scale.
    out = _dot(h2, params["out_w"].T) + params["out_b"].to(torch.int64)
    scale = torch.full((), cfg.out_scale, dtype=torch.float32,
                       device=out.device)
    return out.to(torch.float32) / scale, active_count


def density_of(count: torch.Tensor, num_features: int) -> torch.Tensor:
    """The engine's density: one f32 division (nnue_inference.cpp:54).

    The divisor is a device tensor, not a Python number: CUDA torch divides
    by a host scalar as a multiply by its reciprocal, 1 ulp off for F = 800.
    (Scalars here are made with `torch.full`, a device fill, rather than
    `torch.tensor`, whose host-to-device copy can stall the stream.)"""
    f = torch.full((), float(num_features), dtype=torch.float32,
                   device=count.device)
    return count.to(torch.float32) / f


def nnue_conv_buffer(
    params: Dict[str, torch.Tensor], images: torch.Tensor, *,
    cfg: NNUESimCfg, image_h: int,
) -> torch.Tensor:
    """(B, H, W, 3) float32 images → the engine's (B, F) int64 grid buffer:
    quantized input, int conv, epilogue, flat NHWC placement
    (f = (i·ow + j)·C + c) into the zero-filled grid²·C buffer."""
    stride = engine_conv_stride(image_h, cfg.grid_size)
    qin = _quantize_input(images, cfg.conv_scale)
    acc = _int_conv3x3(qin, params["conv_w"], params["conv_b"], stride)
    conv_out = conv_epilogue(acc, cfg.conv_scale)  # (B, oh, ow, C)
    return grid_buffer(conv_out.reshape(conv_out.shape[0], -1),
                       cfg.num_features)


def nnue_engine_forward(
    params: Dict[str, torch.Tensor], images: torch.Tensor, *,
    cfg: NNUESimCfg, image_h: int, image_w: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bit-exact NNUE int8 inference for a batch.

    Args:
      params, cfg: from `nnue_sim_params`.
      images: (B, H, W, 3) float32 NHWC, the engine's `.bin` order
        (nnue_inference.cpp:23-30 indexes `(h*W + w)*3 + c`).

    Returns:
      (logits (B, num_classes) float32, density (B,) float32,
      active_count (B,) int32), identical to the `nnue_inference` CLI.
    """
    buf = nnue_conv_buffer(params, images, cfg=cfg, image_h=image_h)
    logits, count = nnue_tail(params, buf, params["visual_threshold"], cfg)
    return logits, density_of(count, cfg.num_features), count


# ---------------------------------------------------------------------------
# EtinyNet
# ---------------------------------------------------------------------------
#
# The engine's EtinyNetEvaluator (nnue_engine.cpp:1318-1419, the JAX sim's
# `etiny_engine_forward`): stem conv on the raw float image at stride 2,
# the LB chain with truncating requantization and ReLU6 as clamp[0, 6], an
# integer global mean, a float classifier output. Every stage here is int64
# (convs and matmuls as float64 products of integer-valued operands, exact
# below 2^53), so the sim is exact for any model the format admits; the JAX
# sim computes in integer-valued float32 and is exact within the engine's
# value bounds.


@dataclasses.dataclass(frozen=True)
class EtinyBlockCfg:
    stride: int
    s_expand: int
    s_dw: int
    s_project: int
    is_dense: bool


@dataclasses.dataclass(frozen=True)
class EtinySimCfg:
    stem_scale: int
    cls_scale: float
    num_classes: int
    blocks: Tuple[EtinyBlockCfg, ...]


def _check_pow2(scale: float, what: str) -> int:
    """The JAX package's precondition: every requantization scale is a
    power of two (both serializers emit only 64 and 4)."""
    s = int(scale)
    if s <= 0 or (s & (s - 1)) != 0:
        raise ValueError(f"{what} scale {scale} is not a power of two; "
                         "the bit-exact TPU fast path requires pow2 scales")
    return s


def etiny_sim_params(
    q: QuantizedEtinyNet, device="cuda"
) -> Tuple[Dict, EtinySimCfg]:
    """Tensors on `device` (the card unless the caller names another; raises
    without one) + static config for `etiny_engine_forward`.

    Weights keep the `.etiny` integer layouts: stem (C, 3, 3, 3) OIHW,
    per block `pw_expand_w` (mid, in), `pw_expand_b` (mid,), `dw_w`
    (mid, 3, 3), `pw_project_w` (out, mid), the classifier (classes, C)."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device).contiguous()

    blocks, block_cfgs = [], []
    for blk in q.blocks:
        blocks.append({
            "pw_expand_w": t(blk.pw_expand, torch.int8),
            "pw_expand_b": t(blk.pw_expand_bias, torch.int32),
            "dw_w": t(blk.dw, torch.int8),
            "pw_project_w": t(blk.pw_project, torch.int8),
        })
        block_cfgs.append(EtinyBlockCfg(
            stride=int(blk.stride),
            s_expand=_check_pow2(blk.pw_expand_scale, "pw_expand"),
            s_dw=_check_pow2(blk.dw_scale, "dw"),
            s_project=_check_pow2(blk.pw_project_scale, "pw_project"),
            is_dense=bool(blk.is_dense),
        ))
    params = {
        "stem_w": t(q.stem.weight, torch.int32),
        "stem_b": t(q.stem.bias, torch.int32),
        "blocks": blocks,
        "cls_w": t(q.classifier.weight, torch.int8),
        "cls_b": t(q.classifier.bias, torch.int32),
    }
    cfg = EtinySimCfg(
        stem_scale=_check_pow2(q.stem.scale, "stem"),
        cls_scale=float(q.classifier.scale),
        num_classes=q.num_classes,
        blocks=tuple(block_cfgs),
    )
    return params, cfg


def etiny_stem(params: Dict, images: torch.Tensor, cfg: EtinySimCfg
               ) -> torch.Tensor:
    """Stem conv (cpp:1341-1351): `int32(x·scale)`, 3×3 pad-1 stride 2,
    + bias, truncating /scale, clamp ±127. (B, H, W, 3) float32 →
    (B, oh, ow, C) int64."""
    qin = _quantize_input(images, cfg.stem_scale)
    acc = _int_conv3x3(qin, params["stem_w"], params["stem_b"], 2)
    return torch.clamp(_tdiv(acc, cfg.stem_scale), -127, 127)


def lb_block_plain(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg
                   ) -> torch.Tensor:
    """One LB block (cpp:906-973) at its stride: pw-expand + bias,
    truncating /s_expand, clamp [0, 6] → depthwise 3×3 pad 1, /s_dw, clamp
    [0, 6] → pw-project, /s_project, clamp ±127. (B, H, W, Cin) integers →
    (B, oh, ow, Cout) int64."""
    b, h, w, _ = x.shape
    s = bs.stride
    acc = _dot(x, blk["pw_expand_w"].T) + blk["pw_expand_b"].to(torch.int64)
    hid = torch.clamp(_tdiv(acc, bs.s_expand), 0, 6)
    oh, ow = conv_out_hw(h, w, s)
    pad = torch.nn.functional.pad(hid, (0, 0, 1, 1, 1, 1))
    dw = blk["dw_w"].to(torch.int64)
    acc = torch.zeros((b, oh, ow, hid.shape[3]), dtype=torch.int64,
                      device=x.device)
    for kh in range(3):
        for kw in range(3):
            acc += pad[:, kh:kh + (oh - 1) * s + 1:s,
                       kw:kw + (ow - 1) * s + 1:s] * dw[:, kh, kw]
    hid = torch.clamp(_tdiv(acc, bs.s_dw), 0, 6)
    acc = _dot(hid, blk["pw_project_w"].T)
    return torch.clamp(_tdiv(acc, bs.s_project), -127, 127)


def etiny_tail(params: Dict, x: torch.Tensor, cfg: EtinySimCfg
               ) -> torch.Tensor:
    """Global average pool (int sum, truncating /(H·W), clamp ±127;
    cpp:1452-1463) and the classifier's float output acc / scale
    (cpp:1028-1040). (B, H, W, C) integers → logits (B, classes) float32."""
    hw = x.shape[1] * x.shape[2]
    pooled = torch.clamp(_tdiv(x.to(torch.int64).sum(dim=(1, 2)), hw),
                         -127, 127)
    out = _dot(pooled, params["cls_w"].T) + params["cls_b"].to(torch.int64)
    scale = torch.full((), cfg.cls_scale, dtype=torch.float32,
                       device=out.device)
    return out.to(torch.float32) / scale


def etiny_engine_forward(
    params: Dict, images: torch.Tensor, *, cfg: EtinySimCfg, image_h: int,
    image_w: int,
) -> torch.Tensor:
    """Bit-exact EtinyNet int8 inference for a batch.

    images: (B, H, W, 3) float32 NHWC, normalized. Returns logits
    (B, num_classes) float32, identical to the `etinynet_inference` CLI's
    RESULT lines. Dense blocks reproduce the engine's dim-preservation
    quirk (cpp:1381-1397): the evaluator assumes a dense block keeps its
    input's spatial dims, so a stride-2 dense block's real output lands
    flat at the front of a zero-filled (in_h, in_w) buffer; the identity
    at stride 1."""
    del image_h, image_w  # read from the images, as in the JAX sim
    x = etiny_stem(params, images, cfg)
    for blk, bs in zip(params["blocks"], cfg.blocks):
        b, in_h, in_w, _ = x.shape
        x = lb_block_plain(x, blk, bs)
        if bs.is_dense:
            out_c = x.shape[3]
            flat = x.reshape(b, -1)
            x = torch.nn.functional.pad(
                flat, (0, in_h * in_w * out_c - flat.shape[1])
            ).reshape(b, in_h, in_w, out_c)
    return etiny_tail(params, x, cfg)
