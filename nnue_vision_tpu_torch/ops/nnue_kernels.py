"""Hopper kernels of the int8 NNUE serving path, with their plain versions.

Port of `nnue_vision_tpu/ops/pallas_kernels.py:236-599`. Two CUDA kernels
(`csrc/nnue_head.cu`) compute what the TPU's `_mega_kernel` and
`_head_kernel` compute, bit for bit:

* `nnue_engine_forward_mega`: flat HWC image → logits (+ density, count),
  the whole engine in one kernel (`nnue_mega_kernel`).
* `nnue_engine_forward_fused`: the exact conv in plain torch, then the head
  kernel (`nnue_head_kernel`) from the int32 conv accumulator. The JAX
  package likewise leaves this conv to XLA.
* `fused_nnue_head`: the head kernel from an already clipped, zero-padded
  (B, F) grid buffer.
* `nnue_mega_stage`: the mega kernel cut off after stage 0-3 (the
  profiling probe `scripts/profile_mega_bisect.py` `make_stage_call`;
  `nnue_vision_tpu_torch.profile_mega_bisect` times it). The cut kernels
  are instantiations of the serving kernel's template, so they split the
  time of the kernel that serves.

Each has a plain `*_reference` beside it, which `chip_smoke.py` and the
tests hold the kernels against. The public functions dispatch on the
device of the images: a CPU tensor goes to the plain version, a CUDA tensor
to the kernel, which either launches or raises. There is no fallback.

Unlike the TPU kernels, these compute in int32, so `conv_as_matrix`, the
bf16 exact-integer window and its f32 fallback are gone; only
`input_mode="qbf16"` still needs |trunc(x·scale)| ≤ 256, because bfloat16
itself holds no larger integers exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nnue_vision_tpu_torch.ops.engine_sim import (
    NNUESimCfg,
    _int_conv3x3,
    _quantize_input,
    conv_epilogue,
    conv_out_hw,
    density_of,
    engine_conv_stride,
    feature_transform,
    grid_buffer,
    nnue_tail,
)

# Launches of each kernel since the last reset_launch_counts(); each wrapper
# adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"nnue_mega_kernel": 0, "nnue_head_kernel": 0,
            "nnue_mega_stage_kernel": 0}

_MAX_SMEM = 48 * 1024  # static shared-memory limit of a block
STAGE_OUT = 128  # values a cut mega kernel writes per image
STAGES = ("stage", "quantize", "conv", "ft")  # levels 0-3 of nnue_mega_stage
_INPUT_MODES = ("f32", "qbf16")
_HEAD_KEYS = ("ft_w", "ft_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "out_w",
              "out_b")

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def pallas_head_params(sim_params: Dict[str, torch.Tensor]) -> Dict:
    """Head params for the kernels: the `.nnue`-layout integer weights of
    `nnue_sim_params` (int16 FT (F, L1), int8 dense (out, in), int32
    biases) and the threshold as a host float32 value. Reads the threshold
    to the host once."""
    head = {k: sim_params[k].contiguous() for k in _HEAD_KEYS}
    head["thresh"] = float(sim_params["visual_threshold"])
    return head


def _padsum(ft_w: torch.Tensor, fr: int) -> torch.Tensor:
    """FT contribution of the zero-valued padding features FR..F-1, active
    together iff the threshold is negative; int32 (low bits exact)."""
    return ft_w[fr:].sum(dim=0, dtype=torch.int64).to(torch.int32)


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _head_smem_bytes(fr: int, cfg: NNUESimCfg) -> int:
    """Shared memory of the head routine (csrc/nnue_head.cu head_smem_bytes)."""
    return (_align16(4 * (fr + cfg.l1 + 1)) + _align16(cfg.l1)
            + _align16(cfg.l2) + _align16(cfg.l3))


def _mega_smem_bytes(image_h, image_w, cfg: NNUESimCfg, fr: int) -> int:
    """Shared memory of the mega kernel: the staged image, conv weights and
    accumulators, then the head's (csrc/nnue_head.cu mega_smem_bytes)."""
    staged = image_h * image_w * 3 + cfg.channels * 27 + fr
    return _align16(4 * staged) + _head_smem_bytes(fr, cfg)


def _check_mega_smem(image_h: int, image_w: int, cfg: NNUESimCfg, fr: int):
    smem = _mega_smem_bytes(image_h, image_w, cfg, fr)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"a {image_h}x{image_w} image needs {smem} bytes of shared memory "
            f"in the mega kernel (limit {_MAX_SMEM}); use "
            "nnue_engine_forward_fused for this image size"
        )


def _geometry(cfg: NNUESimCfg, image_h: int, image_w: int):
    stride = engine_conv_stride(image_h, cfg.grid_size)
    oh, ow = conv_out_hw(image_h, image_w, stride)
    fr = oh * ow * cfg.channels
    if fr > cfg.num_features:
        raise ValueError("conv output exceeds feature grid — invalid config")
    return stride, oh, ow, fr


def mega_head_params(
    sim_params: Dict[str, torch.Tensor], cfg: NNUESimCfg, image_h: int,
    image_w: int,
) -> Dict:
    """Head params + the conv weights and padding constant of the mega
    kernel at this image size.

    Raises if the image staged in shared memory would exceed the 48 KB a
    block may use; `nnue_engine_forward_fused` serves such sizes.
    """
    _, _, _, fr = _geometry(cfg, image_h, image_w)
    _check_mega_smem(image_h, image_w, cfg, fr)
    head = pallas_head_params(sim_params)
    head["conv_w"] = sim_params["conv_w"].to(torch.int32).contiguous()
    head["conv_b"] = sim_params["conv_b"].to(torch.int32).contiguous()
    head["padsum"] = _padsum(head["ft_w"], fr)
    return head


def quantize_images_for_mega(images_flat: torch.Tensor, cfg) -> torch.Tensor:
    """Pre-quantization for `input_mode="qbf16"` serving: trunc(x·conv_scale)
    as integer-valued bfloat16 (half the bytes of f32), on the input's
    device. Raises where a value leaves bfloat16's exact-integer window."""
    q = _quantize_input(images_flat, cfg.conv_scale)
    if q.numel() and int(q.abs().max()) > 256:
        raise ValueError(
            "pre-quantized inputs exceed the bf16 exact-integer window "
            "(|qx| > 256) — use the f32 input mode"
        )
    return q.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: the kernel takes a contiguous, 16-byte aligned {dtype} "
            f"tensor of shape {shape} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous="
            f"{t.is_contiguous()}, address {t.data_ptr():#x})"
        )


def _head_args(head: Dict, padsum: torch.Tensor, cfg: NNUESimCfg, fr: int,
               n_pad: int, conv_scale: int, device) -> list:
    """The head's scalar and pointer arguments, after checking every weight."""
    l1, l2, l3, nc = cfg.l1, cfg.l2, cfg.l3, cfg.num_classes
    if fr + n_pad != cfg.num_features:
        raise ValueError(f"FR {fr} + n_pad {n_pad} != F {cfg.num_features}")
    if l1 % 4:
        raise ValueError(f"the kernels take L1 divisible by 4, not {l1}")
    smem = _head_smem_bytes(fr, cfg)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the head needs {smem} bytes of shared memory (limit {_MAX_SMEM})"
        )
    i8, i32 = torch.int8, torch.int32
    specs = (
        ("padsum", padsum, i32, (l1,)),
        ("ft_w", head["ft_w"], torch.int16, (cfg.num_features, l1)),
        ("ft_b", head["ft_b"], i32, (l1,)),
        ("fc1_w", head["fc1_w"], i8, (l2, l1)),
        ("fc1_b", head["fc1_b"], i32, (l2,)),
        ("fc2_w", head["fc2_w"], i8, (l3, l2)),
        ("fc2_b", head["fc2_b"], i32, (l3,)),
        ("out_w", head["out_w"], i8, (nc, l3)),
        ("out_b", head["out_b"], i32, (nc,)),
    )
    for name, t, dtype, shape in specs:
        _require(t, name, dtype, shape, device)
    scalars = [head["thresh"], n_pad, fr, l1, l2, l3, nc, cfg.quantized_one,
               cfg.fc1_scale, cfg.fc2_scale, conv_scale, cfg.out_scale]
    return scalars + [t.data_ptr() for _, t, _, _ in specs]


def _launch(fn_name: str, kernel: str, args: list, device) -> None:
    from nnue_vision_tpu_torch.ops._build import load_library

    lib = load_library().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {lib.nnue_error_string(err).decode()}"
        )
    LAUNCHES[kernel] += 1


def _outputs_like(x: torch.Tensor, cfg: NNUESimCfg, with_count: bool):
    b = x.shape[0]
    logits = torch.empty((b, cfg.num_classes), dtype=torch.float32,
                         device=x.device)
    count = (torch.empty((b,), dtype=torch.int32, device=x.device)
             if with_count else None)
    return logits, count


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CUDA tensors only (got {x.device}); CPU tensors "
            "take the plain version"
        )


def _mega_args(head, images_flat, *, cfg, image_h, image_w, input_mode):
    """The mega kernels' image, conv and head arguments, after checking
    them (CUDA tensors only); None for an empty batch."""
    _require_cuda(images_flat, "nnue_mega_kernel")
    dev = images_flat.device
    stride, oh, ow, fr = _geometry(cfg, image_h, image_w)
    b = images_flat.shape[0]
    dtype = torch.bfloat16 if input_mode == "qbf16" else torch.float32
    _require(images_flat, "images_flat", dtype, (b, image_h * image_w * 3), dev)
    _check_mega_smem(image_h, image_w, cfg, fr)
    _require(head["conv_w"], "conv_w", torch.int32, (cfg.channels, 3, 3, 3), dev)
    _require(head["conv_b"], "conv_b", torch.int32, (cfg.channels,), dev)
    head_args = _head_args(head, head["padsum"], cfg, fr, cfg.num_features - fr,
                           cfg.conv_scale, dev)
    if b == 0:
        return None
    return ([images_flat.data_ptr(), b, image_h, image_w, stride, oh, ow,
             cfg.channels, float(cfg.conv_scale), head["conv_w"].data_ptr(),
             head["conv_b"].data_ptr()] + head_args)


def _mega_launch(head, images_flat, *, cfg, image_h, image_w, with_count,
                 input_mode):
    """nnue_mega_kernel on CUDA tensors: (logits, count or None)."""
    args = _mega_args(head, images_flat, cfg=cfg, image_h=image_h,
                      image_w=image_w, input_mode=input_mode)
    logits, count = _outputs_like(images_flat, cfg, with_count)
    if args is None:
        return logits, count
    args.insert(1, int(input_mode == "qbf16"))
    args += [logits.data_ptr(), count.data_ptr() if with_count else None]
    _launch("nnue_mega_launch", "nnue_mega_kernel", args, images_flat.device)
    return logits, count


def _check_stage(level: int, cfg: NNUESimCfg, image_h: int, image_w: int):
    _, _, _, fr = _geometry(cfg, image_h, image_w)
    if level not in range(len(STAGES)):
        raise ValueError(f"level must be 0..{len(STAGES) - 1}, not {level}")
    sizes = {"H*W*3": image_h * image_w * 3, "FR": fr, "L1": cfg.l1}
    small = {k: v for k, v in sizes.items() if v < STAGE_OUT}
    if small:
        raise ValueError(f"a cut mega kernel writes {STAGE_OUT} values per "
                         f"image and needs each of H*W*3, FR, L1 >= "
                         f"{STAGE_OUT}; got {small}")


def _stage_launch(head, images_flat, *, cfg, image_h, image_w, level):
    """nnue_mega_kernel<level> on CUDA tensors: (B, 128) float32."""
    args = _mega_args(head, images_flat, cfg=cfg, image_h=image_h,
                      image_w=image_w, input_mode="f32")
    out = torch.empty((images_flat.shape[0], STAGE_OUT), dtype=torch.float32,
                      device=images_flat.device)
    if args is None:
        return out
    _launch("nnue_mega_stage_launch", "nnue_mega_stage_kernel",
            [level] + args + [out.data_ptr()], images_flat.device)
    return out


def _head_launch(head, acc, *, cfg, n_pad, conv_scale, with_count):
    """nnue_head_kernel on a CUDA (B, FR) int32 accumulator."""
    _require_cuda(acc, "nnue_head_kernel")
    dev = acc.device
    if acc.dim() != 2:
        raise ValueError(f"acc must be (B, FR); got {tuple(acc.shape)}")
    b, fr = acc.shape
    _require(acc, "acc", torch.int32, (b, fr), dev)
    logits, count = _outputs_like(acc, cfg, with_count)
    if b == 0:
        return logits, count
    padsum = _padsum(head["ft_w"], fr)
    args = [acc.data_ptr(), b]
    args += _head_args(head, padsum, cfg, fr, n_pad, conv_scale, dev)
    args += [logits.data_ptr(), count.data_ptr() if with_count else None]
    _launch("nnue_head_launch", "nnue_head_kernel", args, dev)
    return logits, count


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the oracle of the kernels)
# ---------------------------------------------------------------------------


def _head_plain(head, acc, *, cfg, n_pad, conv_scale, with_count):
    """What nnue_head_kernel computes, in plain torch: epilogue (skipped at
    conv_scale 1), zero-fill to F, then the engine tail."""
    vals = conv_epilogue(acc, conv_scale) if conv_scale != 1 else acc
    buf = grid_buffer(vals, acc.shape[1] + n_pad)
    thresh = torch.full((), head["thresh"], dtype=torch.float32,
                        device=acc.device)
    logits, count = nnue_tail(head, buf, thresh, cfg)
    return logits, count if with_count else None


def _mega_plain(head, images_flat, *, cfg, image_h, image_w, with_count,
                input_mode):
    """What nnue_mega_kernel computes, in plain torch."""
    stride, _, _, fr = _geometry(cfg, image_h, image_w)
    if input_mode == "qbf16":
        qin = images_flat.to(torch.int32)  # integer-valued already
    else:
        qin = _quantize_input(images_flat, cfg.conv_scale)
    b = images_flat.shape[0]
    qin = qin.reshape(b, image_h, image_w, 3)
    acc = _int_conv3x3(qin, head["conv_w"], head["conv_b"], stride)
    return _head_plain(head, acc.reshape(b, fr), cfg=cfg,
                       n_pad=cfg.num_features - fr,
                       conv_scale=cfg.conv_scale, with_count=with_count)


def _stage_plain(head, images_flat, *, cfg, image_h, image_w, level):
    """What nnue_mega_kernel<level> computes, in plain torch: the first 128
    values of the quantized image (1), the conv accumulator (2) or the
    clipped FT (3), or of the raw image (0), as float32."""
    stride, _, _, fr = _geometry(cfg, image_h, image_w)
    b = images_flat.shape[0]
    if level == 0:
        return images_flat[:, :STAGE_OUT].clone()
    qin = _quantize_input(images_flat, cfg.conv_scale)
    if level == 1:
        return qin[:, :STAGE_OUT].to(torch.float32)
    acc = _int_conv3x3(qin.reshape(b, image_h, image_w, 3), head["conv_w"],
                       head["conv_b"], stride).reshape(b, fr)
    if level == 2:
        return acc[:, :STAGE_OUT].to(torch.float32)
    buf = grid_buffer(conv_epilogue(acc, cfg.conv_scale), cfg.num_features)
    thresh = torch.full((), head["thresh"], dtype=torch.float32,
                        device=acc.device)
    ft, _ = feature_transform(head, buf, thresh, cfg)
    return ft[:, :STAGE_OUT].to(torch.float32)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _with_density(logits, count, cfg: NNUESimCfg) -> Outputs:
    if count is None:
        return logits, None, None
    return logits, density_of(count, cfg.num_features), count


def _check_mode(input_mode: str) -> None:
    if input_mode not in _INPUT_MODES:
        raise ValueError(f"unknown input_mode {input_mode!r}")


def nnue_engine_forward_mega(
    head_params: Dict, images_flat: torch.Tensor, *, cfg: NNUESimCfg,
    image_h: int, image_w: int, with_count: bool = True,
    input_mode: str = "f32",
) -> Outputs:
    """Single-kernel bit-exact NNUE int8 inference: image in, logits out.

    `images_flat` is (B, H·W·3) in the flat HWC order the engine CLI reads
    from its `.bin` files (nnue_inference.cpp:23-30): float32, or with
    `input_mode="qbf16"` the bfloat16 of `quantize_images_for_mega`.
    Returns (logits (B, C) f32, density (B,) f32, count (B,) i32), or
    (logits, None, None) with `with_count=False`.
    """
    _check_mode(input_mode)
    core = _mega_plain if images_flat.device.type == "cpu" else _mega_launch
    return _with_density(*core(
        head_params, images_flat, cfg=cfg, image_h=image_h, image_w=image_w,
        with_count=with_count, input_mode=input_mode,
    ), cfg)


def nnue_engine_forward_mega_reference(
    head_params: Dict, images_flat: torch.Tensor, *, cfg: NNUESimCfg,
    image_h: int, image_w: int, with_count: bool = True,
    input_mode: str = "f32",
) -> Outputs:
    """`nnue_engine_forward_mega` in plain torch, on any device."""
    _check_mode(input_mode)
    return _with_density(*_mega_plain(
        head_params, images_flat, cfg=cfg, image_h=image_h, image_w=image_w,
        with_count=with_count, input_mode=input_mode,
    ), cfg)


def _fused_acc(sim_params, images, cfg: NNUESimCfg, image_h: int,
               image_w: int):
    """The exact int conv outside the kernel: (B, FR) int32 accumulator."""
    stride, _, _, _ = _geometry(cfg, image_h, image_w)
    qin = _quantize_input(images, cfg.conv_scale)
    acc = _int_conv3x3(qin, sim_params["conv_w"], sim_params["conv_b"], stride)
    return acc.reshape(acc.shape[0], -1).to(torch.int32)


def _fused(core, sim_params, head_params, images, cfg, image_h, image_w,
           with_count):
    acc = _fused_acc(sim_params, images, cfg, image_h, image_w)
    return _with_density(*core(
        head_params, acc, cfg=cfg, n_pad=cfg.num_features - acc.shape[1],
        conv_scale=cfg.conv_scale, with_count=with_count,
    ), cfg)


def nnue_engine_forward_fused(
    sim_params: Dict[str, torch.Tensor], head_params: Dict,
    images: torch.Tensor, *, cfg: NNUESimCfg, image_h: int, image_w: int,
    with_count: bool = True,
) -> Outputs:
    """Full bit-exact NNUE int8 inference: plain exact conv, then the head
    kernel from the raw conv accumulator. Same contract as
    `engine_sim.nnue_engine_forward`; images are (B, H, W, 3) float32 and
    need no input-range precondition."""
    core = _head_plain if images.device.type == "cpu" else _head_launch
    return _fused(core, sim_params, head_params, images, cfg, image_h,
                  image_w, with_count)


def nnue_engine_forward_fused_reference(
    sim_params: Dict[str, torch.Tensor], head_params: Dict,
    images: torch.Tensor, *, cfg: NNUESimCfg, image_h: int, image_w: int,
    with_count: bool = True,
) -> Outputs:
    """`nnue_engine_forward_fused` in plain torch, on any device."""
    return _fused(_head_plain, sim_params, head_params, images, cfg, image_h,
                  image_w, with_count)


def fused_nnue_head(
    head_params: Dict, conv_buf: torch.Tensor, *, cfg: NNUESimCfg,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, C) f32, active_count (B,) i32) from the clipped,
    zero-padded (B, F) grid buffer (int-valued; converted to int32).
    Prefer `nnue_engine_forward_fused`, which trims the padding."""
    core = _head_plain if conv_buf.device.type == "cpu" else _head_launch
    return core(head_params, conv_buf.to(torch.int32).contiguous(), cfg=cfg,
                n_pad=0, conv_scale=1, with_count=True)


def fused_nnue_head_reference(
    head_params: Dict, conv_buf: torch.Tensor, *, cfg: NNUESimCfg,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fused_nnue_head` in plain torch, on any device."""
    return _head_plain(head_params, conv_buf.to(torch.int32), cfg=cfg,
                       n_pad=0, conv_scale=1, with_count=True)


def nnue_mega_stage(
    head_params: Dict, images_flat: torch.Tensor, *, cfg: NNUESimCfg,
    image_h: int, image_w: int, level: int,
) -> torch.Tensor:
    """The mega kernel cut off after stage `level` (see `STAGES`): (B, 128)
    float32, the first 128 values that stage leaves (level 0 the raw image,
    1 the quantized image, 2 the conv accumulator with bias, 3 the clipped
    FT). `images_flat` is (B, H·W·3) float32; H·W·3, FR and L1 must each be
    at least 128, as the JAX probe's slices need. Level 4 is
    `nnue_engine_forward_mega` itself."""
    _check_stage(level, cfg, image_h, image_w)
    core = _stage_plain if images_flat.device.type == "cpu" else _stage_launch
    return core(head_params, images_flat, cfg=cfg, image_h=image_h,
                image_w=image_w, level=level)


def nnue_mega_stage_reference(
    head_params: Dict, images_flat: torch.Tensor, *, cfg: NNUESimCfg,
    image_h: int, image_w: int, level: int,
) -> torch.Tensor:
    """`nnue_mega_stage` in plain torch, on any device."""
    _check_stage(level, cfg, image_h, image_w)
    return _stage_plain(head_params, images_flat, cfg=cfg, image_h=image_h,
                        image_w=image_w, level=level)
