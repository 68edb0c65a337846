"""Hopper kernels of the int8 NNUE serving path, with their plain versions.

Port of `nnue_vision_tpu/ops/pallas_kernels.py:236-599`. Two CUDA kernels
(`csrc/nnue_head.cu`; a tile of images per block of threads, the FT and fc1
as int8 tensor-core products through `csrc/int8_mma.cuh`) compute what the
TPU's `_mega_kernel` and `_head_kernel` compute, bit for bit:

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

import functools
from typing import Dict, Optional, Tuple

import torch

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.ops import _build
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
from nnue_vision_tpu_torch.tracing import span

# Launches of each kernel since the last reset_launch_counts(), counted by
# `_build.launch`.
LAUNCHES = tracing.counters("nnue_kernels", "nnue_mega_kernel",
                            "nnue_head_kernel", "nnue_mega_stage_kernel")

_MAX_SMEM = 232448  # the shared memory a block may use on sm_90
_SLOT_BYTES = 128 * 144  # csrc/int8_mma.cuh kSlotBytes
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


def mma_tiles(w: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 or uint8 weights → the tensor-core kernels' layout
    (csrc/int8_mma.cuh): zero padded to N and K multiples of 128, as
    (N/128, K/128, 128, 128) bytes, so that the 128 K-bytes of 128 columns
    (one 16 KB stage) lie together. Built once per model."""
    n, k = w.shape
    w = torch.nn.functional.pad(w, (0, -k % 128, 0, -n % 128))
    nc, ks = w.shape[0] // 128, w.shape[1] // 128
    return w.reshape(nc, 128, ks, 128).permute(0, 2, 1, 3).contiguous()


def ft_byte_planes(ft_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int16 FT table as two byte planes, `lo = w & 0xFF` (uint8) and
    `hi = w >> 8` (int8): w = 256·hi + lo exactly for every int16."""
    w = ft_w.to(torch.int32)
    return (w & 0xFF).to(torch.uint8), (w >> 8).to(torch.int8)


def ft_tiles(ft_w: torch.Tensor) -> torch.Tensor:
    """The FT planes in the order the kernels' product reads them: chunk c
    holds the lo plane of L1 columns 32c..32c+31 and half+32c..half+32c+31
    (half = L1/2; zero past half), then the hi plane of the same columns,
    each the (F, 128) K × N block of a chunk; as `mma_tiles`."""
    f, l1 = ft_w.shape
    half = l1 // 2
    lo, hi = ft_byte_planes(ft_w)
    cols = torch.arange(-(-half // 32) * 32, device=ft_w.device)
    valid = cols < half
    first = cols.clamp(max=half - 1)

    def pick(plane, base):
        out = plane.view(torch.uint8)[:, base + first] * valid
        return out.reshape(f, -1, 32)

    chunks = torch.cat([pick(lo, 0), pick(lo, half), pick(hi, 0),
                        pick(hi, half)], dim=2)  # (F, chunks, 128)
    return mma_tiles(chunks.reshape(f, -1).T)


def pallas_head_params(sim_params: Dict[str, torch.Tensor]) -> Dict:
    """Head params for the kernels: the `.nnue`-layout integer weights of
    `nnue_sim_params` (int16 FT (F, L1), int8 dense (out, in), int32
    biases), the threshold as a host float32 value, and the tensor-core
    layouts of the FT planes (`ft_tiles`) and of fc1 (`fc1_tiles`).
    Reads the threshold to the host once. `padsums` holds the FT sum of
    the padding rows per FR, each made at the first call with that FR."""
    head = {k: sim_params[k].contiguous() for k in _HEAD_KEYS}
    head["thresh"] = float(sim_params["visual_threshold"])
    head["ft_tiles"] = ft_tiles(head["ft_w"])
    head["fc1_tiles"] = mma_tiles(head["fc1_w"])
    head["padsums"] = {}
    return head


def _padsum(head: Dict, fr: int) -> torch.Tensor:
    """FT contribution of the zero-valued padding features FR..F-1, active
    together iff the threshold is negative; int32 (low bits exact). Made
    once per model and FR, and kept in the params."""
    if fr not in head["padsums"]:
        head["padsums"][fr] = head["ft_w"][fr:].sum(
            dim=0, dtype=torch.int64).to(torch.int32)
    return head["padsums"][fr]


def _align(nbytes: int, to: int) -> int:
    return -(-nbytes // to) * to


def _smem_bytes(fr: int, cfg: NNUESimCfg, channels: int = 0,
                hw3: int = 0) -> int:
    """Shared memory of the kernels' smallest tile (csrc/nnue_head.cu
    HeadSmem at 16 product rows, 2 ring slots and, in the mega kernel, one
    staged pair of f32 images of `hw3` values): conv weights, biases and
    feature geometry, the FT and fc1 biases, the mask (rows of FR padded to
    128, + 16 bytes), the pairwise activations (rows of L1 padded to 32,
    + 16, + 128 bytes of slack), and an area for the staged and quantized
    pair or the FT sums, the dense outputs and the weight ring. The
    launcher takes a larger tile where one fits."""
    a128 = functools.partial(_align, to=128)
    rows, l1, l2, l3 = 16, cfg.l1, cfg.l2, cfg.l3
    sums = max(a128(4 * rows * 136), a128(rows * (_align(l2, 16) + 4))
               + a128(rows * (_align(l3, 16) + 4)))
    ft_stages = -(-l1 // 64) * -(-fr // 128)
    fc1_stages = -(-l2 // 128) * -(-l1 // 128)
    ring = min(max(ft_stages, fc1_stages), 2) * _SLOT_BYTES
    area = max(sums + ring, 4 * a128(4 * hw3))
    return (a128(4 * channels * 28) + (a128(4 * fr) if channels else 0)
            + a128(4 * (l1 + l2)) + a128(rows * (_align(fr, 128) + 16))
            + a128(rows * (_align(l1, 32) + 16) + 128) + area)


def _check_mega_smem(image_h: int, image_w: int, cfg: NNUESimCfg, fr: int):
    smem = _smem_bytes(fr, cfg, cfg.channels, image_h * image_w * 3)
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

    Raises if two staged images, their quantized copies and a tile of 16
    rows would not fit in the shared memory a block may use;
    `nnue_engine_forward_fused` serves such sizes.
    """
    _, _, _, fr = _geometry(cfg, image_h, image_w)
    _check_mega_smem(image_h, image_w, cfg, fr)
    head = pallas_head_params(sim_params)
    head["conv_w"] = sim_params["conv_w"].to(torch.int32).contiguous()
    head["conv_b"] = sim_params["conv_b"].to(torch.int32).contiguous()
    head["padsum"] = _padsum(head, fr)
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
    """The head's 22 words (csrc/nnue_head.cu read_head), after checking
    every weight."""
    l1, l2, l3, nc = cfg.l1, cfg.l2, cfg.l3, cfg.num_classes
    f = cfg.num_features
    if fr + n_pad != f:
        raise ValueError(f"FR {fr} + n_pad {n_pad} != F {f}")
    if l1 % 4:
        raise ValueError(f"the kernels take L1 divisible by 4, not {l1}")
    smem = _smem_bytes(fr, cfg)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the head needs {smem} bytes of shared memory (limit {_MAX_SMEM})"
        )
    i8, i32, u8 = torch.int8, torch.int32, torch.uint8
    ft_steps = -(-f // 128)
    specs = (
        ("padsum", padsum, i32, (l1,)),
        ("ft_tiles", head["ft_tiles"], u8, (-(-l1 // 64), ft_steps, 128, 128)),
        ("ft_b", head["ft_b"], i32, (l1,)),
        ("fc1_tiles", head["fc1_tiles"], i8,
         (-(-l2 // 128), -(-l1 // 128), 128, 128)),
        ("fc1_b", head["fc1_b"], i32, (l2,)),
        ("fc2_w", head["fc2_w"], i8, (l3, l2)),
        ("fc2_b", head["fc2_b"], i32, (l3,)),
        ("out_w", head["out_w"], i8, (nc, l3)),
        ("out_b", head["out_b"], i32, (nc,)),
    )
    for name, t, dtype, shape in specs:
        _require(t, name, dtype, shape, device)
    scalars = [_build.f32(head["thresh"]), n_pad, fr, l1, l2, l3, nc,
               cfg.quantized_one, cfg.fc1_scale, cfg.fc2_scale, conv_scale,
               _build.f32(cfg.out_scale), ft_steps]
    return scalars + [t.data_ptr() for _, t, _, _ in specs]


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
             cfg.channels, _build.f32(cfg.conv_scale),
             head["conv_w"].data_ptr(), head["conv_b"].data_ptr()] + head_args)


def _mega_launch(head, images_flat, *, cfg, image_h, image_w, with_count,
                 input_mode):
    """nnue_mega_kernel on CUDA tensors: (logits, count or None)."""
    args = _mega_args(head, images_flat, cfg=cfg, image_h=image_h,
                      image_w=image_w, input_mode=input_mode)
    logits, count = _outputs_like(images_flat, cfg, with_count)
    if args is None:
        return logits, count
    args.insert(1, int(input_mode == "qbf16"))
    args += [logits.data_ptr(), count.data_ptr() if with_count else 0]
    _build.launch(images_flat.device, LAUNCHES, "nnue_mega_kernel",
                  "nnue_mega_launch", args)
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
    _build.launch(images_flat.device, LAUNCHES, "nnue_mega_stage_kernel",
                  "nnue_mega_stage_launch", [level] + args + [out.data_ptr()])
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
    args = [acc.data_ptr(), b]
    args += _head_args(head, _padsum(head, fr), cfg, fr, n_pad, conv_scale,
                       dev)
    args += [logits.data_ptr(), count.data_ptr() if with_count else 0]
    _build.launch(dev, LAUNCHES, "nnue_head_kernel", "nnue_head_launch", args)
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
    with span("serve.kernels"):
        out = core(head_params, images_flat, cfg=cfg, image_h=image_h,
                   image_w=image_w, with_count=with_count,
                   input_mode=input_mode)
    return _with_density(*out, cfg)


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


def fused_head_call(
    head_params: Dict, acc: torch.Tensor, *, cfg: NNUESimCfg, n_pad: int,
    conv_scale: int, with_count: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The head kernel alone on a raw (B, FR) int32 conv accumulator (JAX
    `_fused_head_call`): epilogue at `conv_scale`, zero-fill of `n_pad`
    features, FT, dense layers. (logits, count or None)."""
    core = _head_plain if acc.device.type == "cpu" else _head_launch
    return core(head_params, acc, cfg=cfg, n_pad=n_pad, conv_scale=conv_scale,
                with_count=with_count)


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
