"""The fused light-tier input pipeline: gather → flip → brightness/contrast
→ cutout → ImageNet normalize, one kernel per train step (K3).

Port of `nnue_vision_tpu/ops/input_pipeline.py:58-274`. The Hopper kernel
`light_pipeline_kernel` (`csrc/light_pipeline.cu`) computes what the TPU's
`_gather_augment_kernel` computes, bit for bit equal to the plain version
beside it (`fused_light_pipeline_reference`). The calling convention is the
JAX package's: `idx_eff` lies in [0, 2N), and an index ≥ N means row
idx - N read W-flipped, so the step functions map one to one. The dataset
itself is held once, as (N, H, W, 3) float32: the TPU kept a W-flipped
second copy padded to 128 lanes, which the kernel's reversed column index
replaces.

All randomness is drawn on the host from a CPU `torch.Generator`
(`draw_light_params`), with the light tier's distributions folded to a
flip bit, an (α, β) pair and a hole rectangle per sample.

`fused_light_pipeline` dispatches on the device of the dataset: a CPU
tensor takes the plain version, a CUDA tensor the kernel, which launches or
raises. There is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nnue_vision_tpu_torch.data.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    uniform,
    normalize_images,
)

# Launches since the last reset_launch_counts(); the wrapper adds one where
# it launches the kernel, and nowhere else.
LAUNCHES = {"light_pipeline_kernel": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class LightParams(NamedTuple):
    """Per-sample light-tier draws; leading dims (..., B)."""
    flip: torch.Tensor  # bool; folded into the gather index
    pf: torch.Tensor    # (..., B, 2) f32: [alpha, beta]
    pi: torch.Tensor    # (..., B, 4) i32: [y0, y1, x0, x1] (y1 <= y0: no hole)


def prepare_gather_dataset(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) float [0,1] → the kernel's dataset: the same images as
    one contiguous float32 tensor on their device (no flipped copy, no
    lane padding)."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (N, H, W, 3); got {tuple(images.shape)}")
    return images.to(torch.float32).contiguous()


def draw_light_params(gen: torch.Generator, steps: int, batch: int,
                      h: int, w: int) -> LightParams:
    """All light-tier randomness for `steps` steps of `batch` samples, as
    CPU tensors of leading shape (steps, batch): hflip p .5; brightness/
    contrast p .2 with limits ±0.1, folded to x·α + β; cutout p .2 with a
    side of max(1, frac·size), frac ∈ [0.05, 0.051)."""
    shape = (steps, batch)
    flip = uniform(gen, shape) < 0.5

    bc_apply = uniform(gen, shape) < 0.2
    bright = uniform(gen, shape, -0.1, 0.1)
    contr = 1.0 + uniform(gen, shape, -0.1, 0.1)
    alpha = torch.where(bc_apply, contr, 1.0)
    beta = torch.where(bc_apply, 0.5 - 0.5 * contr + bright, 0.0)
    pf = torch.stack([alpha, beta], dim=-1).to(torch.float32)

    cut_apply = uniform(gen, shape) < 0.2
    frac = uniform(gen, shape, 0.05, 0.051)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (uniform(gen, shape) * (h - hh)).to(torch.int32)
    x0 = (uniform(gen, shape) * (w - ww)).to(torch.int32)
    zero = torch.zeros_like(y0)
    pi = torch.stack([
        torch.where(cut_apply, y0, zero), torch.where(cut_apply, y0 + hh, zero),
        torch.where(cut_apply, x0, zero), torch.where(cut_apply, x0 + ww, zero),
    ], dim=-1).to(torch.int32)
    return LightParams(flip=flip, pf=pf, pi=pi)


def identity_light_params(steps: int, batch: int) -> LightParams:
    """No flip, α = 1, β = 0, no hole: the pipeline is then gather +
    normalize exactly."""
    return LightParams(
        flip=torch.zeros((steps, batch), dtype=torch.bool),
        pf=torch.tensor([1.0, 0.0]).repeat(steps, batch, 1),
        pi=torch.zeros((steps, batch, 4), dtype=torch.int32),
    )


def light_pipeline_reference(images: torch.Tensor, idx: torch.Tensor,
                             params_step: LightParams) -> torch.Tensor:
    """Plain torch, the JAX package's oracle: gather → flip →
    clip(x·α + β, 0, 1) (product rounded, then the sum) → cutout → normalize
    (divide by std). (B, H, W, 3) float32."""
    x = images[idx]
    x = torch.where(params_step.flip[:, None, None, None], x.flip(2), x)
    alpha = params_step.pf[:, 0][:, None, None, None]
    beta = params_step.pf[:, 1][:, None, None, None]
    x = torch.clamp(x * alpha + beta, 0.0, 1.0)
    h, w = x.shape[1], x.shape[2]
    yy = torch.arange(h, device=x.device)[None, :, None, None]
    xx = torch.arange(w, device=x.device)[None, None, :, None]
    pi = params_step.pi
    hole = (
        (yy >= pi[:, 0][:, None, None, None])
        & (yy < pi[:, 1][:, None, None, None])
        & (xx >= pi[:, 2][:, None, None, None])
        & (xx < pi[:, 3][:, None, None, None])
    )
    x = torch.where(hole, 0.0, x)
    return normalize_images(x)


def _check_args(dataset, idx_eff, pf, pi, h, w) -> None:
    if dataset.dim() != 4 or tuple(dataset.shape[1:]) != (h, w, 3):
        raise ValueError(
            f"dataset must be (N, {h}, {w}, 3); got {tuple(dataset.shape)}")
    b = idx_eff.shape[0]
    if (idx_eff.dim() != 1 or tuple(pf.shape) != (b, 2)
            or tuple(pi.shape) != (b, 4)):
        raise ValueError(
            f"idx_eff (B,), pf (B, 2), pi (B, 4) expected; got "
            f"{tuple(idx_eff.shape)}, {tuple(pf.shape)}, {tuple(pi.shape)}")


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or t.data_ptr() % t.element_size()):
        raise ValueError(
            f"{name}: the kernel takes a contiguous, aligned {dtype} tensor "
            f"on {device}; got {t.dtype} on {t.device} (contiguous="
            f"{t.is_contiguous()}, address {t.data_ptr():#x})")


def _launch(dataset, idx_eff, pf, pi, h, w):
    """light_pipeline_kernel on CUDA tensors."""
    from nnue_vision_tpu_torch.ops._build import load_library

    dev = dataset.device
    if dev.type != "cuda":
        raise ValueError(
            f"light_pipeline_kernel runs on CUDA tensors only (got {dev}); "
            "CPU tensors take the plain version")
    b = idx_eff.shape[0]
    if 2 * dataset.shape[0] >= 2**31:
        raise ValueError("the kernel takes int32 indices: 2N must be < 2^31")
    _require(dataset, "dataset", torch.float32, dev)
    _require(idx_eff, "idx_eff", torch.int32, dev)
    _require(pf, "pf", torch.float32, dev)
    _require(pi, "pi", torch.int32, dev)
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.light_pipeline_launch(
            dataset.data_ptr(), dataset.shape[0], h, w, idx_eff.data_ptr(),
            pf.data_ptr(), pi.data_ptr(), b, *IMAGENET_MEAN, *IMAGENET_STD,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            "light_pipeline_kernel launch failed: "
            f"{lib.nnue_error_string(err).decode()}")
    LAUNCHES["light_pipeline_kernel"] += 1
    return out


def fused_light_pipeline(dataset: torch.Tensor, idx_eff: torch.Tensor,
                         pf: torch.Tensor, pi: torch.Tensor, *, h: int,
                         w: int) -> torch.Tensor:
    """One step's batch: (B, H, W, 3) float32 from `dataset` ((N, H, W, 3)
    from `prepare_gather_dataset`), `idx_eff` (B,) int32 in [0, 2N) with the
    flip folded in as +N, `pf` (B, 2) float32 [α, β], `pi` (B, 4) int32
    [y0, y1, x0, x1]. Indices are the caller's to check (on the host, while
    they are numpy); the kernel writes NaN for a row whose index is out of
    range rather than read outside the dataset."""
    if dataset.device.type == "cpu":
        return fused_light_pipeline_reference(dataset, idx_eff, pf, pi, h=h, w=w)
    _check_args(dataset, idx_eff, pf, pi, h, w)
    return _launch(dataset, idx_eff, pf, pi, h, w)


def fused_light_pipeline_reference(dataset: torch.Tensor,
                                   idx_eff: torch.Tensor, pf: torch.Tensor,
                                   pi: torch.Tensor, *, h: int,
                                   w: int) -> torch.Tensor:
    """`fused_light_pipeline` in plain torch, on any device: what
    light_pipeline_kernel computes."""
    _check_args(dataset, idx_eff, pf, pi, h, w)
    n = dataset.shape[0]
    idx = idx_eff.to(torch.int64)
    flip = idx >= n
    return light_pipeline_reference(
        dataset, torch.where(flip, idx - n, idx), LightParams(flip, pf, pi))
