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

The kernel is a persistent grid over items, each one bulk copy into a
block's shared memory (`csrc/bulk_ring.cuh`, `ops/_ring.py`): an item is a
band of at most `BAND_CELLS` pixels of one image, whole rows, or a
segment of one row where a row is wider. `band_plan` picks the bands, in
plain Python so that the CPU tests hold it; `ops/_ring.py` sizes the grid
and launches. Every shape goes through the kernel: where a band's bytes are
not whole 16-byte units at 16-byte boundaries (H·W % 4 != 0), the kernel
moves the few values at either end with plain loads and stores.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple

import torch

from nnue_vision_tpu_torch.data.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    uniform,
    normalize_images,
)
from nnue_vision_tpu_torch.ops import _ring

# Launches since the last reset_launch_counts(); the wrapper adds one where
# it launches the kernel, and nowhere else.
LAUNCHES = {"light_pipeline_kernel": 0}


# Pixels per item at most: a block's two shared-memory regions of one band
# each (csrc/light_pipeline.cu kCells).
BAND_CELLS = 1024
_F32, _I32 = torch.float32, torch.int32
# the mean and std as six float32 packed two to an int64 argument
_NORM = struct.unpack("<3q", struct.pack("<6f", *IMAGENET_MEAN, *IMAGENET_STD))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class BandPlan(NamedTuple):
    """The kernel's items for an h×w image: bands of `rows` rows of `cols`
    pixels (`cols` < w only for rows wider than BAND_CELLS, one row a band);
    `aligned`: every item's bytes are whole 16-byte units at 16-byte
    offsets from the image's start, so that a bulk copy moves all of them."""
    rows: int
    cols: int
    aligned: bool


@functools.lru_cache(maxsize=None)
def band_plan(h: int, w: int) -> BandPlan:
    """The bands of an h×w image: as many whole rows as BAND_CELLS holds
    (the whole image up to 1024 pixels), trimmed where that keeps every
    band on a 16-byte boundary; a row wider than BAND_CELLS in segments of
    BAND_CELLS pixels."""
    if h <= 0 or w <= 0:
        raise ValueError(f"an image has at least one pixel; got {h}x{w}")
    if w > BAND_CELLS:
        return BandPlan(1, BAND_CELLS, w % 4 == 0)
    rows = min(h, BAND_CELLS // w)
    step = 4 // math.gcd(w, 4)  # rows·w % 4 == 0 for a multiple of step
    if rows < h and (h * w) % 4 == 0 and rows >= step:
        rows -= rows % step
    return BandPlan(rows, w, (h * w) % 4 == 0 and (rows == h or rows * w % 4 == 0))


def _items(batch: int, h: int, w: int) -> tuple:
    """(rows, cols, items): the band plan and the kernel's item count."""
    rows, cols, _ = band_plan(h, w)
    return rows, cols, batch * -(-h // rows) * -(-w // cols)


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


def _launch(dataset, idx_eff, pf, pi, h, w, stamps=None):
    """light_pipeline_kernel on CUDA tensors; `stamps`, an int64 (items, 5)
    tensor or None, takes the blocks' clocks (`light_pipeline_phases`)."""
    # the checks, cheapest first, in one pass; each launch's host cost is
    # what an eager train step pays (PERF.md)
    dev = dataset.device
    if not (dataset.is_cuda and dataset.dtype is _F32 and idx_eff.dtype is _I32
            and pf.dtype is _F32 and pi.dtype is _I32 and idx_eff.device == dev
            and pf.device == dev and pi.device == dev
            and dataset.is_contiguous() and idx_eff.is_contiguous()
            and pf.is_contiguous() and pi.is_contiguous()):
        if not dataset.is_cuda:
            raise ValueError(
                f"light_pipeline_kernel runs on CUDA tensors only (got {dev}); "
                "CPU tensors take the plain version")
        _require(dataset, "dataset", _F32, dev)
        _require(idx_eff, "idx_eff", _I32, dev)
        _require(pf, "pf", _F32, dev)
        _require(pi, "pi", _I32, dev)
    n, b = dataset.shape[0], idx_eff.shape[0]
    if 2 * n >= 2**31:
        raise ValueError("the kernel takes int32 indices: 2N must be < 2^31")
    out = torch.empty((b, h, w, 3), dtype=_F32, device=dev)
    if b == 0:
        return out
    rows, cols, items = _items(b, h, w)
    if items >= 2**30:
        raise ValueError(f"the kernel walks fewer than 2^30 bands; got {items}")
    grid = _ring.grid(dev, items, "light_pipeline_blocks_per_sm", rows, cols)
    _ring.launch(dev, "light_pipeline_kernel", "light_pipeline_launch",
                 (dataset.data_ptr(), n, h, w, idx_eff.data_ptr(),
                  pf.data_ptr(), pi.data_ptr(), b, rows, cols, grid,
                  out.data_ptr()) + _NORM
                 + (0 if stamps is None else stamps.data_ptr(),))
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
    if dataset.is_cpu:
        return fused_light_pipeline_reference(dataset, idx_eff, pf, pi, h=h, w=w)
    _check_args(dataset, idx_eff, pf, pi, h, w)
    return _launch(dataset, idx_eff, pf, pi, h, w)


PHASES = ("scalars", "copy", "compute", "store")


def light_pipeline_phases(dataset: torch.Tensor, idx_eff: torch.Tensor,
                          pf: torch.Tensor, pi: torch.Tensor, *, h: int,
                          w: int) -> dict:
    """Where one launch of the kernel spends a block's time, for the
    profiling probes: the median over the blocks of the SM cycles from a
    block's start to its first item's copy issued (the item's scalars read:
    `scalars`), to that copy landed (`copy`), to the item's results in
    shared memory (`compute`) and to the block's end with its stores done
    (`store`; for a block of several items, all of them). CUDA tensors
    only; the launch counts as one."""
    _check_args(dataset, idx_eff, pf, pi, h, w)
    items = _items(idx_eff.shape[0], h, w)[2]
    stamps = torch.zeros((items, 5), dtype=torch.int64, device=dataset.device)
    _launch(dataset, idx_eff, pf, pi, h, w, stamps)
    clocks = stamps[stamps[:, 4] != 0].double()  # the grid's blocks
    return dict(zip(PHASES, clocks.diff(dim=1).median(dim=0).values.tolist()))


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
