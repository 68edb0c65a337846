"""Input normalization and the light augmentation tier (port of
`nnue_vision_tpu/data/augment.py:40-60, 487-498, 609-670, 741-751`).

Images are float32 [0, 1] NHWC on any device. Per-sample random draws are
made on the host from a CPU `torch.Generator` and moved to the images'
device, so a seed gives the same augmentation on the CPU and on the card.
The streams differ from `jax.random`'s: tests feed both packages the same
drawn parameters, and check the draws' distributions.

The medium and heavy tiers (composed warps on K4, the photometric chain on
K5) come with the EtinyNet slice (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

STRENGTHS = ("light", "medium", "heavy")


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with ImageNet statistics; NHWC float in [0,1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    """U[lo, hi) float32 on the host from `gen`, like `jax.random.uniform`."""
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _bernoulli(gen, p, b):
    return uniform(gen, (b, 1, 1, 1)) < p


def _bc_draw(gen, b, p, limit):
    apply = _bernoulli(gen, p, b)
    bright = uniform(gen, (b, 1, 1, 1), -limit, limit)
    contr = 1.0 + uniform(gen, (b, 1, 1, 1), -limit, limit)
    return apply, bright, contr


def apply_brightness_contrast(x, apply, bright, contr):
    out = torch.clamp((x - 0.5) * contr + 0.5 + bright, 0.0, 1.0)
    return torch.where(apply, out, x)


def _cutout_draw(gen, b, h, w, p, size_range):
    apply = _bernoulli(gen, p, b)
    frac = uniform(gen, (b,), *size_range)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (uniform(gen, (b,)) * (h - hh)).to(torch.int32)
    x0 = (uniform(gen, (b,)) * (w - ww)).to(torch.int32)
    return apply, y0, hh, x0, ww


def apply_cutout(x, apply, y0, hh, x0, ww):
    _, h, w, _ = x.shape
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    hole = (
        (yy >= y0[:, None, None]) & (yy < (y0 + hh)[:, None, None])
        & (xx >= x0[:, None, None]) & (xx < (x0 + ww)[:, None, None])
    )[..., None]
    return torch.where(apply & hole, 0.0, x)


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  strength: str = "medium") -> torch.Tensor:
    """One augmentation tier on a float [0,1] NHWC batch. Light: hflip
    (p .5), brightness/contrast ±0.1 (p .2), one cutout hole of 5% (p .2)."""
    if strength not in STRENGTHS:
        raise ValueError(f"strength must be one of {STRENGTHS}")
    if strength != "light":
        raise NotImplementedError(
            f"the {strength!r} augmentation tier is not ported yet; it comes "
            "with the EtinyNet slice (ROADMAP Queue A item 5)"
        )
    x = images
    b, h, w, _ = x.shape
    dev = x.device
    flip = _bernoulli(gen, 0.5, b).to(dev)
    x = torch.where(flip, x.flip(2), x)
    x = apply_brightness_contrast(
        x, *(t.to(dev) for t in _bc_draw(gen, b, 0.2, 0.1)))
    x = apply_cutout(
        x, *(t.to(dev) for t in _cutout_draw(gen, b, h, w, 0.2, (0.05, 0.051))))
    return x


def preprocess_batch(gen: torch.Generator, images: torch.Tensor,
                     strength: str = "medium", augment: bool = True
                     ) -> torch.Tensor:
    """augment (train only) → normalize, the device-side entry point of the
    train and eval loops."""
    x = augment_batch(gen, images, strength) if augment else images
    return normalize_images(x)
