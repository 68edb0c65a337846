"""The gated photometric chain of one augmentation block as one Hopper
kernel (K5).

Port of `nnue_vision_tpu/ops/photometric_kernel.py:48-229`. After each
warp, the medium and heavy tiers apply a block of gated photometric ops;
`photometric_kernel` (`csrc/photometric.cu`) runs a whole block for one
image in shared memory:

    bc → HSV → separable 3×3 blur → gaussian noise → cutout, then
    medium:       HSV → shadow → fog → posterize → equalize
    heavy_extra:  a second cutout

All randomness comes in as arguments: per-sample `fparams` (B, F) float32
and `iparams` (B, I) int32 in the JAX package's column layouts (`MEDIUM_F`,
`MEDIUM_I`, `HEAVY_F`, `HEAVY_I`; a gate is a 0/1 float, on above 0.5) and
the unit-normal `noise` (B, H, W, 3). `photometric_block_reference` is the
same chain in eager torch in the kernel's order (the blur as two separable
passes, every division by a device tensor), so the kernel equals it bit for
bit; `photometric_unfused` is the JAX package's unfused op chain (the blur
as one 9-term depthwise conv) on the same parameters, which agrees with
both to float32 rounding.

`photometric_block` dispatches on the device of the images: a CPU tensor
takes the plain version, a CUDA tensor the kernel, which launches or raises.
Where one image and the blur's rows fit a block's shared memory
(`slot_fits`: up to 96×96), the kernel is a persistent grid that walks
images through one shared-memory slot per block, fed by bulk copies (the
noise is read only where its gate is on); `ops/_ring.py` sizes the grid
and launches. A larger image (224×224, or any shape past the slot) takes
the band path (`photometric_band_kernel`, then for the medium variant
`photometric_stretch_kernel`): one block per band of `band_rows(w)` rows of
an image, the chain up to posterize per pixel with the per-band min and
max, then the equalize's stretch for the images whose gate is on. Both
paths are bit-equal to the plain version and count their launches apart
(`photometric_kernel`, `photometric_band_kernel`: one per call). Both take
images of whole 16-byte units (H·W % 4 == 0).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.ops import _ring

# Launches since the last reset_launch_counts(); the wrapper adds one where
# it launches the kernel, and nowhere else.
LAUNCHES = tracing.counters("photometric_kernel", "photometric_kernel",
                            "photometric_band_kernel")

# fparams column layout (per sample); gates are 0.0/1.0 floats
MEDIUM_F = 24  # bc(3) hsv1(4) blur(1) noise(2) cut(1) hsv2(4) shadow(5)
#                fog(2) posterize(1) equalize(1)
MEDIUM_I = 4   # cutout y0, hh, x0, ww
HEAVY_F = 12   # bc(3) hsv(4) blur(1) noise(2) cutA(1) cutB(1)
HEAVY_I = 8    # two cutout rectangles
VARIANTS = {"medium": (MEDIUM_F, MEDIUM_I), "heavy_extra": (HEAVY_F, HEAVY_I)}
_F32 = torch.float32
# one block's shared memory on the H100, less 1 KB for the kernel's static
# shared memory, and the slot path's use of it (csrc/photometric.cu
# photometric_smem_bytes: the parameter header, the image and the blur's
# rows with a zero row above and below)
SMEM_MAX = 232448 - 1024
BAND_CELLS = 2048  # pixels per block of the band path


def slot_fits(h: int, w: int) -> bool:
    """Whether the slot path holds an h×w image: its header, the image and
    the blur's h + 2 rows fit one block's shared memory."""
    return 256 + (2 * h + 2) * w * 3 * 4 <= SMEM_MAX


def band_rows(w: int) -> int:
    """Rows per block of the band path: about BAND_CELLS pixels."""
    return max(1, BAND_CELLS // w)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(x, noise, fparams, iparams, variant) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}")
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] < 3 or x.shape[2] < 3:
        raise ValueError(f"x must be (B, H, W, 3) with H, W >= 3; got "
                         f"{tuple(x.shape)}")
    nf, ni = VARIANTS[variant]
    b = x.shape[0]
    if (noise.shape != x.shape or fparams.shape != (b, nf)
            or iparams.shape != (b, ni)):
        raise ValueError(
            f"{variant}: noise {tuple(x.shape)}, fparams ({b}, {nf}), iparams "
            f"({b}, {ni}) expected; got {tuple(noise.shape)}, "
            f"{tuple(fparams.shape)}, {tuple(iparams.shape)}")


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim float32 tensor on x's device: CUDA torch divides by a host
    scalar as a multiply by its reciprocal, by a device tensor exactly."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# the ops, each applied with its drawn parameters (per-sample (B, 1, 1, 1))
# ---------------------------------------------------------------------------


def apply_brightness_contrast(x, apply, bright, contr):
    out = torch.clamp((x - 0.5) * contr + 0.5 + bright, 0.0, 1.0)
    return torch.where(apply, out, x)


def apply_hsv(x, apply, hue, sat, val):
    """Hue as a channel shift (R + hue, B - hue), saturation as a blend
    with luma, value as a gain."""
    luma = x[..., :1] * 0.299 + x[..., 1:2] * 0.587 + x[..., 2:3] * 0.114
    shifted = torch.cat([x[..., :1] + hue, x[..., 1:2], x[..., 2:3] - hue],
                        dim=-1)
    out = torch.clamp((luma + (shifted - luma) * sat) * val, 0.0, 1.0)
    return torch.where(apply, out, x)


def apply_blur_separable(x, apply):
    """[1, 2, 1]ᵀ[1, 2, 1]/16 as two passes, zero outside the frame: the
    kernel's order."""
    xp = F.pad(x, (0, 0, 1, 1))
    t = (xp[:, :, :-2] + 2.0 * x) + xp[:, :, 2:]
    tp = F.pad(t, (0, 0, 0, 0, 1, 1))
    out = ((tp[:, :-2] + 2.0 * t) + tp[:, 2:]) * 0.0625
    return torch.where(apply, out, x)


def apply_blur_conv(x, apply):
    """The same blur as one depthwise 3×3 conv (the JAX package's unfused
    op)."""
    k = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                     device=x.device) / 16.0
    blurred = F.conv2d(x.permute(0, 3, 1, 2), k.expand(3, 1, 3, 3),
                       padding=1, groups=3).permute(0, 2, 3, 1)
    return torch.where(apply, blurred, x)


def apply_noise(x, apply, sigma, noise):
    return torch.where(apply, torch.clamp(x + noise * sigma, 0.0, 1.0), x)


def apply_cutout(x, apply, y0, hh, x0, ww):
    """Zero one rectangle per sample; y0, hh, x0, ww are (B,) integers."""
    _, h, w, _ = x.shape
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    hole = (
        (yy >= y0[:, None, None]) & (yy < (y0 + hh)[:, None, None])
        & (xx >= x0[:, None, None]) & (xx < (x0 + ww)[:, None, None])
    )[..., None]
    return torch.where(apply & hole, 0.0, x)


def apply_shadow(x, apply, cos, sin, offset, dark):
    """Darken the half-plane cos·xn + sin·yn > offset (centered, [-.5, .5)
    coordinates)."""
    _, h, w, _ = x.shape
    yy = torch.arange(h, device=x.device, dtype=torch.float32)
    xx = torch.arange(w, device=x.device, dtype=torch.float32)
    yn = (yy / _const(x, h) - 0.5)[None, :, None, None]
    xn = (xx / _const(x, w) - 0.5)[None, None, :, None]
    side = (cos * xn + sin * yn) > offset
    return torch.where(apply & side, x * dark, x)


def apply_fog(x, apply, amount):
    return torch.where(apply, x * (1.0 - amount) + amount, x)


def apply_posterize(x, apply):
    """4 bits per channel, round half to even."""
    fifteen = _const(x, 15.0)
    return torch.where(apply, torch.round(x * fifteen) / fifteen, x)


def apply_equalize(x, apply):
    """Per-image contrast stretch to [0, 1] (the equalize stand-in)."""
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(apply, (x - lo) / torch.clamp_min(hi - lo, 1e-6), x)


def _chain(x, noise, fparams, iparams, variant, blur):
    b = x.shape[0]

    def P(i):
        return fparams[:, i].reshape(b, 1, 1, 1)

    def G(i):
        return P(i) > 0.5

    def rect(j):
        return tuple(iparams[:, j + k] for k in range(4))

    x = apply_brightness_contrast(x, G(0), P(1), P(2))
    x = apply_hsv(x, G(3), P(4), P(5), P(6))
    x = blur(x, G(7))
    x = apply_noise(x, G(8), P(9), noise)
    x = apply_cutout(x, G(10), *rect(0))
    if variant == "medium":
        x = apply_hsv(x, G(11), P(12), P(13), P(14))
        x = apply_shadow(x, G(15), P(16), P(17), P(18), P(19))
        x = apply_fog(x, G(20), P(21))
        x = apply_posterize(x, G(22))
        x = apply_equalize(x, G(23))
    else:
        x = apply_cutout(x, G(11), *rect(4))
    return x


def photometric_block_reference(x, noise, fparams, iparams, *, variant):
    """What photometric_kernel computes, in plain torch: (B, H, W, 3)
    float32."""
    _check(x, noise, fparams, iparams, variant)
    return _chain(x, noise, fparams, iparams, variant, apply_blur_separable)


def photometric_unfused(x, noise, fparams, iparams, *, variant):
    """The JAX package's unfused chain on the same parameters (the blur as
    a 9-term depthwise conv)."""
    _check(x, noise, fparams, iparams, variant)
    return _chain(x, noise, fparams, iparams, variant, apply_blur_conv)


def _launch(x, noise, fparams, iparams, variant):
    # the checks, cheapest first, in one pass; each launch's host cost is
    # what a host-bound train step pays (PERF.md)
    dev = x.device
    if not (x.is_cuda and x.dtype is _F32 and noise.dtype is _F32
            and fparams.dtype is _F32 and iparams.dtype is torch.int32
            and noise.device == dev and fparams.device == dev
            and iparams.device == dev):
        if not x.is_cuda:
            raise ValueError(f"photometric_kernel runs on CUDA tensors only "
                             f"(got {dev}); CPU tensors take the plain version")
        raise ValueError(
            "photometric_kernel takes float32 x, noise and fparams and int32 "
            f"iparams on one device; got {x.dtype} on {dev}, {noise.dtype} on "
            f"{noise.device}, {fparams.dtype} on {fparams.device}, "
            f"{iparams.dtype} on {iparams.device}")
    b, h, w, _ = x.shape
    if (h * w) % 4:
        raise ValueError(f"photometric_kernel takes images of whole 16-byte "
                         f"units (H·W % 4 == 0); got {h}x{w}")
    out = torch.empty_like(x)
    if b == 0:
        return out
    xp, op = x.data_ptr(), out.data_ptr()
    nf, ni = VARIANTS[variant]
    medium = int(variant == "medium")
    head = (xp, noise.data_ptr(), fparams.data_ptr(), iparams.data_ptr(),
            b, h, w, nf, ni, medium)
    if not slot_fits(h, w):  # the band path: both kernels, one count
        rows = band_rows(w)
        minmax = torch.empty((b * -(-h // rows) * 2 if medium else 0,),
                             dtype=_F32, device=dev)
        _ring.launch(dev, "photometric_band_kernel", "photometric_band_launch",
                     head + (rows, minmax.data_ptr() if medium else 0, op))
        LAUNCHES["photometric_band_kernel"] += 1
        return out
    if (xp | op) & 15:
        raise ValueError("photometric_kernel: x must start at a 16-byte "
                         "boundary")
    grid = _ring.grid(dev, b, "photometric_blocks_per_sm", h, w)
    _ring.launch(dev, "photometric_kernel", "photometric_launch",
                 head + (grid, op))
    LAUNCHES["photometric_kernel"] += 1
    return out


def photometric_block(x, noise, fparams, iparams, *, variant):
    """One photometric block: x, noise (B, H, W, 3) float32, fparams
    (B, F) float32, iparams (B, I) int32 → (B, H, W, 3) float32."""
    if x.device.type == "cpu":
        return photometric_block_reference(x, noise, fparams, iparams,
                                           variant=variant)
    _check(x, noise, fparams, iparams, variant)
    return _launch(x.contiguous(), noise.contiguous(), fparams.contiguous(),
                   iparams.contiguous(), variant)
