"""Input normalization and the three augmentation tiers (port of
`nnue_vision_tpu/data/augment.py:40-60, 97-181, 382-466, 487-751`).

Images are float32 [0, 1] NHWC on any device. Per-sample random draws are
made on the host from a CPU `torch.Generator` and moved to the images'
device, so a seed gives the same augmentation on the CPU and on the card.
The streams differ from `jax.random`'s: tests feed both packages the same
drawn parameters, and check the draws' distributions.

Light: hflip (p .5), brightness/contrast ±0.1 (p .2), one 5% cutout (p .2).

Medium and heavy: the geometric ops (flip, rot90, rotate, affine) each
draw their gate and parameters and compose, per sample, into one inverse
map (M, v) per block (`_mv_compose`, its 2×2 products elementwise in
`bmm`'s order and sign of zero: `_mm`), realized by one warp chosen by
shape with the JAX package's rule (`_warp`, augment.py:403-425;
`two_pass_warp`): for a square image with h·w·w ≤ 2^17 (32×32, up to
50×50) the two-pass resample (K4, `ops/warp_kernel.py`, which on the card
takes an even n and raises otherwise), else the single-pass bilinear
gather `warp_gather` (JAX `_warp_gather`, computed by XLA there and by
plain torch here, on both devices), which at 224×224 is another function
for a fractional rotation. Then the block's gated photometric chain runs
as one K5 launch (`ops/photometric_kernel.py`) at any image size. The
heavy tier's second block (its own geometry, one more warp, then
`heavy_extra`) runs after the medium photometric block, the reference op
order. Every photometric op is a draw helper (`_*_draw`) and an apply step
(`ops/photometric_kernel.py`), drawn in the JAX package's order. Each tier
is a draw and an apply: `draw_chunk` makes all of K steps' draws on the
host and packs them into (K, S) int32 rows (float fields bit-cast, bools
as 0/1; `draw_batch` is its K = 1 case), `batch_draws` reads a step's row
as views once it lies on the images' device, and `apply_draws` runs the
tier with no copy to the device inside it, so a CUDA graph can replay it
on new draws
(`training/step.py`); `draw_tier` is the three for one step with one
upload. The two full-batch unit-normal noise tensors of the medium and
heavy tiers are drawn on the images' device from a generator of that
device, seeded once from the host generator (`device_generator`).

A chunk's draws are one host generator call: CPU `torch.rand` (and
`randint` of a range under 2^32) takes one 32-bit mt19937 value per
element, in order, so one (K, F, B) `torch.rand` is, element for element,
the F fields of each of K steps drawn one call a field. The draw helpers
take a *source*: a `torch.Generator` draws each field with its own call
(the per-step stream, which tests and profilers call directly); a `Fields`
block hands out its next field as K·B rows, already scaled to the range
`uniform` asks of it (`_ranges`, listed by one pass of the helpers over a
recording source), and every field is derived from those rows in one
pass, in the same order, on one intra-op thread (`_one_thread`). The
rot90 choice, `randint(0, 4)` = value % 4, is the low two of the 24 bits
that `rand` keeps: int(u · 2^24) % 4. The packed rows and the generator's
state are those of K per-step draws made field by field, bit for bit.

The tensor's device picks the realization: the kernels on a CUDA tensor,
their plain versions on a CPU one.

`shard=(index, count)`: the images are shard `index` of `count` equal
shards of a global batch (a data-parallel rank's rows). Every draw, and
the device noise, is made for the global batch, and the shard's rows are
kept, so the shards of a dp step see what one process sees on the whole
batch.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.ops.photometric_kernel import (
    VARIANTS,
    apply_brightness_contrast,
    apply_cutout,
    photometric_block,
)
from nnue_vision_tpu_torch.ops.warp_kernel import (
    PARAMS as WARP_PARAMS,
    pack_warp_params,
    warp_bilinear,
    warp_coefficients,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

STRENGTHS = ("light", "medium", "heavy")

# Host generator calls of the draws (`uniform` and the rot90 choice on a
# generator, `draw_chunk`'s one call; not `device_generator`'s one seed):
# `training/step.py` reads a chunk's draws as the delta.
DRAWS = tracing.counters("draws", "host_draw_calls")

MV = Tuple[torch.Tensor, torch.Tensor]  # (M (B, 2, 2), v (B, 2)) float32
Shard = Tuple[int, int]  # (index, count) of equal shards of a global batch
WHOLE: Shard = (0, 1)


def shard_rows(b: int, shard: Shard) -> slice:
    """Shard `shard`'s rows of a global batch of b."""
    index, count = shard
    return slice(index * (b // count), (index + 1) * (b // count))


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device, dtype: torch.dtype):
    """The ImageNet statistics as (3,) tensors on `device`, made once per
    device and dtype (a copy to the card can not run inside a CUDA graph's
    capture); never written."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with ImageNet statistics; NHWC float in [0,1]."""
    mean, std = _mean_std(images.device, images.dtype)
    return (images - mean) / std


class Fields:
    """A chunk's uniforms as a draw source: `u` (F, R) float32, field f's R
    rows (K·B, step-major) already scaled to the range `uniform` asks of it
    (`_ranges`), handed out in order."""

    def __init__(self, u: torch.Tensor):
        self.u, self.taken = u, 0

    def take(self, shape, lo: float, hi: float) -> torch.Tensor:
        field = self.u[self.taken].view(shape)
        self.taken += 1
        return field


class _Ranges:
    """A draw source that notes the range `uniform` asks of each field and
    hands out zeros: one pass of the helpers lists a tier's fields."""

    def __init__(self):
        self.lo, self.width = [], []

    def take(self, shape, lo: float, hi: float) -> torch.Tensor:
        self.lo.append(lo)
        self.width.append(hi - lo)
        return torch.zeros(shape)


Source = Union[torch.Generator, Fields, _Ranges]


def uniform(gen: Source, shape, lo: float = 0.0, hi: float = 1.0):
    """U[lo, hi) float32 on the host from `gen`, like `jax.random.uniform`."""
    if not isinstance(gen, torch.Generator):
        return gen.take(shape, lo, hi)
    DRAWS["host_draw_calls"] += 1
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _rot90_choice(src: Source, b: int) -> torch.Tensor:
    """randint(0, 4) of b rows: the generator's own call, or the low two of
    the block's next field's 24 bits (the same value)."""
    if not isinstance(src, torch.Generator):
        return (src.take((b,), 0.0, 1.0) * 2 ** 24).to(torch.int64) & 3
    DRAWS["host_draw_calls"] += 1
    return torch.randint(0, 4, (b,), generator=src)


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on `device`, seeded by one draw from the host `gen`:
    the noise tensors are drawn where the images are."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def _bernoulli(gen, p, b):
    return uniform(gen, (b, 1, 1, 1)) < p


# ---------------------------------------------------------------------------
# photometric draws, each the JAX helper's draws in its order
# ---------------------------------------------------------------------------


def _bc_draw(gen, b, p, limit):
    apply = _bernoulli(gen, p, b)
    bright = uniform(gen, (b, 1, 1, 1), -limit, limit)
    contr = 1.0 + uniform(gen, (b, 1, 1, 1), -limit, limit)
    return apply, bright, contr


def _hsv_draw(gen, b, p, hue_lim, sat_lim, val_lim):
    apply = _bernoulli(gen, p, b)
    hue = uniform(gen, (b, 1, 1, 1), -hue_lim, hue_lim)
    sat = 1.0 + uniform(gen, (b, 1, 1, 1), -sat_lim, sat_lim)
    val = 1.0 + uniform(gen, (b, 1, 1, 1), -val_lim, val_lim)
    return apply, hue, sat, val


def _noise_draw(gen, b, p, sigma_range):
    """Gate and sigma; the unit-normal tensor is drawn on the device."""
    apply = _bernoulli(gen, p, b)
    sigma = uniform(gen, (b, 1, 1, 1), *sigma_range)
    return apply, sigma


def _cutout_draw(gen, b, h, w, p, size_range):
    apply = _bernoulli(gen, p, b)
    frac = uniform(gen, (b,), *size_range)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (uniform(gen, (b,)) * (h - hh)).to(torch.int32)
    x0 = (uniform(gen, (b,)) * (w - ww)).to(torch.int32)
    return apply, y0, hh, x0, ww


def _shadow_draw(gen, b, p):
    apply = _bernoulli(gen, p, b)
    theta = uniform(gen, (b, 1, 1), 0.0, 2 * math.pi)
    offset = uniform(gen, (b, 1, 1), -0.3, 0.3)
    dark = uniform(gen, (b, 1, 1, 1), 0.4, 0.7)
    return apply, theta, offset, dark


def _fog_draw(gen, b, p):
    apply = _bernoulli(gen, p, b)
    amount = uniform(gen, (b, 1, 1, 1), 0.1, 0.4)
    return apply, amount


def _cols(*values) -> torch.Tensor:
    """(B, k) float32 from per-sample draws of any (B, ...) shape, float32
    or bool (promoted: 1.0 or 0.0)."""
    return torch.cat([v.view(-1, 1) for v in values], dim=1)


def draw_medium_photometric(gen, b, h, w):
    """fparams (B, 24), iparams (B, 4) of the medium block, in the kernel's
    layout (JAX `_photometric_medium_fused`)."""
    bc = _bc_draw(gen, b, 0.3, 0.2)
    h1 = _hsv_draw(gen, b, 0.3, 10 / 255.0, 0.15, 10 / 255.0)
    bl = _bernoulli(gen, 0.2, b)
    nz = _noise_draw(gen, b, 0.2, (0.01, 0.05))
    ct_a, y0, hh, x0, ww = _cutout_draw(gen, b, h, w, 0.3, (0.05, 0.15))
    h2 = _hsv_draw(gen, b, 0.2, 8 / 255.0, 0.1, 8 / 255.0)
    sh_a, theta, offset, dark = _shadow_draw(gen, b, 0.1)
    fog = _fog_draw(gen, b, 0.1)
    po = _bernoulli(gen, 0.1, b)
    eq = _bernoulli(gen, 0.1, b)
    fparams = _cols(*bc, *h1, bl, *nz, ct_a, *h2, sh_a, torch.cos(theta),
                    torch.sin(theta), offset, dark, *fog, po, eq)
    iparams = torch.stack([y0, hh, x0, ww], dim=1).to(torch.int32)
    return fparams, iparams


def draw_heavy_photometric(gen, b, h, w):
    """fparams (B, 12), iparams (B, 8) of the heavy-extra block (JAX
    `_photometric_heavy_fused`)."""
    bc = _bc_draw(gen, b, 0.2, 0.3)
    hv = _hsv_draw(gen, b, 0.2, 15 / 255.0, 0.2, 15 / 255.0)
    bl = _bernoulli(gen, 0.2, b)
    nz = _noise_draw(gen, b, 0.2, (0.05, 0.1))
    c1_a, *rect1 = _cutout_draw(gen, b, h, w, 0.2, (0.1, 0.25))
    c2_a, *rect2 = _cutout_draw(gen, b, h, w, 0.2, (0.1, 0.25))
    fparams = _cols(*bc, *hv, bl, *nz, c1_a, c2_a)
    iparams = torch.stack([*rect1, *rect2], dim=1).to(torch.int32)
    return fparams, iparams


# ---------------------------------------------------------------------------
# composed geometry: per-sample inverse maps src = M·dst_c + v
# ---------------------------------------------------------------------------


# A map's M (B, 2, 2) is stored entry-major (its memory (2, 2, B)) and v
# (B, 2) as (2, B), so every elementwise op and 2×2 product runs along B.
_EYE = torch.eye(2)
# the four rotations' entries, (4 entries, 4 choices); choice 0 the identity
_ROT90 = torch.tensor([
    [[1.0, 0.0], [0.0, 1.0]],
    [[0.0, 1.0], [-1.0, 0.0]],
    [[-1.0, 0.0], [0.0, -1.0]],
    [[0.0, -1.0], [1.0, 0.0]],
]).reshape(4, 4).T.contiguous()


def _m(entries: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) over (4, B) entries m00, m01, m10, m11."""
    return entries.view(2, 2, -1).permute(2, 0, 1)


def _v(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """(B, 2) over a (2, B) stack."""
    return torch.stack([v0, v1]).T


def _mv_identity(b: int) -> MV:
    return _EYE.repeat(b, 1, 1), torch.zeros((b, 2))


def _mm(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m (B, 2, 2) @ x (B, 2, n) elementwise, summed as `bmm`'s CPU kernel
    sums a small product: from +0, so two −0 terms give +0. Bit-equal to
    `m @ x` (tests), without its loop over the B matrices."""
    return (m[:, :, 0:1] * x[:, 0:1, :] + 0.0) + m[:, :, 1:2] * x[:, 1:2, :]


def _mv_compose(mv_prev: MV, mv_new: MV) -> MV:
    """The transform applied after the existing chain: the overall inverse
    map becomes prev ∘ new (sample through the newest op first)."""
    m1, v1 = mv_prev
    m2, v2 = mv_new
    return _mm(m1, m2), _mm(m1, v2[:, :, None])[:, :, 0] + v1


def geom_hflip(apply: torch.Tensor) -> MV:
    one, zero = torch.ones(apply.shape), torch.zeros(apply.shape)
    m = _m(torch.stack([one, zero, zero, torch.where(apply, -1.0, one)]))
    return m, _v(zero, zero)


def geom_rot90(apply: torch.Tensor, choice: torch.Tensor) -> MV:
    """Exact 0/90/180/270° rotations (integer entries, so the warp lands
    on grid points for square images); off, the identity (choice 0)."""
    zero = torch.zeros(apply.shape)
    k = torch.where(apply, choice, 0)
    return _m(_ROT90.index_select(1, k)), _v(zero, zero)


def geom_affine(apply, deg, tx, ty, sc) -> MV:
    """Rotation by `deg`, translation (ty, tx) pixels, isotropic scale `sc`
    as the inverse map src_c = R(-θ)/s · (dst_c - t)."""
    theta = deg * (math.pi / 180.0)
    cos = torch.cos(theta) / sc
    sin = torch.sin(theta) / sc
    m = _m(torch.stack([cos, sin, -sin, cos]))
    v = -_mm(m, _v(ty, tx)[:, :, None])[:, :, 0]
    a = apply.reshape(-1, 1, 1)
    return torch.where(a, m, _EYE), torch.where(a[:, :, 0], v, 0.0)


def _geom_hflip_draw(gen, b, p):
    return geom_hflip(uniform(gen, (b,)) < p)


def _geom_rot90_draw(gen, b, p):
    apply = uniform(gen, (b,)) < p
    return geom_rot90(apply, _rot90_choice(gen, b))


def _geom_affine_draw(gen, b, p, max_deg, max_translate, scale_range, h, w):
    apply = uniform(gen, (b,)) < p
    deg = uniform(gen, (b,), -max_deg, max_deg)
    tx = uniform(gen, (b,), -max_translate, max_translate) * w
    ty = uniform(gen, (b,), -max_translate, max_translate) * h
    sc = uniform(gen, (b,), *scale_range)
    return geom_affine(apply, deg, tx, ty, sc)


def draw_medium_geometry(gen, b, h, w) -> MV:
    """hflip (.5) → rot90 (.5) → rotate ±15° (.3) → affine ±15°, ±10%,
    0.9–1.1 (.3), composed."""
    mv = _geom_hflip_draw(gen, b, 0.5)
    mv = _mv_compose(mv, _geom_rot90_draw(gen, b, 0.5))
    mv = _mv_compose(mv, _geom_affine_draw(gen, b, 0.3, 15.0, 0.0,
                                           (1.0, 1.0001), h, w))
    return _mv_compose(mv, _geom_affine_draw(gen, b, 0.3, 15.0, 0.1,
                                             (0.9, 1.1), h, w))


def draw_heavy_geometry(gen, b, h, w) -> MV:
    """hflip (.1) → rot90 (.1) → rotate ±25° (.2) → affine ±25°, ±15%,
    0.85–1.15 (.2), composed."""
    mv = _geom_hflip_draw(gen, b, 0.1)
    mv = _mv_compose(mv, _geom_rot90_draw(gen, b, 0.1))
    mv = _mv_compose(mv, _geom_affine_draw(gen, b, 0.2, 25.0, 0.0,
                                           (1.0, 1.0001), h, w))
    return _mv_compose(mv, _geom_affine_draw(gen, b, 0.2, 25.0, 0.15,
                                             (0.85, 1.15), h, w))


# ---------------------------------------------------------------------------
# the tiers
# ---------------------------------------------------------------------------


class TierDraws(NamedTuple):
    """One step's medium/heavy draws on the images' device: the warp params
    (B, 8), packed for `warp`'s choice at the drawn shape, and photometric
    (fparams, iparams) of each block, views into one uploaded buffer."""
    warp1: torch.Tensor
    photo1: Tuple[torch.Tensor, torch.Tensor]
    warp2: Optional[torch.Tensor]
    photo2: Optional[Tuple[torch.Tensor, torch.Tensor]]


class LightDraws(NamedTuple):
    """One step's light-tier draws on the images' device: the flip gate,
    brightness/contrast (gate, brightness, contrast) and the cutout (gate,
    y0, hh, x0, ww), read from one uploaded buffer."""
    flip: torch.Tensor
    bc: Tuple[torch.Tensor, ...]
    cutout: Tuple[torch.Tensor, ...]


Draws = Union[LightDraws, TierDraws]
Spec = Tuple[Tuple[int, ...], torch.dtype]  # a packed field's shape and dtype


def two_pass_warp(h: int, w: int) -> bool:
    """JAX `_warp`'s rule off the TPU: the two-pass resample for a square
    image with h·w·w ≤ 2^17, the single-pass gather otherwise."""
    return h == w and h * w * w <= 1 << 17


def pack_gather_params(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, 8) float32 [m00, m01, m10, m11, v0, v1, 0, 0], `warp_gather`'s
    layout (the same width as `pack_warp_params`)."""
    b = m.shape[0]
    return torch.cat([m.reshape(b, 4), v, torch.zeros((b, 2))],
                     dim=1).to(torch.float32).contiguous()


def warp_gather(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """One composed inverse map per sample as a single bilinear pass over
    (B, H, W, C) float32 at any shape, zero outside the frame (JAX
    `_warp_gather` and `_bilinear_gather`, augment.py:61-94, 184-202, in
    their float32 expression order): four corner gathers over the
    flattened frame, each zeroed where it lies outside, blended along x,
    then along y. `params` from `pack_gather_params`."""
    b, h, w, c = x.shape
    dev = x.device
    m = params[:, :4].reshape(b, 2, 2, 1, 1)
    v = params[:, 4:6].reshape(b, 2, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src_y = m[:, 0, 0] * yy + m[:, 0, 1] * xx + v[:, 0] + cy
    src_x = m[:, 1, 0] * yy + m[:, 1, 1] * xx + v[:, 1] + cx
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = x.reshape(b, h * w, c)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1))
        got = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(b, h * w, c))
        return torch.where(valid, got.reshape(b, h, w, c), 0.0)

    top = corner(y0, x0) * (1.0 - wx) + corner(y0, x0 + 1) * wx
    bot = corner(y0 + 1, x0) * (1.0 - wx) + corner(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def warp(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The block's warp by `two_pass_warp`: `warp_bilinear` (K4 on a CUDA
    tensor) or `warp_gather`; `params` packed for that choice
    (`_warp_params`)."""
    if two_pass_warp(x.shape[1], x.shape[2]):
        return warp_bilinear(x, params)
    return warp_gather(x, params)


def _warp_params(mv: MV, h: int, w: int) -> torch.Tensor:
    if two_pass_warp(h, w):
        return pack_warp_params(*warp_coefficients(mv[0], mv[1], h, w))
    return pack_gather_params(*mv)


def _padded(n: int) -> int:
    """Elements of a packed field of n: whole 16-byte units, so that every
    field starts where the kernels' vector loads may read it."""
    return -(-n // 4) * 4


def pack_rows(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """Host tensors (float32, int32 or bool) of one leading dimension K →
    (K, S) int32 rows: row k holds each field's k-th entry in turn, float
    fields bit-cast, bools as 0 or 1, each padded to a 16-byte unit
    (`field_views` reads a row back)."""
    parts = []
    for f in fields:
        if f.dtype == torch.bool:
            f = f.to(torch.int32)
        k, n = f.shape[0], math.prod(f.shape[1:])
        flat = f.reshape(k, n)
        flat = flat.view(torch.int32) if flat.is_floating_point() else flat
        pad = _padded(n) - n
        parts += ([flat, torch.zeros((k, pad), dtype=torch.int32)] if pad
                  else [flat])
    return torch.cat(parts, dim=1)


def packed_size(specs: Sequence[Spec]) -> int:
    return sum(_padded(math.prod(shape)) for shape, _ in specs)


def field_views(buf: torch.Tensor, specs: Sequence[Spec]) -> List[torch.Tensor]:
    """The fields of a `pack_rows` row, the flat int32 `buf` (on any
    device), by (shape, dtype): views, and for a bool field its compare
    with 0."""
    out, pos = [], 0
    for shape, dtype in specs:
        n = math.prod(shape)
        view = buf[pos:pos + n]
        if dtype == torch.float32:
            view = view.view(torch.float32)
        view = view.view(shape)
        out.append(view != 0 if dtype == torch.bool else view)
        pos += _padded(n)
    return out


def draw_specs(strength: str, b: int) -> List[Spec]:
    """The packed fields of one step's draws for a batch of b rows."""
    f32, i32, gate = torch.float32, torch.int32, torch.bool
    if strength == "light":
        one = (b, 1, 1, 1)
        return ([(one, gate)] + [(one, gate), (one, f32), (one, f32)]
                + [(one, gate)] + [((b,), i32)] * 4)
    nf, ni = VARIANTS["medium"]
    specs = [((b, WARP_PARAMS), f32), ((b, nf), f32), ((b, ni), i32)]
    if strength == "heavy":
        nf, ni = VARIANTS["heavy_extra"]
        specs += [((b, WARP_PARAMS), f32), ((b, nf), f32), ((b, ni), i32)]
    return specs


def draw_fields(gen: Source, strength: str, b: int, h: int, w: int
                ) -> List[torch.Tensor]:
    """One step's per-sample draws for a batch of b of (h, w) images (or,
    from a `Fields` block, K steps' as b = K·B rows), in the JAX package's
    order, as `draw_specs`' fields. Light: flip, brightness/contrast,
    cutout. Medium and heavy: medium geometry, medium photometric, then
    for heavy the heavy geometry and photometric."""
    if strength == "light":
        return [_bernoulli(gen, 0.5, b), *_bc_draw(gen, b, 0.2, 0.1),
                *_cutout_draw(gen, b, h, w, 0.2, (0.05, 0.051))]
    fields = [_warp_params(draw_medium_geometry(gen, b, h, w), h, w),
              *draw_medium_photometric(gen, b, h, w)]
    if strength == "heavy":
        fields += [_warp_params(draw_heavy_geometry(gen, b, h, w), h, w),
                   *draw_heavy_photometric(gen, b, h, w)]
    return fields


@contextlib.contextmanager
def _one_thread():
    """The enclosed torch CPU ops on the calling thread alone. A chunk's
    draws are hundreds of small ops; the few large enough for a parallel
    region gain less than it costs on a host that launches the device's
    work beside it, its idle workers spinning on after each region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _ranges(strength: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, 1) float32 widths and lows of a tier's F uniform fields in draw
    order (the rot90 choice's [0, 1) among them): `uniform`'s scalar
    operands, rounded to float32 as they are there, so u·width + low over
    a block is each field's `uniform`, bit for bit."""
    rec = _Ranges()
    draw_fields(rec, strength, 1, 2, 2)
    return torch.tensor(rec.width)[:, None], torch.tensor(rec.lo)[:, None]


def _block_fields(u: torch.Tensor, strength: str, h: int, w: int
                  ) -> List[torch.Tensor]:
    """The tier's fields (`draw_fields`) of R rows from an (F, R) block of
    [0, 1) uniforms, field f's R rows in its row f: the block scaled in
    place to each field's range (`_ranges`), then derived on one intra-op
    thread."""
    width, low = _ranges(strength)
    with _one_thread():
        return draw_fields(Fields(u.mul_(width).add_(low)), strength,
                           u.shape[1], h, w)


def draw_chunk(gen: torch.Generator, strength: str, steps: int, b: int,
               h: int, w: int, shard: Shard = WHOLE) -> torch.Tensor:
    """All per-sample draws of `steps` steps of a batch of b of (h, w)
    images, from one `torch.rand` on the host generator, packed
    (`pack_rows`, `draw_specs`) into (steps, S) int32 rows; of a sharded
    batch (b the global batch), only the shard's rows. Row k equals step
    k's draws made one call a field (`draw_fields` on `gen`), and `gen`
    ends where those calls leave it."""
    if strength not in STRENGTHS:
        raise ValueError(f"strength must be one of {STRENGTHS}")
    n = len(_ranges(strength)[0])
    DRAWS["host_draw_calls"] += 1
    with _one_thread():
        u = torch.rand((steps, n, b), generator=gen)
        fields = _block_fields(u.transpose(0, 1).reshape(n, steps * b),
                               strength, h, w)
        rows = shard_rows(b, shard)
        return pack_rows([f.reshape(steps, b, *f.shape[1:])[:, rows]
                          for f in fields])


def draw_batch(gen: torch.Generator, strength: str, b: int, h: int, w: int,
               shard: Shard = WHOLE) -> torch.Tensor:
    """One step's draws packed into one flat int32 tensor: `draw_chunk`
    of one step."""
    return draw_chunk(gen, strength, 1, b, h, w, shard)[0]


def batch_draws(buf: torch.Tensor, strength: str, b: int) -> Draws:
    """One step's draws for b rows, read from `buf` (`draw_batch`'s packing)
    on the images' device: no copy, so a CUDA graph can read them from a
    buffer it was captured on."""
    v = field_views(buf, draw_specs(strength, b))
    if strength == "light":
        return LightDraws(v[0], tuple(v[1:4]), tuple(v[4:9]))
    if strength == "heavy":
        return TierDraws(v[0], (v[1], v[2]), v[3], (v[4], v[5]))
    return TierDraws(v[0], (v[1], v[2]), None, None)


def draw_tier(gen: torch.Generator, strength: str, b: int, h: int, w: int,
              device, shard: Shard = WHOLE) -> Draws:
    """`draw_batch` uploaded once to `device` and read by `batch_draws`."""
    buf = draw_batch(gen, strength, b, h, w, shard).to(device)
    return batch_draws(buf, strength, b // shard[1])


def _noise(x: torch.Tensor, noise_gen: torch.Generator,
           shard: Shard = WHOLE) -> torch.Tensor:
    """Unit-normal noise of x's shape, drawn for the global batch of x's
    shard (a copy of the shard's rows: aligned for the kernel)."""
    count = shard[1]
    noise = torch.randn((x.shape[0] * count,) + tuple(x.shape[1:]),
                        generator=noise_gen, device=x.device,
                        dtype=torch.float32)
    return noise if count == 1 else noise[shard_rows(len(noise), shard)].clone()


def apply_tier(x: torch.Tensor, draws: TierDraws,
               noise_gen: torch.Generator, shard: Shard = WHOLE
               ) -> torch.Tensor:
    """Warp (K4, or the gather) → medium photometric block (K5), then for
    heavy a second warp → heavy_extra block, with the two noise tensors
    drawn from `noise_gen` on x's device."""
    x = warp(x, draws.warp1)
    x = photometric_block(x, _noise(x, noise_gen, shard), *draws.photo1,
                          variant="medium")
    if draws.warp2 is not None:
        x = warp(x, draws.warp2)
        x = photometric_block(x, _noise(x, noise_gen, shard), *draws.photo2,
                              variant="heavy_extra")
    return x


def apply_light(x: torch.Tensor, draws: LightDraws) -> torch.Tensor:
    """hflip → brightness/contrast → cutout, each where its gate is on."""
    x = torch.where(draws.flip, x.flip(2), x)
    x = apply_brightness_contrast(x, *draws.bc)
    return apply_cutout(x, *draws.cutout)


def apply_draws(x: torch.Tensor, draws: Draws,
                noise_gen: Optional[torch.Generator],
                shard: Shard = WHOLE) -> torch.Tensor:
    """The tier of `draws` on a float [0,1] NHWC batch: `apply_light`, or
    `apply_tier` on the batch as float32."""
    if isinstance(draws, LightDraws):
        return apply_light(x, draws)
    return apply_tier(x.to(torch.float32), draws, noise_gen, shard)


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  strength: str = "medium",
                  noise_gen: Optional[torch.Generator] = None,
                  shard: Shard = WHOLE) -> torch.Tensor:
    """One augmentation tier on a float [0,1] NHWC batch (shard `shard` of
    a global batch). The medium and heavy tiers draw their noise from
    `noise_gen`, a generator on the images' device (default: one made from
    `gen` for this call)."""
    b, h, w, _ = images.shape
    draws = draw_tier(gen, strength, b * shard[1], h, w, images.device, shard)
    if strength != "light" and noise_gen is None:
        noise_gen = device_generator(gen, images.device)
    return apply_draws(images, draws, noise_gen, shard)


def preprocess_batch(gen: torch.Generator, images: torch.Tensor,
                     strength: str = "medium", augment: bool = True,
                     noise_gen: Optional[torch.Generator] = None,
                     shard: Shard = WHOLE) -> torch.Tensor:
    """augment (train only) → normalize, the device-side entry point of the
    train and eval loops."""
    x = (augment_batch(gen, images, strength, noise_gen, shard) if augment
         else images)
    return normalize_images(x)
