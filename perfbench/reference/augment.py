"""The plain augmentation tiers of the train cells: their host draws, in the
order a trainer makes them from a seeded CPU generator, and what they do
to a batch, in eager torch.

Part of the benchmark's yardstick: it imports nothing of the program. It
follows the JAX package's tiers (`data/augment.py`), each a pair of
functions found by the tier's name: `draw_<tier>(gen, b, h, w)`, one
step's host draws, and `apply_<tier>(x, draws, noise_gen)`, the step's
augmentation of a gathered batch on x's device:

* `none`: no draws, the batch as it is;
* `light`: hflip (p .5), brightness/contrast ±0.1 (p .2), one 5% cutout
  (p .2);
* `medium`: one block, a composed geometry (hflip, rot90, rotate, affine)
  realized as one bilinear warp, then a gated photometric chain
  (brightness/contrast, HSV, 3×3 blur, noise, cutout, HSV, shadow, fog,
  posterize, equalize);
* `heavy`: the medium block, then a second block of a wider geometry and
  a shorter chain (brightness/contrast, HSV, blur, noise, two cutouts).

The warp follows JAX `_warp`'s size rule off the TPU (`data/augment.py`
:408, :418; `two_pass`): a square image with h·w·w ≤ 2^17 (32×32 up to
50×50) is resampled in two linear passes, a block carrying the passes'
coefficients; any other size (64×64, 224×224, a non-square image) by a
single bilinear gather of four corner taps (JAX `_warp_gather` and
`_bilinear_gather`, :61-94, :184-202), a block carrying the composed
inverse map (m, v). The draws are the same at every size.

The fused light path draws a whole chunk at once (`draw_light_chunk`) and
folds brightness/contrast to x·α + β (`apply_light_fused`). `NOISE_DRAWS`
counts the unit-normal tensors a step of each tier draws on the device.
Every batch ends with the ImageNet normalize.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.nn import functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NOISE_DRAWS = {"none": 0, "light": 0, "medium": 1, "heavy": 2}


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def noise_generator(gen: torch.Generator, device) -> torch.Generator:
    """The device generator of the heavy tier's noise, seeded by one draw
    from the host generator."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# light tier
# ---------------------------------------------------------------------------


def draw_light_chunk(gen: torch.Generator, steps: int, batch: int, h: int,
                     w: int) -> Dict[str, torch.Tensor]:
    """The fused path's light-tier draws of `steps` steps of `batch` rows,
    leading shape (steps, batch): flip, alpha, beta, and the hole [y0, y1,
    x0, x1]."""
    shape = (steps, batch)
    flip = uniform(gen, shape) < 0.5
    bc_apply = uniform(gen, shape) < 0.2
    bright = uniform(gen, shape, -0.1, 0.1)
    contr = 1.0 + uniform(gen, shape, -0.1, 0.1)
    alpha = torch.where(bc_apply, contr, 1.0)
    beta = torch.where(bc_apply, 0.5 - 0.5 * contr + bright, 0.0)
    cut_apply = uniform(gen, shape) < 0.2
    frac = uniform(gen, shape, 0.05, 0.051)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (uniform(gen, shape) * (h - hh)).to(torch.int32)
    x0 = (uniform(gen, shape) * (w - ww)).to(torch.int32)
    zero = torch.zeros_like(y0)
    hole = torch.stack([torch.where(cut_apply, y0, zero),
                        torch.where(cut_apply, y0 + hh, zero),
                        torch.where(cut_apply, x0, zero),
                        torch.where(cut_apply, x0 + ww, zero)], dim=-1)
    return {"flip": flip, "alpha": alpha.float(), "beta": beta.float(),
            "hole": hole}


def apply_light_fused(x: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step of the fused light tier on a gathered (B, H, W, 3) batch,
    `d` the step's slice of `draw_light_chunk` on x's device: flip,
    clip(x·α + β, 0, 1), the hole."""
    x = torch.where(d["flip"][:, None, None, None], x.flip(2), x)
    x = torch.clamp(x * d["alpha"][:, None, None, None]
                    + d["beta"][:, None, None, None], 0.0, 1.0)
    h, w = x.shape[1], x.shape[2]
    yy = torch.arange(h, device=x.device)[None, :, None, None]
    xx = torch.arange(w, device=x.device)[None, None, :, None]
    p = d["hole"][:, :, None, None, None].unbind(1)
    hole = (yy >= p[0]) & (yy < p[1]) & (xx >= p[2]) & (xx < p[3])
    return torch.where(hole, 0.0, x)


# ---------------------------------------------------------------------------
# the per-step tiers: draws
# ---------------------------------------------------------------------------


def _bern(gen, p, b):
    return uniform(gen, (b, 1, 1, 1)) < p


def _bc(gen, b, p, lim):
    return [_bern(gen, p, b), uniform(gen, (b, 1, 1, 1), -lim, lim),
            1.0 + uniform(gen, (b, 1, 1, 1), -lim, lim)]


def _hsv(gen, b, p, hue, sat, val):
    return [_bern(gen, p, b), uniform(gen, (b, 1, 1, 1), -hue, hue),
            1.0 + uniform(gen, (b, 1, 1, 1), -sat, sat),
            1.0 + uniform(gen, (b, 1, 1, 1), -val, val)]


def _noise_gate(gen, b, p, lo, hi):
    return [_bern(gen, p, b), uniform(gen, (b, 1, 1, 1), lo, hi)]


def _cutout(gen, b, h, w, p, lo, hi):
    apply = _bern(gen, p, b)
    frac = uniform(gen, (b,), lo, hi)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (uniform(gen, (b,)) * (h - hh)).to(torch.int32)
    x0 = (uniform(gen, (b,)) * (w - ww)).to(torch.int32)
    return apply, [y0, hh, x0, ww]


def _cols(values) -> torch.Tensor:
    return torch.stack([v.reshape(v.shape[0]).to(torch.float32)
                        for v in values], dim=1)


def _medium_photometric(gen, b, h, w):
    f = _bc(gen, b, 0.3, 0.2)
    f += _hsv(gen, b, 0.3, 10 / 255.0, 0.15, 10 / 255.0)
    f += [_bern(gen, 0.2, b)]
    f += _noise_gate(gen, b, 0.2, 0.01, 0.05)
    cut, rect = _cutout(gen, b, h, w, 0.3, 0.05, 0.15)
    f += [cut]
    f += _hsv(gen, b, 0.2, 8 / 255.0, 0.1, 8 / 255.0)
    sh = _bern(gen, 0.1, b)
    theta = uniform(gen, (b, 1, 1), 0.0, 2 * math.pi)
    offset = uniform(gen, (b, 1, 1), -0.3, 0.3)
    dark = uniform(gen, (b, 1, 1, 1), 0.4, 0.7)
    f += [sh, torch.cos(theta), torch.sin(theta), offset, dark]
    f += [_bern(gen, 0.1, b), uniform(gen, (b, 1, 1, 1), 0.1, 0.4)]
    f += [_bern(gen, 0.1, b), _bern(gen, 0.1, b)]
    return _cols(f), torch.stack(rect, dim=1).to(torch.int32)


def _heavy_photometric(gen, b, h, w):
    f = _bc(gen, b, 0.2, 0.3)
    f += _hsv(gen, b, 0.2, 15 / 255.0, 0.2, 15 / 255.0)
    f += [_bern(gen, 0.2, b)]
    f += _noise_gate(gen, b, 0.2, 0.05, 0.1)
    c1, r1 = _cutout(gen, b, h, w, 0.2, 0.1, 0.25)
    c2, r2 = _cutout(gen, b, h, w, 0.2, 0.1, 0.25)
    f += [c1, c2]
    return _cols(f), torch.stack(r1 + r2, dim=1).to(torch.int32)


def _identity(b):
    return torch.eye(2).repeat(b, 1, 1), torch.zeros((b, 2))


def _compose(prev, new):
    m1, v1 = prev
    m2, v2 = new
    return m1 @ m2, (m1 @ v2[:, :, None])[:, :, 0] + v1


def _gate(apply, mv):
    m, v = mv
    mi, vi = _identity(m.shape[0])
    a = apply.reshape(-1, 1, 1)
    return torch.where(a, m, mi), torch.where(a[:, :, 0], v, vi)


_ROT90 = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[0.0, 1.0], [-1.0, 0.0]],
                       [[-1.0, 0.0], [0.0, -1.0]], [[0.0, -1.0], [1.0, 0.0]]])


def _affine(gen, b, p, max_deg, max_tr, lo, hi, h, w):
    apply = uniform(gen, (b,)) < p
    deg = uniform(gen, (b,), -max_deg, max_deg)
    tx = uniform(gen, (b,), -max_tr, max_tr) * w
    ty = uniform(gen, (b,), -max_tr, max_tr) * h
    sc = uniform(gen, (b,), lo, hi)
    theta = deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta) / sc, torch.sin(theta) / sc
    m = torch.stack([torch.stack([cos, sin], -1),
                     torch.stack([-sin, cos], -1)], dim=1)
    t = torch.stack([ty, tx], dim=-1)
    return _gate(apply, (m, -(m @ t[:, :, None])[:, :, 0]))


def _geometry(gen, b, h, w, p_flip, p_rot, p_a, deg, tr, lo, hi):
    flip = uniform(gen, (b,)) < p_flip
    mflip = torch.tensor([[1.0, 0.0], [0.0, -1.0]]).repeat(b, 1, 1)
    mv = _gate(flip, (mflip, torch.zeros((b, 2))))
    rot = uniform(gen, (b,)) < p_rot
    choice = torch.randint(0, 4, (b,), generator=gen)
    mv = _compose(mv, _gate(rot, (_ROT90[choice], torch.zeros((b, 2)))))
    mv = _compose(mv, _affine(gen, b, p_a, deg, 0.0, 1.0, 1.0001, h, w))
    return _compose(mv, _affine(gen, b, p_a, deg, tr, lo, hi, h, w))


def _warp_coefficients(m, v, h, w) -> torch.Tensor:
    """The inverse map factored into an axis swap and two linear resample
    passes: (B, 7) float32 [swap, coef1 (3), coef2 (3)]."""
    swap = (m[:, 0, 0].abs() + m[:, 1, 1].abs()) < (
        m[:, 0, 1].abs() + m[:, 1, 0].abs())
    ms = torch.where(swap[:, None, None], m.flip(1), m)
    vs = torch.where(swap[:, None], v.flip(1), v)
    a, bb, cc, d = ms[:, 0, 0], ms[:, 0, 1], ms[:, 1, 0], ms[:, 1, 1]
    e, f = vs[:, 0], vs[:, 1]
    a = torch.where(a.abs() < 1e-3,
                    torch.where(a < 0, -1e-3, 1e-3).to(a.dtype), a)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = cc / a
    q_lane = d - r * bb
    q_c = (f - r * e) + cx - r * cy - q_lane * cx
    p_c = e + cy - a * cy - bb * cx
    return torch.cat([swap.to(torch.float32)[:, None],
                      torch.stack([r, q_lane, q_c], dim=-1),
                      torch.stack([bb, a, p_c], dim=-1)], dim=1).float()


def two_pass(h: int, w: int) -> bool:
    """JAX `_warp`'s choice off the TPU (`data/augment.py`:408, :418): the
    two-pass resample for a square image with h·w·w ≤ 2^17, the
    single-pass gather otherwise."""
    return h == w and h * w * w <= 1 << 17


def _warp_params(mv, h: int, w: int):
    """What a block carries for its warp: the two passes' coefficients
    within `two_pass`'s rule, the inverse map (m, v) past it."""
    return _warp_coefficients(*mv, h, w) if two_pass(h, w) else mv


def draw_medium(gen: torch.Generator, b: int, h: int, w: int) -> List[tuple]:
    """One step's medium-tier draws: one block of (warp params, photometric
    float params, photometric int params), the warp's as `_warp_params`."""
    warp1 = _warp_params(_geometry(gen, b, h, w, 0.5, 0.5, 0.3, 15.0,
                                   0.1, 0.9, 1.1), h, w)
    f1, i1 = _medium_photometric(gen, b, h, w)
    return [(warp1, f1, i1)]


def draw_heavy(gen: torch.Generator, b: int, h: int, w: int) -> List[tuple]:
    """One step's heavy-tier draws: the medium block's, then the second
    block's."""
    blocks = draw_medium(gen, b, h, w)
    warp2 = _warp_params(_geometry(gen, b, h, w, 0.1, 0.1, 0.2, 25.0,
                                   0.15, 0.85, 1.15), h, w)
    f2, i2 = _heavy_photometric(gen, b, h, w)
    return blocks + [(warp2, f2, i2)]


def draw_light(gen: torch.Generator, b: int, h: int, w: int
               ) -> List[torch.Tensor]:
    """One step's light-tier draws of the general chunk, gates and values
    of shape (b, 1, 1, 1): flip; brightness/contrast's gate, brightness
    and contrast; the cutout's gate and its rectangle y0, hh, x0, ww (b,)."""
    flip = _bern(gen, 0.5, b)
    bc = _bc(gen, b, 0.2, 0.1)
    cut, rect = _cutout(gen, b, h, w, 0.2, 0.05, 0.051)
    return [flip] + bc + [cut] + rect


def draw_none(gen: torch.Generator, b: int, h: int, w: int) -> None:
    """No augmentation draws nothing."""
    return None


def apply_none(x: torch.Tensor, draws, noise_gen) -> torch.Tensor:
    return x


def apply_light(x: torch.Tensor, draws, noise_gen=None) -> torch.Tensor:
    """One step's light tier of the general chunk: the flip, then the
    brightness/contrast and the cutout, each where its gate is on."""
    flip, bc_on, bright, contr, cut_on, y0, hh, x0, ww = draws
    x = torch.where(flip, x.flip(2), x)
    x = _bc_apply(x, bc_on, bright, contr)
    return _cut_apply(x, cut_on, y0, hh, x0, ww)


# ---------------------------------------------------------------------------
# the medium and heavy tiers: apply
# ---------------------------------------------------------------------------


def _lerp_pass(x: torch.Tensor, coef: torch.Tensor, n: int, c: int):
    """Along the lanes of x (B, R, N·C): lane x·C + ch reads the row at
    position k_row·r + k_lane·x + k_c, linear between its two taps, zero
    outside [0, n)."""
    _, rows, lanes = x.shape
    dev = x.device
    r = torch.arange(rows, device=dev, dtype=torch.float32)[None, :, None]
    lane = torch.arange(lanes, device=dev)
    xc = torch.div(lane, c, rounding_mode="floor").to(torch.float32)
    ch = (lane % c)[None, None, :]
    pos = coef[:, 0, None, None] * r + coef[:, 1, None, None] * xc \
        + coef[:, 2, None, None]
    i0f = torch.floor(pos)
    i0, fr = i0f.to(torch.int64), pos - i0f
    v0 = torch.gather(x, 2, torch.clamp(i0, 0, n - 1) * c + ch)
    v1 = torch.gather(x, 2, torch.clamp(i0 + 1, 0, n - 1) * c + ch)
    v0 = torch.where((i0 >= 0) & (i0 < n), v0, 0.0)
    v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < n), v1, 0.0)
    return v0 * (1.0 - fr) + v1 * fr


def _two_pass_warp(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The two-pass bilinear warp of square (B, H, W, C) images, `p` the
    (B, 7) coefficients of `_warp_coefficients`."""
    b, h, w, c = x.shape
    swap = p[:, 0] > 0.5
    xs = torch.where(swap[:, None, None, None], x.transpose(1, 2), x)
    tmp = _lerp_pass(xs.reshape(b, h, w * c), p[:, 1:4], w, c)
    tmp_t = tmp.reshape(b, h, w, c).transpose(1, 2).reshape(b, w, h * c)
    out = _lerp_pass(tmp_t, p[:, 4:7], h, c)
    return out.reshape(b, w, h, c).transpose(1, 2).contiguous()


def _gather_warp(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """The single-pass bilinear warp of (B, H, W, C) images of any shape by
    the inverse map src = m·(dst − centre) + v + centre, in float32: four
    corner taps, each zero outside the frame, blended along x, then along
    y (JAX `_warp_gather`, `_bilinear_gather`)."""
    b, h, w, c = x.shape
    dev = x.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx

    def row(i):
        return (m[:, i, 0, None, None] * yy + m[:, i, 1, None, None] * xx
                + v[:, i, None, None])
    src_y, src_x = row(0) + cy, row(1) + cx
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = x.reshape(b, h * w, c)

    def tap(yi, xi):
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        got = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c))
        return torch.where(inside, got.reshape(b, h, w, c), 0.0)

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def warp(x: torch.Tensor, p) -> torch.Tensor:
    """One block's warp of (B, H, W, C) images by `two_pass`: the two
    passes for `p` the coefficients, the gather for `p` the map (m, v)."""
    if two_pass(x.shape[1], x.shape[2]):
        return _two_pass_warp(x, p)
    return _gather_warp(x, *p)


def _const(x, value):
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _bc_apply(x, g, bright, contr):
    return torch.where(g, torch.clamp((x - 0.5) * contr + 0.5 + bright, 0, 1), x)


def _hsv_apply(x, g, hue, sat, val):
    luma = x[..., :1] * 0.299 + x[..., 1:2] * 0.587 + x[..., 2:3] * 0.114
    shifted = torch.cat([x[..., :1] + hue, x[..., 1:2], x[..., 2:3] - hue], -1)
    return torch.where(g, torch.clamp((luma + (shifted - luma) * sat) * val,
                                      0.0, 1.0), x)


def _blur_apply(x, g):
    xp = F.pad(x, (0, 0, 1, 1))
    t = (xp[:, :, :-2] + 2.0 * x) + xp[:, :, 2:]
    tp = F.pad(t, (0, 0, 0, 0, 1, 1))
    return torch.where(g, ((tp[:, :-2] + 2.0 * t) + tp[:, 2:]) * 0.0625, x)


def _cut_apply(x, g, y0, hh, x0, ww):
    _, h, w, _ = x.shape
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    hole = ((yy >= y0[:, None, None]) & (yy < (y0 + hh)[:, None, None])
            & (xx >= x0[:, None, None]) & (xx < (x0 + ww)[:, None, None]))
    return torch.where(g & hole[..., None], 0.0, x)


def photometric(x, noise, fp, ip, medium: bool) -> torch.Tensor:
    """One block's gated photometric chain; fp, ip the block's params."""
    b, h, w, _ = x.shape

    def P(i):
        return fp[:, i].reshape(b, 1, 1, 1)

    def G(i):
        return P(i) > 0.5

    x = _bc_apply(x, G(0), P(1), P(2))
    x = _hsv_apply(x, G(3), P(4), P(5), P(6))
    x = _blur_apply(x, G(7))
    x = torch.where(G(8), torch.clamp(x + noise * P(9), 0.0, 1.0), x)
    x = _cut_apply(x, G(10), *ip[:, 0:4].unbind(1))
    if not medium:
        return _cut_apply(x, G(11), *ip[:, 4:8].unbind(1))
    x = _hsv_apply(x, G(11), P(12), P(13), P(14))
    yn = (torch.arange(h, device=x.device, dtype=torch.float32)
          / _const(x, h) - 0.5)[None, :, None, None]
    xn = (torch.arange(w, device=x.device, dtype=torch.float32)
          / _const(x, w) - 0.5)[None, None, :, None]
    side = (P(16) * xn + P(17) * yn) > P(18)
    x = torch.where(G(15) & side, x * P(19), x)
    x = torch.where(G(20), x * (1.0 - P(21)) + P(21), x)
    fifteen = _const(x, 15.0)
    x = torch.where(G(22), torch.round(x * fifteen) / fifteen, x)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(G(23), (x - lo) / torch.clamp_min(hi - lo, 1e-6), x)


def apply_heavy(x: torch.Tensor, blocks, noise_gen: torch.Generator
                ) -> torch.Tensor:
    """The tier's blocks on a gathered batch, as float32: each block warps,
    draws one unit-normal tensor of the batch's shape from `noise_gen`,
    and runs its photometric chain (the first block's the medium one).
    `blocks` is `draw_heavy`'s or `draw_medium`'s, on x's device."""
    x = x.float()
    for k, (wp, fp, ip) in enumerate(blocks):
        x = warp(x, wp)
        noise = torch.randn(x.shape, generator=noise_gen, device=x.device,
                            dtype=torch.float32)
        x = photometric(x, noise, fp, ip, medium=k == 0)
    return x


apply_medium = apply_heavy
