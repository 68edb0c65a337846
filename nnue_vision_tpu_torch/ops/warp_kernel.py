"""The composed-geometry bilinear warp of the medium and heavy augmentation
tiers as one Hopper kernel per batch (K4).

Port of `nnue_vision_tpu/ops/warp_kernel.py:46-195`. A per-sample inverse
map src = M·dst_c + v (centered pixel coordinates) is factored on the host
by `warp_coefficients` into an optional axis swap and two linear resample
passes (Catmull–Smith): pass 1 along x, pass 2 along y on the transposed
intermediate. The TPU ran each pass as a `lerp_pass` kernel with XLA
transposes around them; `warp_kernel` (`csrc/warp.cu`) runs the swap, both
passes and the transpose for one image in shared memory, in one launch,
bit for bit equal to `warp_bilinear_reference`, the two passes in eager
torch.

The parameters travel as one (B, 8) float32 tensor per warp,
`[swap, k1_row, k1_lane, k1_c, k2_row, k2_lane, k2_c, 0]`
(`pack_warp_params`), so a step uploads them with the rest of its draws.
Square images only: the swap is a transpose, undefined otherwise (the JAX
package takes its gather path there; no shipped config is non-square).

`lerp_pass` is one pass alone, the TPU kernel at its own granularity, and
`nogather_pass` the same pass with its two reads at the computed positions
replaced by the output's own value (the probe
`scripts/profile_warp_split.py` `_nogather_pass`): the gap between the two
is the gather's price, which `nnue_vision_tpu_torch.profile_warp_split`
measures. Both are `lerp_pass_kernel` in `csrc/warp.cu`, on the index
arithmetic `warp_kernel` runs.

`warp_bilinear`, `lerp_pass` and `nogather_pass` dispatch on the device of
their input: a CPU tensor takes the plain version, a CUDA tensor the
kernel, which launches or raises. The kernels are persistent grids that
walk images (or tiles of packed rows) through one shared-memory slot per
block, fed by bulk copies; `ops/_ring.py` sizes the grid and launches.
They take three channels and 16-byte units: an even n for the warp,
n % 4 == 0 for a single pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nnue_vision_tpu_torch.ops import _ring

# Launches since the last reset_launch_counts(); the wrapper adds one where
# it launches the kernel, and nowhere else.
LAUNCHES = {"warp_kernel": 0, "lerp_pass_kernel": 0,
            "nogather_pass_kernel": 0}
PARAMS = 8
_F32 = torch.float32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def warp_coefficients(m: torch.Tensor, v: torch.Tensor, h: int, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor per-sample inverse maps m (B, 2, 2), v (B, 2) float32 into
    (swap (B,) bool, coef1 (B, 3), coef2 (B, 3)) with the JAX package's
    float32 expressions (warp_kernel.py:125-163): the axis swap where the
    off-diagonal mass dominates, then pass 1 q = coef1·[yi, xo, 1] (along
    x, extent W) and pass 2 p = coef2·[xo, yo, 1] (along y, extent H)."""
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
    coef1 = torch.stack([r, q_lane, q_c], dim=-1).to(torch.float32)
    coef2 = torch.stack([bb, a, p_c], dim=-1).to(torch.float32)
    return swap, coef1, coef2


def pack_warp_params(swap: torch.Tensor, coef1: torch.Tensor,
                     coef2: torch.Tensor) -> torch.Tensor:
    """(B, 8) float32 [swap, coef1, coef2, 0], the kernel's layout."""
    zero = torch.zeros_like(coef1[:, :1])
    return torch.cat([swap.to(torch.float32)[:, None], coef1, coef2, zero],
                     dim=1).contiguous()


def _taps(x: torch.Tensor, coef: torch.Tensor, n: int, c: int):
    """Per output value of x (B, R, N·C): the lower tap i0, the fraction fr
    and the lane's channel, at pos = k_row·r + k_lane·x + k_c."""
    _, r_dim, lanes = x.shape
    dev = x.device
    rows = torch.arange(r_dim, device=dev, dtype=torch.float32)[None, :, None]
    lane = torch.arange(lanes, device=dev)
    xcoord = torch.div(lane, c, rounding_mode="floor").to(torch.float32)
    ch = (lane % c)[None, None, :]
    pos = (coef[:, 0, None, None] * rows + coef[:, 1, None, None] * xcoord
           + coef[:, 2, None, None])
    i0f = torch.floor(pos)
    return i0f.to(torch.int64), pos - i0f, ch


def _blend(i0, fr, v0, v1, n: int) -> torch.Tensor:
    """v0·(1 − fr) + v1·fr, a tap outside [0, n) reading 0."""
    i1 = i0 + 1
    v0 = torch.where((i0 >= 0) & (i0 < n), v0, 0.0)
    v1 = torch.where((i1 >= 0) & (i1 < n), v1, 0.0)
    return v0 * (1.0 - fr) + v1 * fr


def lerp_pass_reference(x: torch.Tensor, coef: torch.Tensor, *, n: int,
                        c: int) -> torch.Tensor:
    """The TPU's `lerp_pass` in eager torch: x (B, R, N·C), coef (B, 3)
    [k_row, k_lane, k_c]; lane l = x·C + ch reads row positions
    pos = k_row·r + k_lane·x + k_c, zero outside [0, n)."""
    i0, fr, ch = _taps(x, coef, n, c)
    g0 = torch.clamp(i0, 0, n - 1) * c + ch
    g1 = torch.clamp(i0 + 1, 0, n - 1) * c + ch
    return _blend(i0, fr, torch.gather(x, 2, g0), torch.gather(x, 2, g1), n)


def nogather_pass_reference(x: torch.Tensor, coef: torch.Tensor, *, n: int,
                            c: int) -> torch.Tensor:
    """`lerp_pass_reference` with the output's own value read in place of
    both taps: where(valid0, x, 0)·(1 − fr) + where(valid1, x, 0)·fr
    (`scripts/profile_warp_split.py` `_nogather_kernel`)."""
    i0, fr, _ = _taps(x, coef, n, c)
    return _blend(i0, fr, x, x, n)


def _check(x: torch.Tensor, params: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"the warp takes square (B, H, W, C) images; got "
                         f"{tuple(x.shape)}")
    if params.shape != (x.shape[0], PARAMS):
        raise ValueError(f"params must be (B, {PARAMS}); got "
                         f"{tuple(params.shape)}")


def warp_bilinear_reference(x: torch.Tensor, params: torch.Tensor
                            ) -> torch.Tensor:
    """What warp_kernel computes, in plain torch: swap blend, pass 1 along
    x, transpose, pass 2 along y, transpose back. (B, H, W, C) float32."""
    _check(x, params)
    b, h, w, c = x.shape
    swap = params[:, 0] > 0.5
    xs = torch.where(swap[:, None, None, None], x.transpose(1, 2), x)
    tmp = lerp_pass_reference(xs.reshape(b, h, w * c), params[:, 1:4], n=w,
                              c=c)
    tmp_t = tmp.reshape(b, h, w, c).transpose(1, 2).reshape(b, w, h * c)
    out_t = lerp_pass_reference(tmp_t, params[:, 4:7], n=h, c=c)
    return out_t.reshape(b, w, h, c).transpose(1, 2).contiguous()


def _refuse(kernel: str, x: torch.Tensor, other: torch.Tensor) -> None:
    """The reason a launcher's inputs are refused (only called when they
    are)."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} runs on CUDA tensors only (got {x.device}); "
                         "CPU tensors take the plain version")
    raise ValueError(f"{kernel} takes float32 tensors on one device; got "
                     f"{x.dtype} on {x.device} and {other.dtype} on {other.device}")


def _launch(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    # the checks, cheapest first, in one pass; each launch's host cost is
    # what a host-bound train step pays (PERF.md)
    if not (x.is_cuda and x.dtype is _F32 and params.dtype is _F32
            and params.device == x.device):
        _refuse("warp_kernel", x, params)
    b, n, _, c = x.shape
    if c != 3 or n % 2:
        raise ValueError(f"warp_kernel takes (B, n, n, 3) images with n even "
                         f"(whole 16-byte units); got {tuple(x.shape)}")
    out = torch.empty_like(x)
    if b == 0:
        return out
    xp, op = x.data_ptr(), out.data_ptr()
    if (xp | op) & 15:
        raise ValueError("warp_kernel: x must start at a 16-byte boundary")
    dev = x.device
    grid = _ring.grid(dev, b, "warp_blocks_per_sm", n)
    _ring.launch(dev, "warp_kernel", "warp_launch",
                 (xp, b, n, c, params.data_ptr(), grid, op))
    LAUNCHES["warp_kernel"] += 1
    return out


def _pass_launch(x: torch.Tensor, coef: torch.Tensor, n: int, c: int,
                 gather: bool) -> torch.Tensor:
    kernel = "lerp_pass_kernel" if gather else "nogather_pass_kernel"
    if not (x.is_cuda and x.dtype is _F32 and coef.dtype is _F32
            and coef.device == x.device):
        _refuse(kernel, x, coef)
    if c != 3 or n % 4:
        raise ValueError(f"{kernel} takes rows of n pixels of 3 channels with "
                         f"n % 4 == 0 (whole 16-byte units); got n={n}, c={c}")
    out = torch.empty_like(x)
    b, rows, _ = x.shape
    if b == 0 or rows == 0:
        return out
    xp, op = x.data_ptr(), out.data_ptr()
    if (xp | op) & 15:
        raise ValueError(f"{kernel}: x must start at a 16-byte boundary")
    dev = x.device
    tile_rows = _ring.pass_tile_rows(n)
    grid = _ring.grid(dev, -(-(b * rows) // tile_rows),
                      "lerp_pass_blocks_per_sm", n, tile_rows, int(gather))
    _ring.launch(dev, kernel, "lerp_pass_launch",
                 (xp, b, rows, n, c, coef.data_ptr(), int(gather), tile_rows,
                  grid, op))
    LAUNCHES[kernel] += 1
    return out


def _check_pass(x: torch.Tensor, coef: torch.Tensor, n: int, c: int) -> None:
    if x.dim() != 3 or x.shape[2] != n * c:
        raise ValueError(f"x must be (B, R, {n}·{c}); got {tuple(x.shape)}")
    if coef.shape != (x.shape[0], 3):
        raise ValueError(f"coef must be (B, 3); got {tuple(coef.shape)}")


def lerp_pass(x: torch.Tensor, coef: torch.Tensor, *, n: int, c: int
              ) -> torch.Tensor:
    """One linear resample pass: x (B, R, N·C) float32, coef (B, 3)."""
    _check_pass(x, coef, n, c)
    if x.device.type == "cpu":
        return lerp_pass_reference(x, coef, n=n, c=c)
    return _pass_launch(x.contiguous(), coef.contiguous(), n, c, gather=True)


def nogather_pass(x: torch.Tensor, coef: torch.Tensor, *, n: int, c: int
                  ) -> torch.Tensor:
    """`lerp_pass` with identity reads in place of the gather (the probe's
    control): x (B, R, N·C) float32, coef (B, 3)."""
    _check_pass(x, coef, n, c)
    if x.device.type == "cpu":
        return nogather_pass_reference(x, coef, n=n, c=c)
    return _pass_launch(x.contiguous(), coef.contiguous(), n, c, gather=False)


def warp_bilinear(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Per-sample affine warp of a square batch: x (B, H, W, C) float32,
    params (B, 8) from `pack_warp_params`."""
    if x.device.type == "cpu":
        return warp_bilinear_reference(x, params)
    _check(x, params)
    return _launch(x.contiguous(), params.contiguous())
