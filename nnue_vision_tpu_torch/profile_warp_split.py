"""Split the warp's time into its parts, and price the gather.

    python -m nnue_vision_tpu_torch.profile_warp_split [--batch 1024]
        [--device cuda]
    WARP_SPLIT_REPS=50 WARP_SPLIT_ONLY=pass python -m ...   # as the JAX probe

Port of `scripts/profile_warp_split.py`, at the heavy tier's training shape
(1024×32×32×3, numpy seed 11). The maps are the JAX probe's: hflip (.5),
rot90 (.5), rotate ±15° (.3), affine ±15°, ±10%, 0.9–1.1 (.3), composed
with the port's `geom_hflip`, `geom_rot90` and `geom_affine` draws (that is
`draw_medium_geometry`, torch generator seed 5) and factored by
`warp_coefficients`. Variants:

  transpose    the H↔W transpose of the batch alone            [torch]
  swap_blend   the per-image axis-swap blend alone             [torch]
  lerp_pass    one resample pass, `lerp_pass`                  [kernel]
  nogather     the same pass reading its own value in place of
               the two taps, `nogather_pass`                   [kernel]
  two_passes   two passes, no transposes                       [kernels]
  five_stages  the TPU's composition: swap blend, pass,
               transpose, pass, transpose                      [both]
  warp_kernel  the shipped one-launch `warp_bilinear`          [kernel]

The gather's price on the card is lerp_pass − nogather (`gather_ms`).
Each variant is timed by `ops/timing.py` (a CUDA graph of
`WARP_SPLIT_REPS` calls, default 400, best of 3 replays); `WARP_SPLIT_ONLY`
keeps the variants whose name holds it. The batch's 12.6 MB stays in the
card's L2 from one rep to the next. Prints one JSON object with ms per
variant, the bound every variant shares (`bound_ms`: the batch read once
and written once, with the coefficients, over the card's 3.35 TB/s; its
~18 float operations per value take less), and the card's name and power
limit (null on the CPU, whose host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import draw_medium_geometry
from nnue_vision_tpu_torch.ops import warp_kernel as wk
from nnue_vision_tpu_torch.ops.timing import (
    bytes_bound_ms,
    card,
    chained_best_ms,
)

H = W = 32
C = 3


def inputs(batch: int, device):
    """(images (B, H, W, C), swap (B,), coef1, coef2 (B, 3), packed warp
    params (B, 8)), all on `device`."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((batch, H, W, C), dtype=np.float32))
    m, v = draw_medium_geometry(torch.Generator().manual_seed(5), batch, H, W)
    swap, coef1, coef2 = wk.warp_coefficients(m, v, H, W)
    params = wk.pack_warp_params(swap, coef1, coef2)
    return tuple(t.to(device) for t in (x, swap, coef1, coef2, params))


def five_stage_warp(x, swap, coef1, coef2) -> torch.Tensor:
    """The warp as the TPU ran it: swap blend, pass 1, transpose, pass 2,
    transpose back; bit-equal to `warp_bilinear`."""
    b, h, w, c = x.shape
    xs = torch.where(swap[:, None, None, None], x.transpose(1, 2), x)
    tmp = wk.lerp_pass(xs.reshape(b, h, w * c), coef1, n=w, c=c)
    tmp_t = tmp.reshape(b, h, w, c).transpose(1, 2).reshape(b, w, h * c)
    out_t = wk.lerp_pass(tmp_t, coef2, n=h, c=c)
    return out_t.reshape(b, w, h, c).transpose(1, 2).contiguous()


def variants(x, swap, coef1, coef2, params) -> dict:
    b = x.shape[0]
    packed = x.reshape(b, H, W * C)
    sw = swap[:, None, None, None]
    return {
        "transpose": lambda: x.transpose(1, 2).reshape(b, W, H * C),
        "swap_blend": lambda: torch.where(sw, x.transpose(1, 2), x),
        "lerp_pass": lambda: wk.lerp_pass(packed, coef1, n=W, c=C),
        "nogather": lambda: wk.nogather_pass(packed, coef1, n=W, c=C),
        "two_passes": lambda: wk.lerp_pass(
            wk.lerp_pass(packed, coef1, n=W, c=C), coef2, n=W, c=C),
        "five_stages": lambda: five_stage_warp(x, swap, coef1, coef2),
        "warp_kernel": lambda: wk.warp_bilinear(x, params),
    }


def run(batch: int = 1024, device="cuda") -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    reps = int(os.environ.get("WARP_SPLIT_REPS", "400"))
    only = os.environ.get("WARP_SPLIT_ONLY", "")
    x, swap, coef1, coef2, params = inputs(batch, dev)
    ms = {name: chained_best_ms(fn, reps)
          for name, fn in variants(x, swap, coef1, coef2, params).items()
          if only in name}
    gather = (ms["lerp_pass"] - ms["nogather"]
              if {"lerp_pass", "nogather"} <= ms.keys() else None)
    return {"batch": batch, "device": str(dev), "card": card(dev),
            "reps": reps, "ms": ms, "gather_ms": gather,
            "bound_ms": bytes_bound_ms(x, x, coef1, coef2)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batch, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
