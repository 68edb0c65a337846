"""Time each stage of the augmentation tiers at the EtinyNet training shape.

    python -m nnue_vision_tpu_torch.profile_heavy_aug [--device cuda]

Port of `scripts/profile_heavy_aug.py`, on 1024 numpy-random 32×32×3
images (seed 0). Every random parameter is drawn on the host (torch
generator seed 0) and uploaded before timing, as the loop's CUDA graph
needs; the normals drawn inside a stage come from the card's default
generator, which a CUDA graph replays. Stages:

  noop                 x · 1
  full_light_tier      `apply_draws` on light draws (plain torch)
  full_medium_tier     on medium draws: the warp (K4), then the medium
                       photometric block (K5) with its noise
  full_heavy_tier      on heavy draws: two warps, two K5 blocks
  composed_warp        the medium and heavy geometry composed into one map,
                       one warp (K4)
  warp_identity        K4 on identity maps (its gather alone)
  brightness_contrast, hsv_shift, blur, gauss_noise (its normal draw
  included), cutout, shadow, fog, posterize, equalize_approx
                       each photometric op's plain apply step
                       (`ops/photometric_kernel.py`) on the medium block's
                       drawn gates and values; blur is the two [1, 2, 1]
                       passes of the plain chain (its depthwise-conv form
                       makes its taps on the host, which a CUDA graph can
                       not capture)
  medium_photometric_chain  the medium block as those plain steps in a row
                       (`photometric_block_reference`, with its noise)
  medium_photometric_k5     the same block as one K5 launch
  normal_draw          one unit-normal (B, H, W, 3) draw

The port has no XLA realization of the photometric ops apart from the plain
steps: the block is timed both ways. Each stage is timed by
`ops/timing.py`: 32 applications in one CUDA graph (the JAX probe's
K), best of 3 replays, ms per application. Prints one JSON object with
each stage's ms and images/s, the bytes bound every elementwise stage
shares (the batch read once and written once over 3.35 TB/s), and the
card's name and power limit (null on the CPU, whose host-clock times are
for the tests only).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict

import numpy as np
import torch

from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops.timing import bytes_bound_ms, card, chained_best_ms

B, H, W = 1024, 32, 32
REPS = 32  # applications per timed graph: the JAX probe's K


def images(batch: int, h: int, w: int, device, seed: int = 0) -> torch.Tensor:
    x = np.random.default_rng(seed).random((batch, h, w, 3), dtype=np.float32)
    return torch.from_numpy(x).to(device)


def draws(x: torch.Tensor, gen: torch.Generator) -> dict:
    """Every stage's parameters for a batch like x, drawn from `gen` on
    the host and uploaded once: each tier's draws, the composed medium and
    heavy geometry (its (M, v) and warp params), identity warp params, the
    medium block's (fparams, iparams), and a unit-normal noise tensor."""
    b, h, w, _ = x.shape
    dev = x.device
    mv = aug._mv_compose(aug.draw_medium_geometry(gen, b, h, w),
                         aug.draw_heavy_geometry(gen, b, h, w))
    return {
        "tier": {s: aug.draw_tier(gen, s, b, h, w, dev) for s in aug.STRENGTHS},
        "mv": mv, "composed": aug._warp_params(mv, h, w).to(dev),
        "identity": aug._warp_params(aug._mv_identity(b), h, w).to(dev),
        "photo": tuple(t.to(dev) for t in aug.draw_medium_photometric(gen, b, h, w)),
        "noise": torch.randn(x.shape, generator=gen).to(dev),
    }


def stages(x: torch.Tensor, d: dict) -> Dict[str, Callable]:
    """{stage: one application on x, a call of no argument} on the
    parameters `d` (`draws`)."""
    b = x.shape[0]
    dev = x.device
    tier, composed, identity, noise = d["tier"], d["composed"], d["identity"], d["noise"]
    fp, ip = d["photo"]

    def P(i):
        return fp[:, i].reshape(b, 1, 1, 1)

    def G(i):
        return P(i) > 0.5

    rect = tuple(ip[:, k] for k in range(4))
    return {
        "noop": lambda: x * 1.0,
        "full_light_tier": lambda: aug.apply_draws(x, tier["light"], None),
        "full_medium_tier": lambda: aug.apply_draws(x, tier["medium"], None),
        "full_heavy_tier": lambda: aug.apply_draws(x, tier["heavy"], None),
        "composed_warp": lambda: aug.warp(x, composed),
        "warp_identity": lambda: aug.warp(x, identity),
        "brightness_contrast": lambda: pk.apply_brightness_contrast(
            x, G(0), P(1), P(2)),
        "hsv_shift": lambda: pk.apply_hsv(x, G(3), P(4), P(5), P(6)),
        "blur": lambda: pk.apply_blur_separable(x, G(7)),
        "gauss_noise": lambda: pk.apply_noise(x, G(8), P(9),
                                              torch.randn(x.shape, device=dev)),
        "cutout": lambda: pk.apply_cutout(x, G(10), *rect),
        "shadow": lambda: pk.apply_shadow(x, G(15), P(16), P(17), P(18), P(19)),
        "fog": lambda: pk.apply_fog(x, G(20), P(21)),
        "posterize": lambda: pk.apply_posterize(x, G(22)),
        "equalize_approx": lambda: pk.apply_equalize(x, G(23)),
        "medium_photometric_chain": lambda: pk.photometric_block_reference(
            x, noise, fp, ip, variant="medium"),
        "medium_photometric_k5": lambda: pk.photometric_block(
            x, noise, fp, ip, variant="medium"),
        "normal_draw": lambda: torch.randn(x.shape, device=dev),
    }


def run(batch: int = B, device="cuda", reps: int = REPS) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    x = images(batch, H, W, dev)
    out = {"batch": batch, "device": str(dev), "card": card(dev), "reps": reps,
           "elementwise_bound_ms": bytes_bound_ms(x, x)}
    for name, fn in stages(x, draws(x, torch.Generator().manual_seed(0))).items():
        ms = chained_best_ms(fn, reps)
        out[name + "_ms"] = ms
        out[name + "_images_per_sec"] = batch / (ms / 1e3)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
