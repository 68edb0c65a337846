"""The photometric block plain against K5 in the tiers, the heavy tier's
cost split, and the port's random draws.

    python -m nnue_vision_tpu_torch.profile_photometric_rng [--device cuda]

Port of `scripts/profile_photometric_rng.py`, on 1024 numpy-random 32×32×3
images (seed 7), host draws from a torch generator (seed 123) uploaded
before timing, device normals from the card's default generator (a CUDA
graph replays it). Device stages are timed by
`ops/timing.scalar_chained_best_ms` (50 reps in one CUDA graph, each
fed the previous rep's leading element times 0, best of 3 replays):

1. `tier_{medium,heavy}_{xla,pallas}`: the medium and heavy tiers
   (`apply_tier`) with their photometric blocks as the plain chain
   (`photometric_block_reference`, "xla") and as K5 ("pallas"); the warps
   are K4 in both. The choice is made here, not by a package switch.
2. The heavy tier's cost split: `full_size_normals` (its two unit-normal
   (B, 32, 32, 3) tensors), `one_warp` (the medium geometry's composed
   map, one K4 launch), `medium_block_{plain,k5}`; and on the host clock
   `host_draws_ms`, all of a heavy step's ~26 per-sample draws made on the
   host (`draw_batch`) and uploaded in one copy, synchronized.
3. The JAX probe's RNG implementations (threefry, rbg, unsafe_rbg, the
   bridge) become the port's two sources: `host_draws_ms` against
   `device_normals_ms`, the two normals from a device generator
   (`device_generator`, eager: a CUDA graph replays only the default
   generator unless it is registered), host clock, synchronized.

Prints one JSON object with the card's name and power limit (null on the
CPU, whose host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops.timing import (
    card,
    host_best_ms,
    scalar_chained_best_ms,
)

B, H, W, C = 1024, 32, 32, 3
REPS = 50


def tier_plain_photometric(x: torch.Tensor, draws: aug.TierDraws) -> torch.Tensor:
    """`augment.apply_tier` with each photometric block as the plain chain."""
    x = aug.warp(x, draws.warp1)
    x = pk.photometric_block_reference(x, torch.randn(x.shape, device=x.device),
                                       *draws.photo1, variant="medium")
    if draws.warp2 is not None:
        x = aug.warp(x, draws.warp2)
        x = pk.photometric_block_reference(
            x, torch.randn(x.shape, device=x.device), *draws.photo2,
            variant="heavy_extra")
    return x


def tier_fns(draws: dict) -> dict:
    """{name: fwd(d, bump)} of probe 1 on {strength: TierDraws}."""
    fns = {}
    for strength in ("medium", "heavy"):
        d = draws[strength]
        fns[f"tier_{strength}_xla"] = (
            lambda x, bump, d=d: tier_plain_photometric(x + bump, d))
        fns[f"tier_{strength}_pallas"] = (
            lambda x, bump, d=d: aug.apply_tier(x + bump, d, None))
    return fns


def split_fns(draws: dict, one_warp: torch.Tensor) -> dict:
    """{name: fwd(d, bump)} of probe 2's device stages."""
    med = draws["medium"]

    def normals(x, bump):
        n1 = torch.randn(x.shape, device=x.device)
        n2 = torch.randn(x.shape, device=x.device)
        return x + bump + n1 * 1e-6 + n2 * 1e-6

    def block(fn):
        return lambda x, bump: fn(x + bump, torch.randn(x.shape, device=x.device),
                                  *med.photo1, variant="medium")

    return {"full_size_normals": normals,
            "one_warp": lambda x, bump: aug.warp(x + bump, one_warp),
            "medium_block_plain": block(pk.photometric_block_reference),
            "medium_block_k5": block(pk.photometric_block)}


def run(batch: int = B, device="cuda", reps: int = REPS) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((batch, H, W, C)).astype(np.float32)).to(dev)
    gen = torch.Generator().manual_seed(123)
    draws = {s: aug.draw_tier(gen, s, batch, H, W, dev) for s in ("medium", "heavy")}
    one_warp = aug._warp_params(aug.draw_medium_geometry(gen, batch, H, W), H,
                                W).to(dev)
    out = {"batch": batch, "device": str(dev), "card": card(dev), "reps": reps}
    fns = {**tier_fns(draws), **split_fns(draws, one_warp)}
    for name, fn in fns.items():
        out[name + "_ms"] = scalar_chained_best_ms(fn, x, reps)
    out["host_draws_ms"] = host_best_ms(
        lambda: aug.draw_batch(gen, "heavy", batch, H, W).to(dev), reps)
    noise_gen = aug.device_generator(gen, dev)
    out["device_normals_ms"] = host_best_ms(
        lambda: [torch.randn(x.shape, generator=noise_gen, device=dev)
                 for _ in range(2)][-1], reps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
