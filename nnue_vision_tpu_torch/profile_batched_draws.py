"""Would one batched draw beat the heavy tier's ~26 separate draws?

    python -m nnue_vision_tpu_torch.profile_batched_draws [--device cuda]

Port of `scripts/profile_batched_draws.py`. The JAX tier made 24 small
per-sample draws and two full-size normals on the device, one RNG kernel
each. The port makes the small draws on the host (`data/augment.py`
`draw_batch`: every per-sample draw of a heavy step, packed into one
buffer and uploaded in one copy) and the two (B, 32, 32, 3) unit normals
on the device from a device generator (`device_generator`). The same
question, for the port's two sources (nothing in `data/augment.py`
changes):

  current              `draw_batch` + one upload + two float32 normals
  batched_smalls       one (24, B) host uniform + one upload + two normals
  fully_batched        one (24, B) host uniform + one upload + one
                       (2, B, 32, 32, 3) normal
  bf16_normals         `draw_batch` + one upload + two bfloat16 normals
  no_normals           `draw_batch` + one upload

Beside them, `augment_batch_heavy_ms`: the whole heavy tier of a step as
the eager loop runs it (`augment_batch`: the host draws, one upload, the
two warps (K4) and the two photometric blocks (K5) with their normals) on
1024 numpy-random images (seed 7), the total the draws are a share of.

Each variant is timed on the host clock over 50 calls with the card
synchronized before and after, best of 3, ms per call (`ops/timing.py`
`host_best_ms`); each variant's device part (its normals) is also
graph-timed on the card's default generator (`*_device_ms`), and the host
part alone on the host clock (`*_host_ms`). Prints one JSON object with
the card's name and power limit (null on the CPU, whose host-clock times
are for the tests only).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.ops.timing import card, chained_best_ms, host_best_ms

B, H, W, C = 1024, 32, 32, 3
REPS = 50
SMALL_DRAWS = 24


def variants(batch: int, h: int, w: int, gen: torch.Generator,
             noise_gen: Optional[torch.Generator], device
             ) -> Dict[str, Tuple[Callable, Optional[Callable]]]:
    """{variant: (host part, device part or None)}: the host part draws and
    uploads, returning the uploaded tensor; the device part draws the
    normals from `noise_gen` (None: the default generator) and returns
    the last."""
    shape = (batch, h, w, C)

    def heavy():
        return aug.draw_batch(gen, "heavy", batch, h, w).to(device)

    def smalls():
        return torch.rand((SMALL_DRAWS, batch), generator=gen).to(device)

    def normals(count, dtype, lead=()):
        return lambda: [torch.randn(lead + shape, generator=noise_gen,
                                    device=device, dtype=dtype)
                        for _ in range(count)][-1]

    f32, bf16 = torch.float32, torch.bfloat16
    return {"current": (heavy, normals(2, f32)),
            "batched_smalls": (smalls, normals(2, f32)),
            "fully_batched": (smalls, normals(1, f32, (2,))),
            "bf16_normals": (heavy, normals(2, bf16)),
            "no_normals": (heavy, None)}


def run(batch: int = B, device="cuda", reps: int = REPS) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    gen = torch.Generator().manual_seed(123)
    noise_gen = aug.device_generator(gen, dev)
    out = {"batch": batch, "device": str(dev), "card": card(dev), "reps": reps}
    for name, (host, device_part) in variants(batch, H, W, gen, noise_gen,
                                              dev).items():
        def both(host=host, device_part=device_part):
            buf = host()
            return buf if device_part is None else device_part()

        out[name + "_ms"] = host_best_ms(both, reps)
        out[name + "_host_ms"] = host_best_ms(host, reps)
    for name, (_, device_part) in variants(batch, H, W, gen, None, dev).items():
        out[name + "_device_ms"] = (None if device_part is None
                                    else chained_best_ms(device_part, reps))
    x = np.random.default_rng(7).random((batch, H, W, C), dtype=np.float32)
    x = torch.from_numpy(x).to(dev)
    out["augment_batch_heavy_ms"] = host_best_ms(
        lambda: aug.augment_batch(gen, x, "heavy", noise_gen), reps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
