"""Time the EtinyNet-0.98M train step per augmentation tier and chunk length.

    python -m nnue_vision_tpu_torch.profile_etiny_train [SPD ...]
        [--device cuda]

Port of `scripts/profile_etiny_train.py`: the 0.98M EtinyNet (10 classes,
32×32, float32, `etinynet_init` with torch generator seed 3), the JAX
probes' SGD, on 8192 numpy-random 32×32 images (seed 0) resident on the
device, batch 1024, at each chunk length SPD (default 16): no
augmentation (the bound the tiers are held to), then the light, medium
and heavy tiers. Each is the loop's chunk, `scanned_train_steps` (the
medium and heavy tiers: K4 and K5 inside, their noise from a device
generator), through `profile_train_sweep.chunk_rate`: on a card the first
chunk eager, the second captured as one CUDA graph, then 10
chunks on the host clock with one sync at the end.

Beside them, the production step as
`profile_augment.train_step_ms` times it: `config/train_etinynet.py`
(bf16, heavy tier) on 20,000 synthetic-hard images, two runs of 48
eager `gathered_train_step`s each (card only). Prints one JSON object with the card's
name and power limit (null on the CPU, whose host-clock times are for the
tests only).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch

from nnue_vision_tpu_torch import profile_augment
from nnue_vision_tpu_torch.data.augment import device_generator
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig, etinynet_init
from nnue_vision_tpu_torch.ops.timing import card
from nnue_vision_tpu_torch.profile_etiny_roofline import ETINY
from nnue_vision_tpu_torch.profile_train_roofline import (
    OPT,
    STEPS_PER_EPOCH,
    train_data,
)
from nnue_vision_tpu_torch.profile_train_sweep import chunk_rate
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import make_train_state, scanned_train_steps

# (label, strength, augment) in the JAX probe's order
TIERS = (("no-aug", "heavy", False), ("light", "light", True),
         ("medium", "medium", True), ("heavy", "heavy", True))


def measure(base, images: torch.Tensor, labels: torch.Tensor, strength: str,
            augment: bool, batch: int, spd: int, dispatches: int) -> dict:
    """One tier at one chunk length: a copy of the model `base`, a new
    optimizer state, the loop's chunks (`chunk_rate`)."""
    dev = images.device
    optimizer = create_optimizer(OPT, STEPS_PER_EPOCH)
    state = make_train_state(copy.deepcopy(base), optimizer)
    gen = torch.Generator().manual_seed(4)
    noise_gen = device_generator(gen, dev)
    rng = np.random.default_rng(0)
    n = images.shape[0]

    def chunk():
        idx = rng.integers(0, n, (spd, batch))
        return scanned_train_steps(state, images, labels, idx, gen,
                                   optimizer=optimizer, strength=strength,
                                   augment=augment, noise_gen=noise_gen)

    return chunk_rate(chunk, dispatches, spd * batch, dev)


def run(spds=(16,), batch: int = 1024, dispatches: int = 10, device="cuda",
        production_steps: int = profile_augment.TRAIN_STEPS, n_data: int = 8192,
        model_cfg: EtinyNetConfig = ETINY) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw = model_cfg.input_size
    images, labels = train_data(n_data, hw, hw, dev)
    base = etinynet_init(model_cfg, torch.Generator().manual_seed(3), device=dev)
    out = {"variant": model_cfg.variant, "batch": batch, "device": str(dev),
           "card": card(dev), "steps_per_dispatch": {}}
    for spd in spds:
        out["steps_per_dispatch"][str(spd)] = {
            label: measure(base, images, labels, strength, augment, batch, spd,
                           dispatches)
            for label, strength, augment in TIERS}
    if dev.type == "cuda":
        out["production_eager_ms_per_step"] = profile_augment.train_step_ms(
            dev, production_steps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("spds", nargs="*", type=int, default=[16],
                        help="steps-per-chunk values to sweep")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.spds or [16], device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
