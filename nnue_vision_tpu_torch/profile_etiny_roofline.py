"""Split the EtinyNet-0.98M train step without augmentation into slices.

    python -m nnue_vision_tpu_torch.profile_etiny_roofline [--device cuda]

Port of `scripts/profile_etiny_roofline.py`: the 0.98M EtinyNet (10
classes, 32×32, float32, `etinynet_init` with torch generator seed 3), the
JAX probes' SGD, on 8192 numpy-random 32×32 images (seed 0) resident on
the device, batch 1024, 16 steps a chunk:

  floor     the batch's rows by index and a scalar update from their mean
  forward   + the forward in training mode (the norms' running statistics
            updated), no gradient
  fwd_bwd   + the cross-entropy's gradients and a plain SGD update
            (p - 1e-9·g), no optimizer
  full      the loop's step on the gathered batch: normalize, then
            `training/step.py` `train_step` (forward, backward, norm
            statistics, SGD with its clip)

Each is graph-timed as a chunk (`ops/timing.py`: the chunk's steps in one
CUDA graph, best of 3 replays, ms per step), so `full` less `fwd_bwd` is
what the loop's step adds to a bare update (the normalize, the accuracy,
the optimizer with its clip), on one clock. Beside them:

  full_prod the loop's own chunk: `scanned_train_steps` with augment off,
            one CUDA graph replay per chunk after its eager warm-up and its
            capture, host clock over 8 chunks with one sync, best of 3:
            host packing and upload included

and the JAX probe's activation-traffic bound with its shape list (each
layer's float32 activations written and read once, the forward three times
for forward and backward) over the card's 3.35 TB/s. Prints one JSON
object with the card's name and power limit (null on the CPU, whose
host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import sys
from typing import Callable, Dict

import numpy as np
import torch
from torch.nn import functional as F

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig, etinynet_init
from nnue_vision_tpu_torch.ops.timing import HBM_BYTES_PER_S, card, chained_best_ms
from nnue_vision_tpu_torch.profile_train_roofline import (
    OPT,
    STEPS_PER_EPOCH,
    prod_ms_per_step,
    train_data,
)
from nnue_vision_tpu_torch.training.optim import Optimizer, create_optimizer
from nnue_vision_tpu_torch.training.step import make_train_state, train_step

ETINY = EtinyNetConfig(variant="0.98M", num_classes=10, input_size=32)
# (spatial size, channels) of the 0.98M model's activations (the JAX probe's)
SHAPES = [(32, 28), (32, 28), (16, 96), (16, 96), (8, 168), (8, 168),
          (4, 192), (4, 192), (4, 384), (4, 384), (1, 384)]


NOTES = {"full_prod": "the loop's graphed scanned_train_steps (augment off), "
                      "host clock per chunk: host packing and upload included"}


def activation_bytes(batch: int, shapes=SHAPES) -> int:
    """One forward's float32 activation traffic: each written and read."""
    return sum(batch * h * h * c * 4 * 2 for h, c in shapes)


def slices(make_model: Callable, optimizer: Optimizer, images: torch.Tensor,
           labels: torch.Tensor, idx: torch.Tensor) -> Dict[str, Callable]:
    """{slice: one step, a call of no argument} over the chunk's (K, B)
    device indices, each step taking the next row in turn; the model
    slices each get their own (`make_model()`, in training mode)."""
    steps = idx.shape[0]
    dev = images.device

    def stepper(fn):
        it = itertools.cycle(range(steps))
        return lambda: fn(next(it))

    acc = torch.zeros((), dtype=torch.float32, device=dev)
    fwd_model, bwd_model = make_model().train(), make_model().train()
    params = list(bwd_model.parameters())

    def floor(k):
        return acc.add_(images.index_select(0, idx[k]).mean() * 1e-9)

    def forward(k):
        with torch.no_grad():
            return fwd_model(images.index_select(0, idx[k])).mean()

    def fwd_bwd(k):
        logits = bwd_model(images.index_select(0, idx[k]))
        loss = F.cross_entropy(logits, labels.index_select(0, idx[k]))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            torch._foreach_add_([p for p, g in zip(params, grads) if g is not None],
                                [g for g in grads if g is not None], alpha=-1e-9)
        return loss.detach()

    state = make_train_state(make_model(), optimizer)

    def full(k):
        x = normalize_images(images.index_select(0, idx[k]))
        return train_step(state, x, labels.index_select(0, idx[k]),
                          optimizer=optimizer)["loss"]

    return {"floor": stepper(floor), "forward": stepper(forward),
            "fwd_bwd": stepper(fwd_bwd), "full": stepper(full)}


def run(batch: int = 1024, steps: int = 16, n_data: int = 8192,
        device="cuda", chunks: int = 8, model_cfg: EtinyNetConfig = ETINY) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw = model_cfg.input_size
    images, labels = train_data(n_data, hw, hw, dev)
    base = etinynet_init(model_cfg, torch.Generator().manual_seed(3), device=dev)

    def make_model():
        return copy.deepcopy(base)

    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, n_data, (steps, batch))).to(dev)
    optimizer = create_optimizer(OPT, STEPS_PER_EPOCH)
    ms = {name: chained_best_ms(fn, steps) for name, fn in
          slices(make_model, optimizer, images, labels, idx).items()}
    ms["full_prod"] = prod_ms_per_step(make_model, optimizer, images, labels,
                                       steps, batch, chunks, augment=False)
    fwd_bytes = activation_bytes(batch)
    out = {"variant": model_cfg.variant, "batch": batch,
           "steps_per_dispatch": steps, "device": str(dev), "card": card(dev),
           "notes": NOTES}
    for name, v in ms.items():
        out[name + "_ms_per_step"] = v
        out[name + "_images_per_sec"] = batch / (v / 1e3)
    out["fwd_activation_bytes"] = fwd_bytes
    out["activation_bound_ms_per_step"] = 3 * fwd_bytes / HBM_BYTES_PER_S * 1e3
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
