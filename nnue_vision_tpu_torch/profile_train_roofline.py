"""Time growing slices of the flagship NNUE train step against its bounds.

    python -m nnue_vision_tpu_torch.profile_train_roofline [BATCH]
        [--device cuda]

Port of `scripts/profile_train_roofline.py`: the flagship NNUE
(`config/train_nnue.py` widths, `nnue_init` with torch generator seed 0),
SGD as the JAX probe configures it (LR 0.01, momentum 0.9, weight decay
2e-4, global-norm clip 1, cosine over 300 epochs of 97 steps), on 8192
numpy-random 32×32 images (seed 0) resident on the device, at batch 512,
64 steps a chunk. Each slice adds one stage to the one before:

  empty        one scalar read of the chunk's indices per step
  gather       + the batch's rows and labels by index
  gather_contig  the dataset permuted once a chunk, batches sliced in turn
  augment      + the light tier (flip, brightness/contrast, cutout: plain
               torch, `data/augment.py` `apply_draws`) and the normalize
  forward      + the NNUE forward and cross-entropy, no gradient
  grad         + the gradients (`torch.autograd.grad`), no update
  full         + the update: `training/step.py` `train_step` (SGD, clip)
  full_contig  `full` on the contiguous slices

Each slice is graph-timed as a chunk: `ops/timing.py` captures the 64
steps in one CUDA graph and replays it, best of 3, ms per step. The host
draws cannot sit inside a graph: each of the chunk's steps gets its light
draws from `draw_tier` before capture (uploaded once), and the graph
replays `apply_draws` on them, as the loop's `ChunkGraph` does; the draws
and their upload are timed apart on the host clock (`draw_upload_ms`).

  full_prod    the loop's own chunk: `scanned_train_steps` (light tier),
               one CUDA graph replay per chunk after its eager warm-up and
               its capture, host clock over 8 chunks with one
               sync, best of 3: host draws, packing and upload included

The JAX probe's `full_unroll4/8` (scan unroll) and `forward_arg` (params as
scan arguments, not closure constants) ask about XLA's loop and constants;
a CUDA graph has no loop, and a module's parameters are read by address
either way. Their counterparts: `full_unroll4/8` are `full` captured 4 and
8 steps to a graph, and `forward_arg` and `full_eager` are `forward` and
`full` run eagerly (host clock, one sync per chunk): graphed against
eager. Each key's note says so.

`analytic` holds the JAX probe's counts at this batch with the card's
rates: FLOPs of the convs and matmuls (2 per multiply-add; the forward
once, the train step three times) over the card's float32 rate, 67 TFLOP/s
(the loop turns TF32 off), and the gather's and an augment pass's bytes
over 3.35 TB/s. Prints one JSON object with the card's name and power
limit (null on the CPU, whose host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import sys
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from nnue_vision_tpu_torch.data.augment import (
    Draws,
    apply_draws,
    draw_batch,
    draw_tier,
    normalize_images,
)
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
)
from nnue_vision_tpu_torch.ops.timing import (
    BF16_FLOPS_PER_S,
    F32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    card,
    chained_best_ms,
    host_best_ms,
)
from nnue_vision_tpu_torch.training.optim import Optimizer, create_optimizer
from nnue_vision_tpu_torch.training.step import (
    make_train_state,
    scanned_train_steps,
    train_step,
)

FLAGSHIP = NNUEConfig(  # config/train_nnue.py
    feature_set=GridFeatureSet(grid_size=10, num_features_per_square=8),
    l1_size=1024, l2_size=128, l3_size=32, num_classes=10, input_size=32,
)
# the JAX probes' OptCfg, with its steps_per_epoch
OPT = SimpleNamespace(learning_rate=0.01, weight_decay=2e-4, momentum=0.9,
                      optimizer_type="sgd", max_grad_norm=1.0,
                      use_cosine_scheduler=True, max_epochs=300, decay_lr=True,
                      use_cyclical_lr=False)
STEPS_PER_EPOCH = 97
NOTES = {
    "full_unroll4": "no scan to unroll: `full` captured 4 steps to a CUDA graph",
    "full_unroll8": "no scan to unroll: `full` captured 8 steps to a CUDA graph",
    "forward_arg": "parameters are read by address in eager and graph alike: "
                   "`forward` run eagerly, host clock, one sync per chunk",
    "full_eager": "`full` run eagerly, host clock, one sync per chunk",
    "full_prod": "the loop's graphed scanned_train_steps (light tier), host "
                 "clock per chunk: host draws and upload included",
    "analytic": "FLOP bounds at the card's float32 rate (TF32 off); "
                "peak_bf16_flops is the bf16 tensor-core rate, for reference",
}


def train_data(n_data: int, h: int, w: int, device, seed: int = 0,
               num_classes: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, h, w, 3) float32 in [0, 1), labels (n,) int64) on
    `device`, numpy-random from `seed`."""
    rng = np.random.default_rng(seed)
    images = rng.random((n_data, h, w, 3), dtype=np.float32)
    labels = rng.integers(0, num_classes, n_data).astype(np.int64)
    return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def light_draws(gen: torch.Generator, steps: int, batch: int, h: int, w: int,
                device) -> List[Draws]:
    """One step's light-tier draws per step, each uploaded once."""
    return [draw_tier(gen, "light", batch, h, w, device) for _ in range(steps)]


def batch_input(images, labels, i, draws):
    """The step's input: gather rows `i`, the light tier on `draws`,
    normalize. (x, y)."""
    x = apply_draws(images.index_select(0, i), draws, None)
    return normalize_images(x), labels.index_select(0, i)


def loss_of(model, x, y) -> torch.Tensor:
    return F.cross_entropy(model(x), y)


def loss_and_grads(model, x, y) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {name: gradient}), a parameter the loss does not reach
    getting zeros."""
    params = dict(model.named_parameters())
    loss = loss_of(model, x, y)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def slices(make_model: Callable, optimizer: Optimizer, images: torch.Tensor,
           labels: torch.Tensor, idx: torch.Tensor,
           draws: Sequence[Draws]) -> Dict[str, Callable]:
    """{slice: one step, a call of no argument} over the chunk's (spd, B)
    device indices `idx` and its per-step `draws`, each step taking the
    next row in turn. Each slice with a model gets its own
    (`make_model()`); each returns a tensor that depends on its step."""
    spd, batch = idx.shape
    n = images.shape[0]
    dev = images.device

    def stepper(fn):
        it = itertools.cycle(range(spd))
        return lambda: fn(next(it))

    def carry(fn):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        return stepper(lambda k: acc.add_(fn(k)))

    pimgs, plabels = torch.empty_like(images), torch.empty_like(labels)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(7)).to(dev)

    def contig(k):
        """The k-th contiguous batch of the chunk's permuted dataset,
        permuted at the chunk's first step."""
        if k == 0:
            torch.index_select(images, 0, perm, out=pimgs)
            torch.index_select(labels, 0, perm, out=plabels)
        start = (k * batch) % (n - batch + 1)
        return pimgs[start:start + batch], plabels[start:start + batch]

    def gathered(k):
        return images.index_select(0, idx[k]), labels.index_select(0, idx[k])

    def full(rows):
        state = make_train_state(make_model(), optimizer)

        def step(k):
            x, y = rows(k)
            x = normalize_images(apply_draws(x, draws[k], None))
            return train_step(state, x, y, optimizer=optimizer)["loss"]
        return stepper(step)

    forward_model, grad_model = make_model(), make_model()

    def forward(k):
        with torch.no_grad():
            return loss_of(forward_model, *batch_input(images, labels, idx[k],
                                                       draws[k]))

    def grad(k):
        loss, grads = loss_and_grads(grad_model, *batch_input(
            images, labels, idx[k], draws[k]))
        return loss + sum(g.sum() for g in grads.values()) * 0

    return {
        "empty": carry(lambda k: idx[k, 0].to(torch.float32)),
        "gather": carry(lambda k: sum(t.sum() for t in gathered(k))),
        "gather_contig": carry(lambda k: sum(t.sum() for t in contig(k))),
        "augment": carry(lambda k: batch_input(images, labels, idx[k],
                                               draws[k])[0].sum()),
        "forward": carry(forward),
        "grad": carry(grad),
        "full": full(gathered),
        "full_contig": full(contig),
    }


def fwd_flops_per_image(cfg: NNUEConfig) -> float:
    """The convs' and matmuls' FLOPs (2 per multiply-add) of one forward
    (JAX `profile_scaled_train.fwd_flops_per_image`)."""
    oh = ow = cfg.conv_out_hw
    ch = cfg.feature_set.num_features_per_square
    f = cfg.feature_set.num_features
    return 2.0 * (
        oh * ow * ch * 27
        + f * cfg.l1_size
        + cfg.l1_size * cfg.l2_size
        + cfg.l2_size * cfg.l3_size
        + cfg.l3_size * cfg.num_classes
    )


def analytic(cfg: NNUEConfig, batch: int) -> dict:
    """The JAX probe's bounds at `batch`, at the card's rates."""
    fwd = fwd_flops_per_image(cfg)
    img_bytes = cfg.input_size * cfg.input_size * 3 * 4
    gather_bytes = 2 * batch * img_bytes  # read + write the batch
    augment_bytes = 4 * batch * img_bytes  # two more read/write passes
    return {
        "fwd_flops_per_image": fwd,
        "train_flops_per_image": 3 * fwd,
        "mxu_bound_ms_fwd": batch * fwd / F32_FLOPS_PER_S * 1e3,
        "mxu_bound_ms_train": batch * 3 * fwd / F32_FLOPS_PER_S * 1e3,
        "hbm_bound_ms_gather": gather_bytes / HBM_BYTES_PER_S * 1e3,
        "hbm_bound_ms_augment_pass": augment_bytes / HBM_BYTES_PER_S * 1e3,
        "gather_bytes": gather_bytes,
        "augment_pass_bytes": augment_bytes,
        "peak_f32_flops": F32_FLOPS_PER_S,
        "peak_bf16_flops": BF16_FLOPS_PER_S,
        "hbm_bytes_per_sec": HBM_BYTES_PER_S,
    }


def prod_ms_per_step(make_model: Callable, optimizer: Optimizer,
                     images: torch.Tensor, labels: torch.Tensor, spd: int,
                     batch: int, chunks: int, augment: bool = True) -> float:
    """ms per step of the loop's light-tier chunk (`scanned_train_steps`;
    `augment=False`: no tier): its eager warm-up and its capture first,
    then `chunks` chunks, host clock with one sync, best of 3."""
    state = make_train_state(make_model(), optimizer)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    n = images.shape[0]

    def chunk():
        idx = rng.integers(0, n, (spd, batch))
        return scanned_train_steps(state, images, labels, idx, gen,
                                   optimizer=optimizer, strength="light",
                                   augment=augment)["loss"]

    chunk()
    chunk()
    return host_best_ms(chunk, chunks) / spd


def run(batch: int = 512, device="cuda", spd: int = 64, chunks: int = 8,
        n_data: int = 8192, model_cfg: NNUEConfig = FLAGSHIP) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h = w = model_cfg.input_size
    images, labels = train_data(n_data, h, w, dev)
    base = nnue_init(model_cfg, torch.Generator().manual_seed(0), device=dev)

    def make_model():
        return copy.deepcopy(base)

    optimizer = create_optimizer(OPT, STEPS_PER_EPOCH)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n_data, (spd, batch))).to(dev)
    gen = torch.Generator().manual_seed(1)
    draws = light_draws(gen, spd, batch, h, w, dev)
    out = {"batch": batch, "steps_per_dispatch": spd, "device": str(dev),
           "card": card(dev), "notes": NOTES}
    ms = {}
    for name, fn in slices(make_model, optimizer, images, labels, idx,
                           draws).items():
        ms[name] = chained_best_ms(fn, spd)
    again = slices(make_model, optimizer, images, labels, idx, draws)
    ms["full_unroll4"] = chained_best_ms(again["full"], 4)
    ms["full_unroll8"] = chained_best_ms(
        slices(make_model, optimizer, images, labels, idx, draws)["full"], 8)
    ms["forward_arg"] = host_best_ms(again["forward"], spd)
    ms["full_eager"] = host_best_ms(
        slices(make_model, optimizer, images, labels, idx, draws)["full"], spd)
    ms["full_prod"] = prod_ms_per_step(make_model, optimizer, images, labels,
                                       spd, batch, chunks)
    for name, v in ms.items():
        out[name + "_ms_per_step"] = v
        out[name + "_images_per_sec"] = batch / (v / 1e3)
    out["draw_upload_ms"] = host_best_ms(
        lambda: draw_batch(gen, "light", batch, h, w).to(dev), spd)
    out["analytic"] = analytic(model_cfg, batch)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batch, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
