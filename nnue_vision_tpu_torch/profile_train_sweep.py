"""Sweep the flagship NNUE train step over batch sizes and chunk lengths.

    python -m nnue_vision_tpu_torch.profile_train_sweep [BATCH ...] [--fused]
        [--spd 64 ...] [--strength light] [--device cuda]

Port of `scripts/profile_train_sweep.py`: the whole train step of the
flagship NNUE (`config/train_nnue.py` widths, `nnue_init` with torch
generator seed 0, the JAX probes' SGD) on 8192 numpy-random 32×32 images
(seed 0) resident on the device, at batches 512–4096 and `--spd` steps a
chunk, each chunk as the loop runs it: `scanned_train_steps` on the
`--strength` tier (light: plain torch; medium and heavy: K4 and K5), or
with `--fused` `scanned_train_steps_fused` (K3 for the whole input path).
On a card a chunk is one CUDA graph replay: at each point the first chunk
runs eagerly, the second captures the graph, and about 4,194,304 images
of chunks are then timed on the host clock with one sync at the end.

Prints one JSON object: per point the JAX probe's keys (fused, batch,
steps_per_dispatch, strength, images_per_sec, final_loss), the ms per
step, the peak device memory of the point (dataset, model and the graph's
pool included; null on the CPU), and per chunk length the saturating batch
(the smallest whose images/s is within 5% of the best), with the card's
name and power limit (null on the CPU, whose host-clock times are for the
tests only).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import device_generator
from nnue_vision_tpu_torch.models.nnue import NNUEConfig, nnue_init
from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
from nnue_vision_tpu_torch.ops.timing import card
from nnue_vision_tpu_torch.profile_train_roofline import (
    FLAGSHIP,
    OPT,
    STEPS_PER_EPOCH,
    train_data,
)
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
)

SATURATED = 0.95  # images/s within 5% of the sweep's best


def chunk_rate(chunk: Callable[[], Dict[str, torch.Tensor]], dispatches: int,
               images_per_chunk: int, device) -> dict:
    """Two warm-up chunks (on a card: eager, then the capture and its
    replay), then `dispatches` chunks on the host clock with one sync at
    the end. `chunk()` runs one chunk and returns its metrics, whose
    (K,) "loss" is read once, at the end."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    seconds = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        chunk()
        sync()
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(dispatches):
        metrics = chunk()
    loss = float(metrics["loss"][-1])  # syncs: the chunks ran in order
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} in the timed chunks")
    steps = dispatches * len(metrics["loss"])
    return {"images_per_sec": dispatches * images_per_chunk / dt,
            "ms_per_step": dt / steps * 1e3, "final_loss": loss,
            "first_chunk_s": seconds[0], "second_chunk_s": seconds[1],
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if cuda else None}


def sweep_point(model_cfg: NNUEConfig, images: torch.Tensor,
                labels: torch.Tensor, batch: int, spd: int, dispatches: int,
                fused: bool, strength: str = "light",
                gather_ds: Optional[torch.Tensor] = None) -> dict:
    """One point of the sweep: a new model and optimizer state, `spd`-step
    chunks at `batch` through the loop's chunk function."""
    dev = images.device
    optimizer = create_optimizer(OPT, STEPS_PER_EPOCH)
    state = make_train_state(
        nnue_init(model_cfg, torch.Generator().manual_seed(0), device=dev),
        optimizer)
    gen = torch.Generator().manual_seed(1)
    noise_gen = device_generator(gen, dev) if strength != "light" else None
    rng = np.random.default_rng(0)
    n, h, w = images.shape[:3]

    def chunk():
        idx = rng.integers(0, n, (spd, batch))
        if fused:
            return scanned_train_steps_fused(state, gather_ds, labels, idx, gen,
                                             optimizer=optimizer, height=h,
                                             width=w)
        return scanned_train_steps(state, images, labels, idx, gen,
                                   optimizer=optimizer, strength=strength,
                                   noise_gen=noise_gen)

    return {"fused": fused, "batch": batch, "steps_per_dispatch": spd,
            "strength": "light" if fused else strength,
            **chunk_rate(chunk, dispatches, spd * batch, dev)}


def saturating_batch(points: Sequence[dict]) -> Dict[str, int]:
    """Per chunk length, the smallest batch within 5% of its best images/s."""
    out = {}
    for spd in sorted({p["steps_per_dispatch"] for p in points}):
        pts = [p for p in points if p["steps_per_dispatch"] == spd]
        best = max(p["images_per_sec"] for p in pts)
        out[str(spd)] = min(p["batch"] for p in pts
                            if p["images_per_sec"] >= SATURATED * best)
    return out


def run(batches=(512, 1024, 2048, 4096), fused: bool = False, spds=(64,),
        strength: str = "light", device="cuda", images: int = 1 << 22,
        n_data: int = 8192, model_cfg: NNUEConfig = FLAGSHIP) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h = w = model_cfg.input_size
    data, labels = train_data(n_data, h, w, dev)
    gather_ds = prepare_gather_dataset(data) if fused else None
    points = [sweep_point(model_cfg, data, labels, batch, spd,
                          max(4, images // (spd * batch)), fused, strength,
                          gather_ds)
              for spd in spds for batch in batches]
    return {"device": str(dev), "card": card(dev), "points": points,
            "saturating_batch": saturating_batch(points)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batches", nargs="*", type=int,
                        default=[512, 1024, 2048, 4096])
    parser.add_argument("--fused", action="store_true",
                        help="sweep the fused K3 input path")
    parser.add_argument("--spd", type=int, nargs="*", default=[64],
                        help="steps-per-chunk values to sweep")
    parser.add_argument("--strength", default="light",
                        help="augmentation tier of the unfused path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batches or [512, 1024, 2048, 4096], args.fused,
                         args.spd, args.strength, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
