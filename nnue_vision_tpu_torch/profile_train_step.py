"""Profile the port's train step: where a step's time goes.

    python -m nnue_vision_tpu_torch.profile_train_step \\
        [--config config/train_nnue_hard.py] [--device cuda] [--out DIR]
    python -m nnue_vision_tpu_torch.profile_train_step --model_type etinynet \\
        --config config/train_etinynet.py --dataset_name synthetic-hard \\
        --synthetic_size 50000

Builds the config's model (its seed's random init), uploads its training
set and runs the chunk `train_model` runs: for an NNUE the light-tier fused
chunk (`scanned_train_steps_fused`: one K3 launch and one train step per
step), for an EtinyNet `scanned_train_steps` on the config's augmentation
tier (medium and heavy: K4 and K5 once per block), `steps_per_dispatch`
steps a chunk. On a card the loop's chunk is one CUDA graph replay
("graphed"); beside it the same chunk runs eagerly, from a copy of the
state that never keeps its graph ("eager", the loop's path before the
graph and under a mesh):

1. capture   the graphed state's first chunk (eager, the warm-up) and its
             second (the capture, then a replay): capture and instantiate
             seconds, graph nodes, the capture's peak device memory
2. chunk     ms per step of a chunk on the host clock with one sync at the
             end, in turns eager, graphed, graphed, eager, with each run's
             peak device memory
3. phases    each phase of one step alone, synced before and after, median
             of 20: the input (K3, or the augmentation tier with its
             draws), forward + loss, backward, optimizer, and an NNUE's
             weight clip
4. profile   one eager and one graphed chunk under torch.profiler: device
             operations per step, device busy time (the union of their
             intervals) against the chunk's wall time, and the ops by
             device time, written to DIR/profile_table_{eager,graphed}.txt

Prints one JSON object with these numbers and, on a card, its name and
power limit from nvidia-smi. On the CPU both chunks run eagerly and the
device and graph numbers are null. The profiler slows the host, so the
busy share is read against the profiled chunk's own wall time.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

from config import load_config
from nnue_vision_tpu_torch.data.augment import device_generator, preprocess_batch
from nnue_vision_tpu_torch.data.loaders import create_data_loaders
from nnue_vision_tpu_torch.models.nnue import nnue_clip_weights
from nnue_vision_tpu_torch.ops.input_pipeline import (
    draw_light_params,
    fused_light_pipeline,
    prepare_gather_dataset,
)
from nnue_vision_tpu_torch.ops.timing import card
from nnue_vision_tpu_torch.training.loop import build_model
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    TrainState,
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
)

PHASE_RUNS = 20


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(config_path: str, device: str, out: Path, model_type: str = "nnue",
            overrides=None) -> dict:
    cfg = load_config(config_path)
    for key, value in (overrides or {}).items():
        setattr(cfg, key, value)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    train_loader, _, _ = create_data_loaders(
        dataset_name=cfg.dataset_name, batch_size=cfg.batch_size,
        max_samples_per_split=getattr(cfg, "max_samples_per_split", None),
        seed=cfg.seed, synthetic_size=getattr(cfg, "synthetic_size", 512),
    )
    ds = train_loader.dataset
    gen = torch.Generator().manual_seed(cfg.seed)
    model, _ = build_model(cfg, model_type, gen, dev)
    fused = model_type == "nnue"  # the fused light-tier path, as in the loop
    steps = int(getattr(cfg, "steps_per_dispatch", 8))
    optimizer = create_optimizer(cfg, max(1, len(train_loader)))
    state = make_train_state(model, optimizer)
    images = torch.from_numpy(ds.images).to(dev)
    dataset = prepare_gather_dataset(images) if fused else None
    labels = torch.from_numpy(ds.labels).to(dev)
    n, h, w = ds.images.shape[:3]
    batch = cfg.batch_size
    strength = getattr(cfg, "augmentation_strength", "medium")
    noise_gen = device_generator(gen, dev)
    rng = np.random.default_rng(cfg.seed)
    # the graphed state, and the eager one: a copy that drops its graph
    states = {"graphed": state,
              "eager": TrainState(copy.deepcopy(model), copy.deepcopy(state.opt_state))}

    def chunk(which: str):
        st = states[which]
        if which == "eager":
            st.chunk_graph = None
        idx = np.stack([rng.permutation(n)[:batch] for _ in range(steps)])
        if fused:
            return scanned_train_steps_fused(st, dataset, labels, idx, gen,
                                             optimizer=optimizer, height=h,
                                             width=w)
        return scanned_train_steps(st, images, labels, idx, gen,
                                   optimizer=optimizer, strength=strength,
                                   noise_gen=noise_gen)

    def peak_gb(fn):
        """(fn's result, its peak device memory above what was held)."""
        if not cuda:
            return fn(), None
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn()
        sync()
        return out, (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    chunk("eager")  # warm-up: cuDNN/cuBLAS choices, the kernels' build
    chunk("graphed")  # the graphed state's warm-up (eager)
    _, capture_gb = peak_gb(lambda: chunk("graphed"))  # capture + replay
    graph = state.chunk_graph if cuda else None
    step_ms = {"eager": [], "graphed": []}
    peak = {"eager": [], "graphed": []}
    for which in ("eager", "graphed", "graphed", "eager"):
        sync()
        t0 = time.perf_counter()
        losses, gb = peak_gb(lambda: chunk(which)["loss"])
        step_ms[which].append((time.perf_counter() - t0) / steps * 1e3)
        peak[which].append(gb)
        if not bool(torch.isfinite(losses).all()):
            raise FloatingPointError(f"non-finite loss in the timed {which} chunk")

    # each phase of one step alone
    params = dict(model.named_parameters())
    idx = torch.as_tensor(rng.permutation(n)[:batch])
    y = labels[idx.to(dev)]
    if fused:
        lp = draw_light_params(gen, 1, batch, h, w)
        idx_eff = (idx + n * lp.flip[0].to(torch.int64)).to(torch.int32).to(dev)
        pf, pi = lp.pf[0].to(dev), lp.pi[0].to(dev)

        def input_phase():
            return fused_light_pipeline(dataset, idx_eff, pf, pi, h=h, w=w)
    else:
        idx_dev = idx.to(dev)

        def input_phase():
            return preprocess_batch(gen, images[idx_dev], strength=strength,
                                    noise_gen=noise_gen)
    x = input_phase()
    box = {}

    def forward():
        box["loss"] = F.cross_entropy(model(x), y)

    def backward():
        box["grads"] = torch.autograd.grad(box["loss"], list(params.values()),
                                           allow_unused=True)

    def timed(fn, setup=None) -> float:
        times = []
        for _ in range(PHASE_RUNS):
            if setup is not None:
                setup()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    model.train()
    phase_ms = {
        "k3" if fused else "augment": timed(input_phase),
        "forward_loss": timed(forward),
        "backward": timed(backward, setup=forward),
        "optimizer": timed(lambda: optimizer.step(
            params, dict(zip(params, box["grads"])), state.opt_state)),
    }
    if fused:
        phase_ms["weight_clip"] = timed(lambda: nnue_clip_weights(model))

    # one chunk of each under the profiler
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out.mkdir(parents=True, exist_ok=True)
    profiled = {}
    for which in ("eager", "graphed"):
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            chunk(which)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        device_ops = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = _busy_us((e.time_range.start, e.time_range.end)
                           for e in device_ops)
        table = out / f"profile_table_{which}.txt"
        table.write_text(prof.key_averages().table(
            sort_by="self_device_time_total" if cuda else "self_cpu_time_total",
            row_limit=60))
        profiled[which] = {
            "device_ops_per_step": len(device_ops) / steps if cuda else None,
            "device_busy_ms_per_step": busy_us / 1e3 / steps if cuda else None,
            "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_share": busy_us / wall_us if cuda else None,
            "table": str(table),
        }

    return {
        "config": config_path, "model_type": model_type, "device": str(dev),
        "card": card(dev),
        "batch": batch, "steps": steps,
        "step_ms": step_ms,
        "images_per_s": {k: batch / min(v) * 1e3 for k, v in step_ms.items()},
        "peak_gb": {**peak, "capture": capture_gb},
        "graph": None if graph is None else {
            "capture_s": graph.capture_s, "instantiate_s": graph.instantiate_s,
            "nodes": graph.nodes, "nodes_per_step": graph.nodes / steps,
            "replays": graph.replays},
        "phase_ms": phase_ms,
        "profile": profiled,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="config/train_nnue_hard.py")
    parser.add_argument("--model_type", choices=["nnue", "etinynet"],
                        default="nnue")
    parser.add_argument("--dataset_name", help="override the config's dataset")
    parser.add_argument("--synthetic_size", type=int,
                        help="override the config's synthetic training size")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="logs/profile",
                        help="directory for the profile tables")
    args = parser.parse_args(argv)
    overrides = {k: v for k, v in (("dataset_name", args.dataset_name),
                                   ("synthetic_size", args.synthetic_size))
                 if v is not None}
    print(json.dumps(profile(args.config, args.device, Path(args.out),
                             args.model_type, overrides)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
