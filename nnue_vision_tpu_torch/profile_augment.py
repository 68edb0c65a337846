"""Time the augmentation tiers' kernels and the EtinyNet train step.

    python -m nnue_vision_tpu_torch.profile_augment [--batches 1024 8192]
        [--no_train] [--out PATH]

For the light pipeline (K3, `fused_light_pipeline`: the batch's images as
the dataset, gathered in a shuffled order with the light tier's flips,
brightness/contrast and holes), the warp (K4, `warp_bilinear`), its single
pass (`lerp_pass`), the no-gather control (K8, `nogather_pass`) and the
photometric block (K5, `photometric_block`, both variants), at each batch
of 32×32×3 images (torch seed 0, the heavy tier's draws):

  event_ms   one call between two CUDA events, median of 100 (host launch
             cost included, as a step pays it)
  graph_ms   `ops/timing.chained_best_ms`: 50 calls in one CUDA graph,
             best of 3 replays (no host cost)
  host_ms    the host clock over 200 calls in a row with no sync inside,
             per call: what the wrapper costs the host
  bound_ms   the inputs read once and the output written once over the
             card's 3.35 TB/s (each is bound by bytes; K5's noise counts
             only for the images whose noise gate is on)

beside `grid_sample`, the PyTorch call that computes the single pass
(event_ms, graph_ms and host_ms), and then ms per EtinyNet train step
(`config/train_etinynet.py`: 0.98M, bf16, heavy tier, batch 1024) over two
runs of 48 steps on 20,000 synthetic-hard images, host clock with one sync
at the end. Prints one JSON object with the card's name and power limit.

The script uses only entry points that the port has had since its
profiling path landed, so the same file can time an older checkout of the
package: put that checkout first on PYTHONPATH and run the file by path.
At batch 1024 the 12.6 MB batch stays in the card's 50 MB L2 between graph
reps; at 8192 (100.7 MB) it does not.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops import warp_kernel as wk
from nnue_vision_tpu_torch.ops.timing import HBM_BYTES_PER_S, card, chained_best_ms, nbytes

H = W = 32
EVENT_RUNS = 100  # the host's spread is wide: many runs for a steady median
GRAPH_REPS = 50
HOST_CALLS = 200
TRAIN_CONFIG = "config/train_etinynet.py"
TRAIN_IMAGES = 20000
TRAIN_STEPS = 48


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(EVENT_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """The host clock over `calls` calls in a row with no sync inside, per
    call (keep calls × launches per call within the launch queue, ~1,000)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def grid_sample_pass(images: torch.Tensor, coef: torch.Tensor):
    """`grid_sample` on the rows as a (B, C, R, N) image, its grid holding
    the single pass's positions: the same pass as `lerp_pass`."""
    rows = torch.arange(H, device=images.device, dtype=torch.float32)[None, :, None]
    cols = torch.arange(W, device=images.device, dtype=torch.float32)[None, None, :]
    pos = (coef[:, 0, None, None] * rows + coef[:, 1, None, None] * cols
           + coef[:, 2, None, None])
    grid = torch.stack([pos * (2.0 / (W - 1)) - 1.0,
                        (rows * (2.0 / (H - 1)) - 1.0).expand_as(pos)], dim=-1)
    src = images.permute(0, 3, 1, 2)
    return lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def kernel_calls(batch: int, device):
    """{name: (call, its inputs)} for the bulk-copy kernels at `batch`, and the
    images, the noise and the single pass's rows and coefficients."""
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((batch, H, W, 3), generator=gen).to(device)
    noise = torch.randn((batch, H, W, 3), generator=gen).to(device)
    draws = aug.draw_tier(gen, "heavy", batch, H, W, device)
    packed = images.reshape(batch, H, W * 3)
    coef = draws.warp1[:, 1:4].contiguous()
    light = ip.draw_light_params(gen, 1, batch, H, W)
    order = torch.randperm(batch, generator=gen)
    light_args = (ip.prepare_gather_dataset(images),
                  (order + batch * light.flip[0]).to(torch.int32).to(device),
                  light.pf[0].to(device), light.pi[0].to(device))
    calls = {
        "light_pipeline_kernel": (
            lambda: ip.fused_light_pipeline(*light_args, h=H, w=W), light_args),
        "warp_kernel": (lambda: wk.warp_bilinear(images, draws.warp1),
                        (images, draws.warp1)),
        "lerp_pass_kernel": (lambda: wk.lerp_pass(packed, coef, n=W, c=3),
                             (packed, coef)),
        "nogather_pass_kernel": (lambda: wk.nogather_pass(packed, coef, n=W, c=3),
                                 (packed, coef)),
        "photometric_kernel medium": (
            lambda: pk.photometric_block(images, noise, *draws.photo1,
                                         variant="medium"),
            (images, noise, *draws.photo1)),
        "photometric_kernel heavy_extra": (
            lambda: pk.photometric_block(images, noise, *draws.photo2,
                                         variant="heavy_extra"),
            (images, noise, *draws.photo2)),
    }
    return calls, images, noise, packed, coef


def kernel_rows(batch: int, device) -> dict:
    calls, images, noise, packed, coef = kernel_calls(batch, device)
    rows = {}
    for name, (fn, inputs) in calls.items():
        moved = nbytes(*inputs) + nbytes(images)  # inputs once, output once
        if name.startswith("photometric"):
            # the noise is read only for the images whose gate 8 is on
            fparams = inputs[2]
            moved -= int(nbytes(noise) * float((fparams[:, 8] <= 0.5).float().mean()))
        rows[name] = {
            "event_ms": event_ms(fn), "graph_ms": chained_best_ms(fn, GRAPH_REPS),
            "host_ms": host_ms(fn), "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        }
    sample = grid_sample_pass(images, coef)
    if not torch.allclose(sample().permute(0, 2, 3, 1).reshape(packed.shape),
                          wk.lerp_pass(packed, coef, n=W, c=3), atol=1e-4):
        raise RuntimeError("grid_sample does not compute the single pass")
    rows["grid_sample"] = {"event_ms": event_ms(sample),
                           "graph_ms": chained_best_ms(sample, GRAPH_REPS),
                           "host_ms": host_ms(sample)}
    return rows


def train_step_ms(device, steps: int = TRAIN_STEPS) -> list:
    from config import load_config
    from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset
    from nnue_vision_tpu_torch.training.loop import build_model
    from nnue_vision_tpu_torch.training.optim import create_optimizer
    from nnue_vision_tpu_torch.training.step import gathered_train_step, make_train_state

    cfg = load_config(TRAIN_CONFIG)
    model, _ = build_model(cfg, "etinynet", torch.Generator().manual_seed(0), device)
    opt = create_optimizer(cfg, TRAIN_STEPS)
    state = make_train_state(model.train(), opt)
    ds = GenericVisionDataset("synthetic-hard", split="train",
                              synthetic_size=TRAIN_IMAGES, seed=42)
    images = torch.from_numpy(ds.images).to(device)
    labels = torch.from_numpy(ds.labels).to(device)
    gen = torch.Generator().manual_seed(1)
    noise_gen = aug.device_generator(gen, device)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        idx = rng.integers(0, len(ds.labels), (steps, cfg.batch_size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = torch.stack([
            gathered_train_step(state, images, labels, i, gen, optimizer=opt,
                                strength="heavy", noise_gen=noise_gen)["loss"]
            for i in idx])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
        if not bool(torch.isfinite(losses).all()):
            raise RuntimeError("non-finite losses in the timed steps")
    return out


def run(batches, device="cuda", train: bool = True) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_augment times a CUDA card; none is available")
    result = {"card": card(dev), "batches": {}}
    for batch in batches:
        result["batches"][str(batch)] = kernel_rows(batch, dev)
    if train:
        result["train_step_ms"] = train_step_ms(dev)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 8192])
    ap.add_argument("--no_train", action="store_true")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.batches, train=not args.no_train)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
