"""Streaming (video) NNUE inference: chess-style incremental accumulator
updates, batched (port of `scripts/stream_inference_demo.py`).

    python -m nnue_vision_tpu_torch.stream_inference_demo [--frames 64] \\
        [--batch 256] [--device cuda]

A synthetic pan (per stream a static scene from `numpy.random.default_rng(0)`,
a bright 8×8 patch moving one pixel right and three down per frame,
wrapping) runs through a flagship-width NNUE (`GridFeatureSet(10, 8)`, L1
1024, L2 128, L3 32, 10 classes; `nnue_init` from
`torch.Generator().manual_seed(0)`, quantized as for a `.nnue`) two ways,
and every frame's logits must be bit-equal:

  1. full forward  - conv → threshold → FT refresh → head (the sim);
  2. incremental   - conv → threshold → accumulator += Δmask @ FT → head.

Then each is timed over the frame loop after a warm-up, with CUDA events
on the card (the host clock elsewhere), in ms per frame; on the card also
the full forward through the int8 mega kernel (K1). The Δmask product is
a dense matmul, as in the JAX package, so incrementality buys little
device time; the C++ engine's incremental path is where it pays
(engine/build/benchmark_engine prints INCREMENTAL_SPEEDUP). Runs on the
card unless `--device` names another; exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
    nnue_quantize,
)
from nnue_vision_tpu_torch.ops.engine_sim import (
    nnue_accumulator_refresh,
    nnue_accumulator_update,
    nnue_engine_forward,
    nnue_feature_mask,
    nnue_head_from_accumulator,
    nnue_sim_params,
    resolve_device,
)
from nnue_vision_tpu_torch.ops.nnue_kernels import (
    mega_head_params,
    nnue_engine_forward_mega,
)

SIZE = 32
CONFIG = NNUEConfig(feature_set=GridFeatureSet(10, 8), l1_size=1024,
                    l2_size=128, l3_size=32, num_classes=10, input_size=SIZE)


def pan_frames(frames: int, batch: int) -> np.ndarray:
    """(frames, batch, 32, 32, 3) float32 in [0, 1]: per-stream static
    scenes with a bright 8×8 patch that strides across them."""
    rng = np.random.default_rng(0)
    scenes = rng.random((batch, SIZE, SIZE, 3), dtype=np.float32) * 0.4
    out = np.empty((frames,) + scenes.shape, np.float32)
    for t in range(frames):
        f = scenes.copy()
        x0, y0 = t % 24, (t * 3) % 24
        f[:, y0:y0 + 8, x0:x0 + 8, :] += 0.6
        out[t] = np.clip(f, 0.0, 1.0)
    return out


def full_logits(params, cfg, frame: torch.Tensor) -> torch.Tensor:
    return nnue_engine_forward(params, frame, cfg=cfg, image_h=SIZE,
                               image_w=SIZE)[0]


def incremental_logits(params, cfg, frames: torch.Tensor):
    """Yields each frame's logits after the first, through the accumulator
    updated from the previous frame's mask."""
    kw = dict(cfg=cfg, image_h=SIZE, image_w=SIZE)
    mask = nnue_feature_mask(params, frames[0], **kw)
    acc = nnue_accumulator_refresh(params, mask)
    for frame in frames[1:]:
        new_mask = nnue_feature_mask(params, frame, **kw)
        acc = nnue_accumulator_update(params, acc, new_mask, mask)
        mask = new_mask
        yield nnue_head_from_accumulator(params, acc, cfg=cfg)


def ms_per_frame(run: Callable[[], None], frames: int,
                 device: torch.device) -> float:
    """One warm-up, then one timed run of the frame loop: CUDA events on
    the card, the host clock elsewhere."""
    run()
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) / frames * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / frames


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256, help="parallel streams")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = nnue_init(CONFIG, torch.Generator().manual_seed(0), device=device)
    params, cfg = nnue_sim_params(nnue_quantize(model), device=device)
    frames = torch.from_numpy(pan_frames(args.frames, args.batch)).to(device)

    # correctness: incremental == full forward, every frame, bit-exact
    mismatches = sum(
        not torch.equal(inc, full_logits(params, cfg, frame))
        for inc, frame in zip(incremental_logits(params, cfg, frames), frames[1:]))
    print(f"bit-exactness: {args.frames - 1} frames × {args.batch} streams, "
          f"{mismatches} mismatches")
    if mismatches:
        return 1

    runs = {
        "full forward": lambda: [full_logits(params, cfg, f) for f in frames],
        "incremental ": lambda: list(incremental_logits(params, cfg, frames)),
    }
    if device.type == "cuda":
        head = mega_head_params(params, cfg, SIZE, SIZE)
        flat = frames.reshape(args.frames, args.batch, -1)
        runs["full forward, K1"] = lambda: [nnue_engine_forward_mega(
            head, f, cfg=cfg, image_h=SIZE, image_w=SIZE) for f in flat]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    for tag, run in runs.items():
        ms = ms_per_frame(run, args.frames, device)
        print(f"{where} {tag}: {ms:.3f} ms/frame "
              f"({args.batch / ms * 1e3:,.0f} stream-frames/s)")
    print("(C++ engine incremental speedup on the same model: run "
          "engine/build/benchmark_engine — INCREMENTAL_SPEEDUP line)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
