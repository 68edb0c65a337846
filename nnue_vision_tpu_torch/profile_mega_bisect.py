"""Split the mega kernel's time by stage: cut it after each one and time it.

    python -m nnue_vision_tpu_torch.profile_mega_bisect [--batch 8192]
        [--reps 400] [--device cuda]

Port of `scripts/profile_mega_bisect.py`. The variants, at the flagship
widths of `config/train_nnue.py` (800 features, L1 1024, L2 128, L3 32, 10
classes, 32×32 images) with weights from `nnue_init` (torch generator, seed
0) through `nnue_quantize`:

  v0_dma    stage the images in shared memory, write 128 values of each
  v1_quant  the same, writing trunc(x·64) of those 128 values
  v2_conv   + the 3×3 strided conv (each tap quantized as it is read), its
            epilogue and the threshold compare: the tile's 0/1 mask
  v3_ft     + the FT product on the tensor cores (padding sum, int16 wrap,
            clip) and the pairwise layer
  v4_full   the serving kernel, `nnue_engine_forward_mega(with_count=False)`

v0–v3 are `nnue_mega_stage` (cut instantiations of the serving kernel's
template), so the deltas split the time of the kernel that serves: image
read, conv and mask, FT, and fc1, fc2 and the output layer. The inputs
are four buffers of `normalize_images` of numpy-random images (seed 0),
cycled through by the reps so that each rep reads its images from device
memory; being normalized, every |trunc(x·64)| ≤ 256, as the JAX probe's
bf16 cast needs.

Each variant is timed by `ops/timing.py`: a CUDA graph of `--reps` calls,
best of 3 replays. The JAX probe's `v4_full_buffergather_ms` is left out:
it measured a copy of the input that XLA made for its harness on the TPU,
and the card's harness makes none.

Prints one JSON object: each `*_ms`, `*_images_per_sec` and `*_bound_ms`
(the bytes the variant must move, each input read once and each output
written once, over the card's 3.35 TB/s: at every level its operations
take less time), the mean count of active features per image (the FT
reads that many rows of its table), the batch, and the card's name and
power limit from
nvidia-smi (null on the CPU, whose host-clock times are for the tests
only).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
    nnue_quantize,
)
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops.engine_sim import nnue_sim_params
from nnue_vision_tpu_torch.ops.timing import (
    bytes_bound_ms,
    card,
    chained_best_ms,
)

FLAGSHIP = NNUEConfig(  # config/train_nnue.py
    feature_set=GridFeatureSet(grid_size=10, num_features_per_square=8),
    l1_size=1024, l2_size=128, l3_size=32, num_classes=10, input_size=32,
)
H = W = 32
N_BUF = 4
VARIANTS = ("v0_dma", "v1_quant", "v2_conv", "v3_ft", "v4_full")


def flagship_head(device, seed: int = 0):
    """(mega head params, sim cfg) of the flagship at `nnue_init` weights."""
    model = nnue_init(FLAGSHIP, torch.Generator().manual_seed(seed),
                      device=device)
    sim, cfg = nnue_sim_params(nnue_quantize(model), device=device)
    return nk.mega_head_params(sim, cfg, H, W), cfg


def input_buffers(batch: int, device, seed: int = 0) -> torch.Tensor:
    """(N_BUF, batch, H·W·3) normalized float32 images."""
    raw = np.random.default_rng(seed).random((N_BUF, batch, H, W, 3),
                                             dtype=np.float32)
    x = normalize_images(torch.from_numpy(raw).to(device))
    return x.reshape(N_BUF, batch, H * W * 3).contiguous()


def variant(level: int, head, cfg, data: torch.Tensor):
    """The call of variant `level`, cycling through the input buffers."""
    buffers = itertools.cycle(list(data))
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    if level < len(nk.STAGES):
        return lambda: nk.nnue_mega_stage(head, next(buffers), level=level,
                                          **kw)
    return lambda: nk.nnue_engine_forward_mega(head, next(buffers),
                                               with_count=False, **kw)[0]


def variant_bound_ms(level: int, head, data: torch.Tensor) -> float:
    """Bytes bound of variant `level` on one buffer: the images, the
    weights that level reads, and its output."""
    batch = data.shape[1]
    reads = [data[0]]
    if level >= 2:
        reads += [head["conv_w"], head["conv_b"]]
    if level >= 3:
        reads += [head["ft_w"], head["ft_b"], head["padsum"]]
    if level >= 4:
        reads += [head[k] for k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b",
                                    "out_w", "out_b")]
    cols = nk.STAGE_OUT if level < len(nk.STAGES) else FLAGSHIP.num_classes
    return bytes_bound_ms(*reads, torch.empty((batch, cols), device="meta"))


def run(batch: int = 8192, device="cuda", reps: int = 400) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    head, cfg = flagship_head(dev)
    data = input_buffers(batch, dev)
    count = nk.nnue_engine_forward_mega(head, data[0], cfg=cfg, image_h=H,
                                        image_w=W)[2]
    out = {"batch": batch, "device": str(dev), "card": card(dev), "reps": reps,
           # the FT sums this many rows of its table per image
           "active_features_per_image": float(count.double().mean())}
    for level, name in enumerate(VARIANTS):
        out[name + "_ms"] = chained_best_ms(variant(level, head, cfg, data),
                                            reps)
        out[name + "_bound_ms"] = variant_bound_ms(level, head, data)
    for name in VARIANTS:
        out[name + "_images_per_sec"] = batch / (out[name + "_ms"] / 1e3)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--reps", type=int, default=400,
                        help="calls per timed CUDA graph")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batch, args.device, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
