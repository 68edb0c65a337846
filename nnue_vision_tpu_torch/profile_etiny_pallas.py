"""Time the int8 EtinyNet path through K6 against the plain engine sim.

    python -m nnue_vision_tpu_torch.profile_etiny_pallas [BATCH] [VARIANT]
        [--device cuda]

Port of `scripts/profile_etiny_pallas.py`: the micro variant (the
reference's test and bench model) at 32×32, batch 2048, weights from
`etinynet_init` (torch generator, seed 2) through `etinynet_quantize`, on
four buffers of numpy standard-normal images (seed 0) cycled through by
the reps. Before timing, `etiny_forward_kernel` (K6, one launch per LB
block) must equal `etiny_engine_forward` bit for bit on the first buffer;
the probe raises otherwise.

The JAX probe ran both paths with a bf16 stem (`conv_mode="bf16"`) as a
timing configuration; the port's stem is exact for any input, so both
paths run it. Its `rows_target` sweep (4096, 16384, 32768 rows per Pallas
block) has no counterpart: K6 picks its tile per block from the batch and
the shared memory, so there is one K6 row, with the tile of each block
(`k6_tiles`, null on the CPU).

Each path is timed by `ops/timing.py`: a CUDA graph of 100 calls,
best of 3 replays. Prints one JSON object with ms per batch and images/s
of the sim (`xla_*`) and of K6 (`pallas_*`), the bound of the K6 path
(its 12 LB blocks' int8 inputs, weights and outputs moved once over the
card's 3.35 TB/s, or their multiply-adds at the dense int8 rate where that
takes longer), `bit_exact`, and the card's name and power limit (null on
the CPU, whose host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNetConfig,
    etinynet_init,
    etinynet_quantize,
)
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops.engine_sim import (
    EtinySimCfg,
    conv_out_hw,
    etiny_engine_forward,
    etiny_sim_params,
    etiny_stem,
)
from nnue_vision_tpu_torch.ops.timing import bound_ms, card, chained_best_ms, nbytes

H = W = 32
N_BUF = 4
NOTE = ("rows_target has no counterpart: K6 picks its tile per block (k6_tiles); "
        "both paths run the port's exact stem, not JAX's bf16 one")


def serve_model(variant: str, device, seed: int = 2):
    """(K6 params, sim cfg) of an EtinyNet `variant` (10 classes, 32×32) at
    `etinynet_init` weights (torch generator `seed`)."""
    model = etinynet_init(EtinyNetConfig(variant=variant, num_classes=10,
                                         input_size=H),
                          torch.Generator().manual_seed(seed), device=device)
    sim, cfg = etiny_sim_params(etinynet_quantize(model), device=device)
    return ek.etiny_kernel_params(sim, cfg), cfg


def input_buffers(batch: int, device, seed: int = 0) -> torch.Tensor:
    """(N_BUF, batch, H, W, 3) standard-normal float32 images."""
    x = np.random.default_rng(seed).standard_normal((N_BUF, batch, H, W, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def paths(kp: Dict, cfg: EtinySimCfg, data: torch.Tensor) -> Dict:
    """{"xla": the sim, "pallas": K6}, calls of no argument cycling through
    the buffers of `data`."""
    kw = dict(cfg=cfg, image_h=H, image_w=W)

    def cycle(fn):
        it = itertools.cycle(list(data))
        return lambda: fn(next(it))

    return {"xla": cycle(lambda x: etiny_engine_forward(kp, x, **kw)),
            "pallas": cycle(lambda x: ek.etiny_forward_kernel(kp, x, **kw))}


def block_shapes(kp: Dict, cfg: EtinySimCfg, x: torch.Tensor) -> List[tuple]:
    """Per LB block (B, h, w, in, mid, out, oh, ow) on images x."""
    b = x.shape[0]
    h, w = etiny_stem(kp, x[:1], cfg).shape[1:3]
    shapes = []
    for blk, bs in zip(kp["blocks"], cfg.blocks):
        oh, ow = conv_out_hw(h, w, bs.stride)
        if bs.is_dense:
            oh, ow = h, w
        shapes.append((b, h, w, blk["pw_expand_w"].shape[1],
                       blk["pw_expand_w"].shape[0], blk["pw_project_w"].shape[0],
                       oh, ow))
        h, w = oh, ow
    return shapes


def k6_bound(kp: Dict, shapes: List[tuple]) -> tuple:
    """The K6 blocks' bound: int8 inputs, weights and int8 outputs moved
    once; two operations per multiply-add of expand, depthwise, project."""
    moved, ops = 0, 0
    for blk, (b, h, w, cin, mid, cout, oh, ow) in zip(kp["blocks"], shapes):
        moved += b * h * w * cin + b * oh * ow * cout
        moved += nbytes(blk["pw_expand_w"], blk["be"], blk["dw"],
                        blk["pw_project_w"])
        ops += 2 * b * (h * w * mid * cin + oh * ow * mid * (9 + cout))
    return bound_ms(moved, int8_ops=ops)


def k6_tiles(shapes: List[tuple], device):
    """Each block's K6 tile as the launcher picks it (null on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    from nnue_vision_tpu_torch.ops._build import load_library

    lib = load_library().lib
    return [lib.etiny_block_tile(*s) for s in shapes]


def run(batch: int = 2048, variant: str = "micro", device="cuda",
        reps: int = 100) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    kp, cfg = serve_model(variant, dev)
    data = input_buffers(batch, dev)
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    if not torch.equal(ek.etiny_forward_kernel(kp, data[0], **kw),
                       etiny_engine_forward(kp, data[0], **kw)):
        raise RuntimeError("the K6 path diverged from the sim")
    shapes = block_shapes(kp, cfg, data[0])
    out = {"variant": variant, "batch": batch, "device": str(dev),
           "card": card(dev), "reps": reps, "k6_tiles": k6_tiles(shapes, dev),
           "note": NOTE}
    for name, fn in paths(kp, cfg, data).items():
        ms = chained_best_ms(fn, reps)
        out[name + "_images_per_sec"] = batch / (ms / 1e3)
        out[name + "_ms_per_batch"] = ms
    out["k6_blocks_bound_ms"], out["k6_blocks_bound_by"] = k6_bound(kp, shapes)
    out["bit_exact"] = True
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=2048)
    parser.add_argument("variant", nargs="?", default="micro")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batch, args.variant, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
