"""Train a scaled NNUE whose step is compute-bound: images/s and MFU.

    python -m nnue_vision_tpu_torch.profile_scaled_train [--batch 2048]
        [--spd 8] [--dispatches 8] [--n-data 8192] [--device cuda]

Port of `scripts/profile_scaled_train.py`: grid 20×20×8 (3,200 features),
L1 4096, L2 128, L3 32, 10 classes, 77×77 inputs (stride 4, an exact
20×20 conv output), `nnue_init` with torch generator seed 0, SGD at a
constant LR 0.01 (momentum 0.9, weight decay 2e-4, clip 1), on
`--n-data` numpy-random 77×77 images (seed 0; 583 MB at 8192) through
`prepare_gather_dataset`. The step is the loop's fused one:
`scanned_train_steps_fused(height=77, width=77)` (K3 for the whole input
path, then forward, backward, SGD and the weight clip), `--spd` steps a
chunk as one CUDA graph on a card; the first chunk (eager: the kernels'
build, cuDNN's and cuBLAS's choices) is `compile_s`, the second captures
the graph, then `--dispatches` chunks are timed on the host clock with
one sync at the end.

MFU is images/s × 3 × `fwd_flops_per_image` (2 FLOPs per multiply-add of
the conv and the matmuls; the backward counted as twice the forward) over
the card's float32 rate, 67 TFLOP/s: the step computes in float32 with
TF32 off (`mfu_peak` names it). Prints one JSON object with the card's
name and power limit (null on the CPU, whose host-clock numbers are for
the tests only: its MFU is null).
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    count_parameters,
    nnue_init,
)
from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
from nnue_vision_tpu_torch.ops.timing import F32_FLOPS_PER_S, card
from nnue_vision_tpu_torch.profile_train_roofline import (
    fwd_flops_per_image,
    train_data,
)
from nnue_vision_tpu_torch.profile_train_sweep import chunk_rate
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    make_train_state,
    scanned_train_steps_fused,
)

SCALED = NNUEConfig(
    feature_set=GridFeatureSet(grid_size=20, num_features_per_square=8),
    l1_size=4096, l2_size=128, l3_size=32, num_classes=10, input_size=77,
)
# the JAX probe's OptCfg: a constant LR
OPT = SimpleNamespace(learning_rate=0.01, weight_decay=2e-4, momentum=0.9,
                      optimizer_type="sgd", max_grad_norm=1.0,
                      use_cosine_scheduler=False, max_epochs=10, decay_lr=False,
                      use_cyclical_lr=False)


def run(batch: int = 2048, spd: int = 8, dispatches: int = 8,
        n_data: int = 8192, device="cuda", model_cfg: NNUEConfig = SCALED) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    if model_cfg.conv_out_hw != model_cfg.feature_set.grid_size:
        raise ValueError(f"the conv output {model_cfg.conv_out_hw} is not the "
                         f"grid {model_cfg.feature_set.grid_size}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw = model_cfg.input_size
    optimizer = create_optimizer(OPT, spd)
    model = nnue_init(model_cfg, torch.Generator().manual_seed(0), device=dev)
    state = make_train_state(model, optimizer)
    images, labels = train_data(n_data, hw, hw, dev)
    gather_ds = prepare_gather_dataset(images)
    del images
    gen = torch.Generator().manual_seed(1)
    rng = torch.Generator().manual_seed(2)

    def chunk():
        idx = torch.randint(0, n_data, (spd, batch), generator=rng).numpy()
        return scanned_train_steps_fused(state, gather_ds, labels, idx, gen,
                                         optimizer=optimizer, height=hw,
                                         width=hw)

    rate = chunk_rate(chunk, dispatches, spd * batch, dev)
    fwd = fwd_flops_per_image(model_cfg)
    mfu = rate["images_per_sec"] * 3.0 * fwd / F32_FLOPS_PER_S
    if mfu >= 1.0 and dev.type == "cuda":
        raise RuntimeError(f"impossible MFU {mfu}")
    g = model_cfg.feature_set
    return {
        "config": f"grid{g.grid_size}x{g.grid_size}x{g.num_features_per_square}"
                  f"_L1-{model_cfg.l1_size}_input{hw}",
        "params": count_parameters(model), "batch": batch,
        "steps_per_dispatch": spd, "dispatches": dispatches,
        "train_images_per_sec": rate["images_per_sec"],
        "ms_per_step": rate["ms_per_step"],
        "train_mfu": mfu if dev.type == "cuda" else None,
        "mfu_peak": "float32, 67e12 FLOP/s (TF32 off)",
        "fwd_flops_per_image": fwd,
        "step_flops_bound_ms": batch * 3.0 * fwd / F32_FLOPS_PER_S * 1e3,
        "compile_s": rate["first_chunk_s"], "capture_s": rate["second_chunk_s"],
        "peak_gb": rate["peak_gb"], "final_loss": rate["final_loss"],
        "device": str(dev), "card": card(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--spd", type=int, default=8, help="steps per chunk")
    parser.add_argument("--dispatches", type=int, default=8)
    parser.add_argument("--n-data", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print("MEASURED: " + json.dumps(run(args.batch, args.spd, args.dispatches,
                                        args.n_data, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
