"""Evaluate a trained checkpoint: float, bit-exact int8 and, with
`--compiled`, the C++ engine (the port's counterpart of the repository's
root `evaluate.py`).

    python -m nnue_vision_tpu_torch.evaluate CHECKPOINT [--dataset cifar10] \\
        [--batch_size 128] [--max_samples N] [--compiled] [--seed 42] \\
        [--synthetic_size 512] [--device cuda]

The checkpoint (this package's, the JAX package's or an upstream torch
file) is loaded with `serialize.load_checkpoint_auto` on `--device` (the
card unless the caller names another; without CUDA that raises), and the
dataset's test split is built with the port's `create_data_loaders`
(`--seed` and `--synthetic_size` must match the training run's to score
its held-out split). Prints three lines: `float:` (loss and metrics of
`evaluate_model`), `int8-sim:` (`evaluate_int8_sim` on the plain sim, the
root CLI's default route) and, with `--compiled`, `engine:`
(`evaluate_compiled_model`, after building the engine's tools with
`training/engine_build.py`). The module also re-exports the evaluation
API, as the root file does.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

from nnue_vision_tpu_torch.training.evaluate import (  # noqa: F401
    evaluate_compiled_model,
    evaluate_int8_sim,
    evaluate_model,
    evaluate_model_comprehensive,
)
from nnue_vision_tpu_torch.training.metrics import compute_metrics  # noqa: F401


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate a trained checkpoint")
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("--dataset", default="cifar10")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--compiled", action="store_true",
                        help="also run the C++ engine evaluation")
    parser.add_argument("--seed", type=int, default=42,
                        help="dataset seed (must match the training run's "
                        "to evaluate on the same held-out split)")
    parser.add_argument("--synthetic_size", type=int, default=512,
                        help="synthetic train-split size; the test split is "
                        "size//4 (must match the training run's)")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the card)")
    args = parser.parse_args(argv)

    from nnue_vision_tpu_torch.data.loaders import create_data_loaders
    from nnue_vision_tpu_torch.serialize import load_checkpoint_auto

    model_type, model, _ = load_checkpoint_auto(args.checkpoint,
                                                device=args.device)
    _, _, test_loader = create_data_loaders(
        dataset_name=args.dataset,
        batch_size=args.batch_size,
        max_samples_per_split=args.max_samples,
        use_augmentation=False,
        seed=args.seed,
        synthetic_size=args.synthetic_size,
    )

    loss, metrics = evaluate_model(model, test_loader)
    print(f"float: loss={loss:.4f} " +
          " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    sim = evaluate_int8_sim(model, test_loader)
    print("int8-sim: " + " ".join(f"{k}={v:.4f}" for k, v in sim.items()))

    if args.compiled:
        from nnue_vision_tpu_torch.training.engine_build import compile_cpp_engine
        from nnue_vision_tpu_torch.training.evaluate import engine_executable

        if not engine_executable(model_type).exists():
            compile_cpp_engine(model_type)
        compiled = evaluate_compiled_model(model, test_loader)
        print("engine: " + " ".join(f"{k}={v:.4f}" for k, v in compiled.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
