"""Example benchmark walkthrough: build a model, run the MCU + TinyML
suite, print a summary (the port's counterpart of the root
`run_example_benchmark.py`: `main` + `create_example_model`).

    python -m nnue_vision_tpu_torch.run_example_benchmark [--device cuda]

The model lives on `--device` (the card unless the caller names another;
without CUDA that raises); its accuracy and sparsity come from the float
forward there, on the test split of `cifar10` (its synthetic stand-in
where the files are absent).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def create_example_model(device="cuda"):
    """A small NNUE suitable for MCU deployment exploration."""
    from nnue_vision_tpu_torch.models.api import NNUE
    from nnue_vision_tpu_torch.models.nnue import GridFeatureSet

    return NNUE(
        feature_set=GridFeatureSet(grid_size=8, num_features_per_square=8),
        l1_size=256, l2_size=32, l3_size=16, num_classes=10, input_size=32,
        device=device,
    )


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="MCU/TinyML example benchmark")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the card)")
    args = parser.parse_args(argv)

    from nnue_vision_tpu_torch.benchmarks import (
        MCU_SPECS,
        generate_tinyml_report,
        run_mcu_benchmark,
    )
    from nnue_vision_tpu_torch.data.loaders import create_data_loaders

    model = create_example_model(args.device)
    print(f"Example model: {model.count_parameters():,} parameters")

    _, _, test_loader = create_data_loaders(
        dataset_name="cifar10", batch_size=16, max_samples_per_split=64,
        use_augmentation=False,
    )

    results = run_mcu_benchmark(
        model=model, data_loader=test_loader,
        mcu_specs=list(MCU_SPECS.values()), target_sparsity=0.5, verbose=True,
    )
    stats = results["model_stats"]
    print(f"\nTotal MACs: {stats.total_macs:,} "
          f"(effective {stats.effective_macs:,} at "
          f"{stats.sparsity_ratio:.0%} sparsity)")
    print(f"Quantized size: {stats.quantized_model_size_bytes / 1024:.1f} KB "
          f"({stats.compression_ratio:.1f}x compression)")

    report = generate_tinyml_report(
        model=model, dataset_name="cifar10", data_loader=test_loader,
        mcu_specs=[MCU_SPECS["cortex_m4"]],
        output_path=None,
    )
    summary = report["summary"]
    print(f"\nBest platform: {summary['best_platform']} — "
          f"{summary['best_latency_ms']:.2f} ms, "
          f"{summary['best_throughput_fps']:.0f} fps, "
          f"{summary['best_energy_uj']:.1f} µJ/inference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
