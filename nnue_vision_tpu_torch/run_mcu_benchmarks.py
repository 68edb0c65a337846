"""Run MCU simulation + TinyML benchmarks on a trained checkpoint (the
port's counterpart of `scripts/run_mcu_benchmarks.py`).

    python -m nnue_vision_tpu_torch.run_mcu_benchmarks [--checkpoint CKPT] \\
        [--dataset cifar10] [--max-samples 100] [--batch-size 16] \\
        [--target-sparsity 0.5] [--visual-wake-words] \\
        [--output-dir benchmark_results] [--plots] [--device cuda] \\
        [--grid-size 10 ... --input-size 32]

Loads a checkpoint (this package's, the JAX package's or an upstream
torch file, through `serialize.load_checkpoint_auto`) into the model
facade on `--device` (the card unless the caller names another; without
CUDA that raises), or builds a fresh NNUE from the architecture flags;
with `--visual-wake-words` remaps the test split to person/no-person
(airplane as the proxy class) and gives a fresh model two classes. Runs
the MCU benchmark across the Cortex-M targets and the TinyML report over
the test split (its accuracy from the float forward on the device), and
writes `mcu_benchmark.json` and `tinyml_report.json` (and, with
`--plots` and matplotlib, `pareto.png`) under `--output-dir`.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from pathlib import Path
from typing import Optional

from nnue_vision_tpu_torch.bridge import etinynet_to_numpy, nnue_to_numpy
from nnue_vision_tpu_torch.models.api import NNUE, EtinyNet
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MCU/TinyML benchmark runner")
    parser.add_argument("--checkpoint", type=str, help="trained checkpoint (.ckpt)")
    parser.add_argument("--dataset", default="cifar10")
    parser.add_argument("--max-samples", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--target-sparsity", type=float, default=0.5)
    parser.add_argument("--visual-wake-words", action="store_true",
                        help="binary person/no-person remap (airplane proxy class)")
    parser.add_argument("--output-dir", type=Path, default=Path("benchmark_results"))
    parser.add_argument("--plots", action="store_true",
                        help="write Pareto plots (requires matplotlib)")
    # fresh-model architecture knobs
    parser.add_argument("--grid-size", type=int, default=10)
    parser.add_argument("--features-per-square", type=int, default=8)
    parser.add_argument("--l1-size", type=int, default=1024)
    parser.add_argument("--l2-size", type=int, default=128)
    parser.add_argument("--l3-size", type=int, default=32)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--input-size", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the card)")
    return parser


def parse_arguments(argv=None):
    """Standalone arg parsing (upstream script surface)."""
    return _build_parser().parse_args(argv)


def load_model(args):
    """The facade of `args.checkpoint` on `args.device`, or a fresh NNUE
    from the architecture flags."""
    device = getattr(args, "device", "cuda")
    if args.checkpoint:
        from nnue_vision_tpu_torch.serialize import load_checkpoint_auto

        model_type, module, cfg = load_checkpoint_auto(Path(args.checkpoint),
                                                       device=device)
        if model_type != "nnue":
            params, batch_stats = etinynet_to_numpy(module)
            return EtinyNet(variant=cfg.variant, num_classes=cfg.num_classes,
                            input_size=cfg.input_size, params=params,
                            batch_stats=batch_stats, device=device)
        return NNUE(feature_set=cfg.feature_set, l1_size=cfg.l1_size,
                    l2_size=cfg.l2_size, l3_size=cfg.l3_size,
                    num_classes=cfg.num_classes, input_size=cfg.input_size,
                    params=nnue_to_numpy(module), device=device)
    return NNUE(
        feature_set=GridFeatureSet(args.grid_size, args.features_per_square),
        l1_size=args.l1_size, l2_size=args.l2_size, l3_size=args.l3_size,
        num_classes=2 if args.visual_wake_words else args.num_classes,
        input_size=args.input_size, device=device,
    )


def _plot(report: dict, output_dir: Path) -> None:
    try:
        import matplotlib
    except ImportError:
        print("matplotlib not available; skipping plots")
        return
    from nnue_vision_tpu_torch.benchmarks import create_pareto_plot_data

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = create_pareto_plot_data(report["mlperf_results"])
    fig, ax = plt.subplots(figsize=(7, 5))
    for pt in data["nnue_models"]:
        ax.scatter(pt["x"], pt["y"], c="tab:blue", label="NNUE-Vision")
        ax.annotate(pt["name"], (pt["x"], pt["y"]), fontsize=7)
    for pt in data["baseline_models"]:
        ax.scatter(pt["x"], pt["y"], c="tab:red", marker="x")
        ax.annotate(pt["name"], (pt["x"], pt["y"]), fontsize=7)
    ax.set_xlabel("latency (ms)")
    ax.set_ylabel("accuracy")
    ax.set_xscale("log")
    fig.savefig(output_dir / "pareto.png", dpi=150)
    print(f"Pareto plot → {output_dir / 'pareto.png'}")


def main(argv: Optional[list] = None) -> int:
    args = parse_arguments(argv)

    from nnue_vision_tpu_torch.benchmarks import (
        MCU_SPECS,
        generate_tinyml_report,
        run_mcu_benchmark,
    )
    from nnue_vision_tpu_torch.data.loaders import create_data_loaders

    binary = (
        {"positive_classes": ["airplane"]} if args.visual_wake_words else None
    )
    _, _, test_loader = create_data_loaders(
        dataset_name=args.dataset,
        batch_size=args.batch_size,
        max_samples_per_split=args.max_samples,
        use_augmentation=False,
        binary_classification=binary,
    )

    model = load_model(args)
    print(f"Model: {model.count_parameters():,} parameters")

    results = run_mcu_benchmark(
        model=model,
        data_loader=test_loader,
        mcu_specs=list(MCU_SPECS.values()),
        target_sparsity=args.target_sparsity,
        verbose=True,
    )

    args.output_dir.mkdir(parents=True, exist_ok=True)
    mcu_path = args.output_dir / "mcu_benchmark.json"
    with open(mcu_path, "w") as f:
        json.dump(
            {"model_stats": asdict(results["model_stats"]),
             "mcu_results": results["mcu_results"]},
            f, indent=2, default=str,
        )
    print(f"MCU results → {mcu_path}")

    report_path = args.output_dir / "tinyml_report.json"
    report = generate_tinyml_report(
        model=model,
        dataset_name="visual_wake_words" if args.visual_wake_words else args.dataset,
        data_loader=test_loader,
        mcu_specs=list(MCU_SPECS.values()),
        output_path=report_path,
    )
    print(f"TinyML report → {report_path} "
          f"(best: {report['summary']['best_platform']}, "
          f"{report['summary']['best_latency_ms']:.2f} ms)")

    if args.plots:
        _plot(report, args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
