"""Dataset inspector CLI: print a dataset split's statistics (port of
`nnue_vision_tpu/data/dataset_inspector.py`, over the port's registry).

    python -m nnue_vision_tpu_torch.data.dataset_inspector imagenet
    python -m nnue_vision_tpu_torch.data.dataset_inspector cifar10 --split test

A dataset that is not on disk is inspected on its synthetic fallback (the
report says so under `synthetic`).
"""

from __future__ import annotations

import argparse

from nnue_vision_tpu_torch.data.datasets import (
    AVAILABLE_DATASETS,
    GenericVisionDataset,
    get_dataset_info,
)


def inspect_dataset(dataset_name: str, split: str = "train",
                    max_samples: int = 256) -> dict:
    """The split's shape, value range, per-channel mean and std, and class
    distribution over its first `max_samples` samples."""
    info = get_dataset_info(dataset_name)
    ds = GenericVisionDataset(
        dataset_name=dataset_name, split=split, max_samples=max_samples
    )
    images, labels = ds.images, ds.labels
    return {
        "dataset": info["name"],
        "split": split,
        "synthetic": ds.is_synthetic,
        "num_samples": len(ds),
        "image_shape": tuple(images.shape[1:]),
        "value_range": (float(images.min()), float(images.max())),
        "mean_per_channel": images.mean(axis=(0, 1, 2)).tolist(),
        "std_per_channel": images.std(axis=(0, 1, 2)).tolist(),
        "num_classes": ds.num_classes,
        "class_distribution": ds.get_class_distribution(),
        "label_range": (int(labels.min()), int(labels.max())) if len(labels) else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Inspect a dataset")
    parser.add_argument("dataset", nargs="?", default="cifar10",
                        choices=list(AVAILABLE_DATASETS.keys()))
    parser.add_argument("--split", default="train")
    parser.add_argument("--max-samples", type=int, default=256)
    args = parser.parse_args(argv)

    report = inspect_dataset(args.dataset, args.split, args.max_samples)
    print(f"=== {report['dataset']} ({report['split']}) ===")
    for key, value in report.items():
        if key == "class_distribution":
            print("class distribution:")
            for name, count in sorted(value.items()):
                print(f"  {name:>16}: {count}")
        else:
            print(f"{key:>18}: {value}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
