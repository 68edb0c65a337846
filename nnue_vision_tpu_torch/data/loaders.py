"""Batch loaders over in-memory datasets (port of
`nnue_vision_tpu/data/loaders.py:24-169`).

Val and test both read the test split, never augmented (the train loop
augments train batches only); train shuffles (numpy
`default_rng(seed + epoch)`, the JAX package's order, so every rank of a
data-parallel run draws the same global batches and keeps its rows) and
drops the last partial batch, val and test keep it. The JAX package builds the test split
twice; here the val and test loaders share one dataset, the same arrays.
Batches are numpy; the train loop gathers them on the device by index.
`get_dataset_stats` and `calculate_dataset_statistics` describe a dataset
and one batch of a loader.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from nnue_vision_tpu_torch.data.datasets import (
    GenericVisionDataset,
    get_dataset_info,
)


class ArrayLoader:
    """Iterates (images, labels) numpy batches over a dataset. `epoch`
    counts the shuffled orders drawn so far (a resumed run restores it)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def iter_indices(self) -> Iterator[np.ndarray]:
        """Per-batch index arrays; a shuffling loader draws a new order per
        call, from `default_rng(seed + epoch)`."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for idx in self.iter_indices():
            yield self.dataset.images[idx], self.dataset.labels[idx]


class _HeadSubset:
    """First-n view of a dataset (synthetic splits come in random label
    order, so the head is an unbiased sample)."""

    def __init__(self, dataset, n: int):
        self.images = dataset.images[:n]
        self.labels = dataset.labels[:n]
        self.is_synthetic = getattr(dataset, "is_synthetic", False)
        self.class_names = getattr(dataset, "class_names", None)

    def __len__(self) -> int:
        return len(self.labels)


def head_subset_loader(loader: ArrayLoader, n: int,
                       batch_size: Optional[int] = None) -> ArrayLoader:
    """A no-shuffle loader over the first n samples of `loader`'s dataset."""
    return ArrayLoader(
        _HeadSubset(loader.dataset, n), batch_size or loader.batch_size
    )


def create_data_loaders(
    dataset_name: str = "cifar10",
    batch_size: int = 32,
    target_size: Optional[Tuple[int, int]] = None,
    max_samples_per_split: Optional[int] = None,
    subset: float = 1.0,
    data_root: Optional[str] = None,
    binary_classification: Optional[dict] = None,
    use_augmentation: bool = True,
    augmentation_strength: str = "medium",
    seed: int = 0,
    synthetic_fallback: bool = True,
    synthetic_size: int = 512,
    synthetic_class_seed: Optional[int] = None,
) -> Tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    """Returns (train_loader, val_loader, test_loader)."""
    common = dict(
        dataset_name=dataset_name,
        target_size=target_size,
        max_samples=max_samples_per_split,
        subset=subset,
        data_root=data_root,
        binary_classification=binary_classification,
        augmentation_strength=augmentation_strength,
        synthetic_fallback=synthetic_fallback,
        synthetic_size=synthetic_size,
        seed=seed,
        synthetic_class_seed=synthetic_class_seed,
    )
    train_ds = GenericVisionDataset(
        split="train", use_augmentation=use_augmentation, **common)
    test_ds = GenericVisionDataset(split="test", use_augmentation=False, **common)
    return (
        ArrayLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=seed),
        ArrayLoader(test_ds, batch_size),
        ArrayLoader(test_ds, batch_size),
    )


def get_dataset_stats(dataset_name: str = "cifar10") -> Dict[str, Any]:
    """A dataset's facts from the registry."""
    info = get_dataset_info(dataset_name)
    return {
        "name": info["name"],
        "description": f"{info['name']} dataset for computer vision",
        "num_classes": info["num_classes"],
        "class_names": info["classes"],
        "task": f"{info['num_classes']}-class classification",
        "input_type": "RGB images",
        "input_size": info["input_size"],
        "channels": info["channels"],
        "data_source": "disk (CIFAR pickle / ImageFolder) or synthetic",
    }


def calculate_dataset_statistics(loader: ArrayLoader) -> Dict[str, Any]:
    """Statistics of the loader's first batch."""
    images, labels = next(iter(loader))
    uniques, counts = np.unique(labels, return_counts=True)
    class_names = getattr(loader.dataset, "class_names", None)
    dist = {
        (class_names[int(u)] if class_names else f"class_{int(u)}"): int(c)
        for u, c in zip(uniques, counts)
    }
    return {
        "batch_size": images.shape[0],
        "image_shape": tuple(images.shape[1:]),
        "image_dtype": str(images.dtype),
        "label_dtype": str(labels.dtype),
        "image_mean_per_channel": images.mean(axis=(0, 1, 2)).tolist(),
        "image_std_per_channel": images.std(axis=(0, 1, 2)).tolist(),
        "image_min": float(images.min()),
        "image_max": float(images.max()),
        "unique_labels": uniques.tolist(),
        "label_distribution": dist,
        "total_samples_in_batch": int(labels.size),
    }
