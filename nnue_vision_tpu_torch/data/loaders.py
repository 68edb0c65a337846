"""Batch loaders over in-memory datasets (port of
`nnue_vision_tpu/data/loaders.py:24-130`).

Val and test both read the test split (the train loop augments train
batches only); train shuffles (numpy `default_rng(seed + epoch)`, the JAX package's order)
and drops the last partial batch, val and test keep it. Batches are numpy;
the train loop gathers them on the device by index.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset


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
    max_samples_per_split: Optional[int] = None,
    subset: float = 1.0,
    seed: int = 0,
    synthetic_size: int = 512,
    synthetic_class_seed: Optional[int] = None,
) -> Tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    """Returns (train_loader, val_loader, test_loader)."""
    common = dict(
        dataset_name=dataset_name,
        max_samples=max_samples_per_split,
        subset=subset,
        synthetic_size=synthetic_size,
        seed=seed,
        synthetic_class_seed=synthetic_class_seed,
    )
    train_ds = GenericVisionDataset(split="train", **common)
    val_ds = GenericVisionDataset(split="test", **common)
    test_ds = GenericVisionDataset(split="test", **common)
    return (
        ArrayLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=seed),
        ArrayLoader(val_ds, batch_size),
        ArrayLoader(test_ds, batch_size),
    )
