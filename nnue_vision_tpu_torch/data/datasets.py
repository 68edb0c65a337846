"""Datasets: CIFAR-10/100 from disk and the synthetic generators.

Port of `nnue_vision_tpu/data/datasets.py` (numpy only, so it is copied
rather than imported: that package's `data/__init__` imports jax). The same
seeds give the same arrays: samples are NHWC float32 in [0, 1] at 32×32,
labels int64, and augmentation and normalization happen on the device.

Unlike the JAX package, the port never downloads: a CIFAR split that is not
on disk under `default_data_root()` falls back to the synthetic generator,
as the JAX package does on a host without network. ImageNet folders, the
binary-classification remap and resizing wait for a ported caller
(ROADMAP Queue A item 5).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tarfile
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NUM_CLASSES = {"cifar10": 10, "cifar100": 100, "synthetic": 10,
               "synthetic-hard": 10}
IMAGE_SIZE = (32, 32)


def default_data_root() -> Path:
    """NV_DATA_DIR if set, else `data/raw` in the checkout."""
    env = os.environ.get("NV_DATA_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "data" / "raw"


def _load_cifar_from_disk(root: Path, name: str, train: bool):
    """The standard CIFAR python pickle batches, from the extracted
    directory under `root`, or from the original .tar.gz there, extracted
    into ~/.cache/nnue_vision_tpu. Returns (images float32 [0,1] NHWC,
    labels int64), or None when absent."""
    dirname = "cifar-10-batches-py" if name == "cifar10" else "cifar-100-python"
    base = root / dirname
    if not base.exists():
        candidates = [root / f"{dirname}.tar.gz"]
        if name == "cifar10":
            candidates.append(root / "cifar-10-python.tar.gz")
        tarball = next((t for t in candidates if t.exists()), None)
        if tarball is None:
            return None
        base = _extract_to_cache(tarball, name, dirname)

    def read_batch(path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = d.get(b"labels", d.get(b"fine_labels"))
        return data, np.asarray(labels, np.int64)

    if name == "cifar10":
        files = (
            [base / f"data_batch_{i}" for i in range(1, 6)]
            if train else [base / "test_batch"]
        )
    else:
        files = [base / ("train" if train else "test")]
    xs, ys = zip(*(read_batch(f) for f in files))
    images = np.concatenate(xs).astype(np.float32) / 255.0
    return images, np.concatenate(ys)


def _extract_to_cache(tarball: Path, name: str, dirname: str) -> Path:
    """Extract into a temporary directory of the cache, then rename, so an
    interrupted extraction never leaves a partial cache."""
    cache = Path.home() / ".cache" / "nnue_vision_tpu" / name
    cache.mkdir(parents=True, exist_ok=True)
    if not (cache / dirname).exists():
        tmp = Path(tempfile.mkdtemp(dir=cache))
        try:
            with tarfile.open(tarball) as tf:
                tf.extractall(tmp, filter="data")
            try:
                (tmp / dirname).rename(cache / dirname)
            except OSError:
                pass  # a concurrent extractor won the race
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return cache / dirname


def _synthetic_dataset(
    num_classes: int, size: Tuple[int, int], n: int, seed: int,
    class_seed: int = 1234,
):
    """Class-conditional low-frequency patterns plus per-sample noise and
    phase jitter; class patterns from `class_seed` only, samples from
    `seed` (datasets.py:258-293 of the JAX package)."""
    crng = np.random.default_rng(class_seed + num_classes)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    freqs = crng.uniform(0.5, 3.0, (num_classes, 3, 2)).astype(np.float32)
    phases = crng.uniform(0, 2 * np.pi, (num_classes, 3)).astype(np.float32)

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int64)
    images = np.empty((n, h, w, 3), np.float32)
    for i, lab in enumerate(labels):
        jitter = rng.uniform(-0.5, 0.5, 3).astype(np.float32)  # phase jitter
        base = np.stack(
            [
                np.sin(
                    freqs[lab, c, 0] * 2 * np.pi * yy / h
                    + freqs[lab, c, 1] * 2 * np.pi * xx / w
                    + phases[lab, c] + jitter[c]
                )
                for c in range(3)
            ],
            axis=-1,
        )
        noise = rng.normal(0, 0.15, (h, w, 3)).astype(np.float32)
        images[i] = np.clip(0.5 + 0.35 * base + noise, 0.0, 1.0)
    return images, labels


def _synthetic_hard_dataset(
    num_classes: int, size: Tuple[int, int], n: int, seed: int,
    class_seed: int = 5678,
):
    """The difficulty-controlled synthetic-hard task (datasets.py:296-362 of
    the JAX package): 16 shared Gabor-like atoms, 6 per class signature,
    jittered coefficients, 3 distractor atoms, a circular shift of ±4 px,
    pixel noise σ = 0.28. The random draws are made in the JAX package's
    order; the shifts are applied in one gather instead of a loop."""
    h, w = size
    n_atoms, atoms_per_class, distractors = 16, 6, 3
    crng = np.random.default_rng(class_seed + 7 * num_classes)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yc, xc = yy / h - 0.5, xx / w - 0.5

    atoms = np.empty((n_atoms, h, w, 3), np.float32)
    for k in range(n_atoms):
        theta = crng.uniform(0, np.pi)
        freq = crng.uniform(1.5, 5.0)
        phase = crng.uniform(0, 2 * np.pi)
        cy, cx = crng.uniform(-0.25, 0.25, 2)
        sigma = crng.uniform(0.18, 0.35)
        grating = np.sin(
            2 * np.pi * freq
            * (np.cos(theta) * yc + np.sin(theta) * xc) + phase
        )
        envelope = np.exp(-((yc - cy) ** 2 + (xc - cx) ** 2) / (2 * sigma**2))
        chan = crng.uniform(-1.0, 1.0, 3).astype(np.float32)
        chan /= max(1e-6, np.abs(chan).max())
        atoms[k] = (grating * envelope)[:, :, None] * chan

    signatures = np.zeros((num_classes, n_atoms), np.float32)
    for c in range(num_classes):
        picked = crng.choice(n_atoms, atoms_per_class, replace=False)
        signatures[c, picked] = (
            crng.uniform(0.5, 1.0, atoms_per_class)
            * crng.choice([-1.0, 1.0], atoms_per_class)
        )

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int64)
    coefs = signatures[labels] * rng.uniform(0.4, 1.6, (n, n_atoms))
    for i in range(n):
        d = rng.choice(n_atoms, distractors, replace=False)
        coefs[i, d] += rng.uniform(-0.5, 0.5, distractors)
    images = np.tensordot(coefs.astype(np.float32), atoms, axes=(1, 0))
    shifts = rng.integers(-4, 5, (n, 2))
    # np.roll(images[i], shifts[i], axis=(0, 1)) for every i at once
    rows = (np.arange(h)[None, :] - shifts[:, :1]) % h  # (n, h)
    cols = (np.arange(w)[None, :] - shifts[:, 1:]) % w  # (n, w)
    images = images[np.arange(n)[:, None, None], rows[:, :, None],
                    cols[:, None, :]]
    noise = rng.normal(0.0, 0.28, images.shape).astype(np.float32)
    images = np.clip(0.5 + 0.24 * images + noise, 0.0, 1.0)
    return images.astype(np.float32), labels


class GenericVisionDataset:
    """In-memory dataset of (NHWC float32 [0,1] image, int label) samples,
    with the JAX package's split and truncation rules."""

    def __init__(
        self,
        dataset_name: str = "cifar10",
        split: str = "train",
        max_samples: Optional[int] = None,
        subset: float = 1.0,
        synthetic_size: int = 512,
        seed: int = 0,
        synthetic_class_seed: Optional[int] = None,
    ):
        if dataset_name not in NUM_CLASSES:
            raise ValueError(f"Unknown dataset: {dataset_name}. "
                             f"Available: {list(NUM_CLASSES)}")
        is_train = split in ("train", "training")
        loaded = None
        if dataset_name in ("cifar10", "cifar100"):
            loaded = _load_cifar_from_disk(default_data_root(), dataset_name,
                                           is_train)
        self.is_synthetic = loaded is None
        if loaded is None:
            n = synthetic_size if is_train else max(64, synthetic_size // 4)
            generator = (
                _synthetic_hard_dataset
                if dataset_name == "synthetic-hard"
                else _synthetic_dataset
            )
            gen_kwargs = {}
            if synthetic_class_seed is not None:
                gen_kwargs["class_seed"] = int(synthetic_class_seed)
            loaded = generator(
                NUM_CLASSES[dataset_name],
                IMAGE_SIZE,
                n,
                seed=seed + (0 if is_train else 10_000),
                **gen_kwargs,
            )
        images, labels = loaded

        # max_samples first, then subset
        if max_samples is not None:
            images, labels = images[:max_samples], labels[:max_samples]
        if subset < 1.0:
            k = int(len(images) * subset)
            images, labels = images[:k], labels[:k]

        self.images = np.ascontiguousarray(images, np.float32)
        self.labels = np.ascontiguousarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        if idx >= len(self.labels):
            raise IndexError(idx)
        return self.images[idx], int(self.labels[idx])
