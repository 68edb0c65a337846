"""Datasets: CIFAR-10/100 from disk, ImageNet class folders, and the
synthetic generators.

Port of `nnue_vision_tpu/data/datasets.py` (numpy only, so it is copied
rather than imported: that package's `data/__init__` imports jax). The same
arguments and seeds give the same arrays: samples are NHWC float32 in
[0, 1] at the dataset's `target_size` (by default its native size from
`NATIVE_SIZES`: 32×32, or 224×224 for ImageNet), labels int64, and
augmentation and normalization happen on the device.

The registry (`AVAILABLE_DATASETS`, `get_dataset_info`) names each
dataset's classes, class count and input size. An ImageNet split is read
from `data_root/imagenet/{train,val}/<class>/*` (one folder per class, in
sorted order; PIL is imported only there and is optional, as in the JAX
package); every loaded split is resized to `target_size` with
`_resize_bilinear`. `binary_classification={"positive_classes": [...]}`
remaps the labels to 0/1 by class name.

Unlike the JAX package, the port never downloads: a CIFAR split that is not
on disk under `data_root` (default `default_data_root()`), or an ImageNet
split whose folder is absent, falls back to the synthetic generator at the
target size with the registry's class count, as the JAX package does on a
host without network; `synthetic_fallback=False` raises instead.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tarfile
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

AVAILABLE_DATASETS: Dict[str, dict] = {
    "cifar10": {
        "name": "CIFAR-10",
        "classes": [
            "airplane", "automobile", "bird", "cat", "deer",
            "dog", "frog", "horse", "ship", "truck",
        ],
        "num_classes": 10,
        "input_size": (32, 32),
        "channels": 3,
    },
    "cifar100": {
        "name": "CIFAR-100",
        "classes": [f"class_{i}" for i in range(100)],
        "num_classes": 100,
        "input_size": (32, 32),
        "channels": 3,
    },
    "imagenet": {
        "name": "ImageNet",
        "classes": [f"n{i:08d}" for i in range(1000)],
        "num_classes": 1000,
        "input_size": (224, 224),
        "channels": 3,
    },
    "synthetic": {
        "name": "Synthetic",
        "classes": [f"class_{i}" for i in range(10)],
        "num_classes": 10,
        "input_size": (32, 32),
        "channels": 3,
    },
    "synthetic-hard": {
        "name": "Synthetic-Hard",
        "classes": [f"class_{i}" for i in range(10)],
        "num_classes": 10,
        "input_size": (32, 32),
        "channels": 3,
    },
}

NATIVE_SIZES = {name: info["input_size"] for name, info in AVAILABLE_DATASETS.items()}


def get_dataset_info(dataset_name: str) -> dict:
    if dataset_name not in AVAILABLE_DATASETS:
        raise ValueError(
            f"Unknown dataset: {dataset_name}. "
            f"Available: {list(AVAILABLE_DATASETS.keys())}"
        )
    return AVAILABLE_DATASETS[dataset_name]


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


def _resize_bilinear(images: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize of (N, H, W, C) float arrays to `size`
    (corners aligned; datasets.py:170-191 of the JAX package)."""
    n, h, w, c = images.shape
    th, tw = size
    if (h, w) == (th, tw):
        return images
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    a = images[:, y0][:, :, x0]
    b = images[:, y0][:, :, x1]
    cc = images[:, y1][:, :, x0]
    d = images[:, y1][:, :, x1]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
        + cc * wy * (1 - wx) + d * wy * wx
    ).astype(np.float32)


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
    with the JAX package's arguments, split and truncation rules.
    `use_augmentation` and `augmentation_strength` are recorded, as in the
    JAX package; the train loop augments on the device."""

    def __init__(
        self,
        dataset_name: str = "cifar10",
        split: str = "train",
        target_size: Optional[Tuple[int, int]] = None,
        max_samples: Optional[int] = None,
        subset: float = 1.0,
        data_root: Optional[str] = None,
        binary_classification: Optional[dict] = None,
        use_augmentation: Optional[bool] = None,
        augmentation_strength: str = "medium",
        synthetic_fallback: bool = True,
        synthetic_size: int = 512,
        seed: int = 0,
        synthetic_class_seed: Optional[int] = None,
    ):
        self.dataset_name = dataset_name
        self.split = split
        self.dataset_info = get_dataset_info(dataset_name)
        self.data_root = Path(data_root) if data_root else default_data_root()
        self.target_size = tuple(target_size or NATIVE_SIZES[dataset_name])
        self.augmentation_strength = augmentation_strength
        is_train = split in ("train", "training")
        self.use_augmentation = (
            use_augmentation if use_augmentation is not None else is_train)

        loaded = None
        if dataset_name in ("cifar10", "cifar100"):
            loaded = _load_cifar_from_disk(self.data_root, dataset_name,
                                           is_train)
        elif dataset_name == "imagenet":
            loaded = self._load_imagefolder(is_train)
        self.is_synthetic = loaded is None
        if loaded is None:
            if not synthetic_fallback and not dataset_name.startswith("synthetic"):
                raise FileNotFoundError(
                    f"{dataset_name} not found under {self.data_root} and "
                    "synthetic fallback disabled")
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
                self.dataset_info["num_classes"],
                self.target_size,
                n,
                seed=seed + (0 if is_train else 10_000),
                **gen_kwargs,
            )
        images, labels = loaded
        images = _resize_bilinear(images, self.target_size)

        # binary remap by positive class names
        if binary_classification:
            classes = self.dataset_info["classes"]
            positive = [classes.index(c)
                        for c in binary_classification.get("positive_classes", [])
                        if c in classes]
            labels = np.isin(labels, positive).astype(np.int64)
            self.class_names = ["negative", "positive"]
            self.num_classes = 2
        else:
            self.class_names = self.dataset_info["classes"]
            self.num_classes = self.dataset_info["num_classes"]

        # max_samples first, then subset
        if max_samples is not None:
            images, labels = images[:max_samples], labels[:max_samples]
        if subset < 1.0:
            k = int(len(images) * subset)
            images, labels = images[:k], labels[:k]

        self.images = np.ascontiguousarray(images, np.float32)
        self.labels = np.ascontiguousarray(labels, np.int64)

    def _load_imagefolder(self, is_train: bool):
        """`data_root/imagenet/{train,val}/<class>/*`, classes in sorted
        folder order and files in sorted order, each image resized to the
        target size; None when the folder is absent, empty, or PIL is not
        installed."""
        split_dir = self.data_root / "imagenet" / ("train" if is_train else "val")
        if not split_dir.exists():
            return None
        try:
            from PIL import Image  # optional dependency
        except ImportError:
            return None
        images, labels = [], []
        classes = sorted(d.name for d in split_dir.iterdir() if d.is_dir())
        for li, cls in enumerate(classes):
            for f in sorted((split_dir / cls).glob("*")):
                with Image.open(f) as im:
                    img = np.asarray(im.convert("RGB"), np.float32) / 255.0
                images.append(_resize_bilinear(img[None], self.target_size)[0])
                labels.append(li)
        if not images:
            return None
        return np.stack(images), np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        if idx >= len(self.labels):
            raise IndexError(idx)
        return self.images[idx], int(self.labels[idx])

    def get_class_distribution(self) -> Dict[str, int]:
        """{class name: samples} in the order the labels first occur."""
        dist: Dict[str, int] = {}
        for lab in self.labels.tolist():
            name = self.class_names[lab]
            dist[name] = dist.get(name, 0) + 1
        return dist
