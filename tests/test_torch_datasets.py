"""The port's data layer held against the JAX package's on the same
arguments: the registry, the bilinear resize, the ImageNet synthetic
fallback at 224×224, an ImageNet class-folder tree written by the test, the
binary remap and the truncation order, the loaders, the dataset statistics
and the inspector's report. Every comparison is exact: both packages run
the same numpy code on the same inputs.
"""

import numpy as np
import pytest

from nnue_vision_tpu.data import dataset_inspector as jinspect
from nnue_vision_tpu.data import datasets as jdata
from nnue_vision_tpu.data import loaders as jloaders
from nnue_vision_tpu_torch.data import dataset_inspector as tinspect
from nnue_vision_tpu_torch.data import datasets as tdata
from nnue_vision_tpu_torch.data import loaders as tloaders


@pytest.fixture(autouse=True)
def _no_download(monkeypatch, tmp_path):
    """Both packages read an empty data root (the JAX package would try to
    download CIFAR otherwise)."""
    monkeypatch.setenv("NV_NO_DOWNLOAD", "1")
    monkeypatch.setenv("NV_DATA_DIR", str(tmp_path / "empty"))


def _same(t, j):
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.images.dtype == j.images.dtype == np.float32
    assert t.labels.dtype == j.labels.dtype == np.int64
    assert t.class_names == j.class_names and t.num_classes == j.num_classes
    assert t.is_synthetic == j.is_synthetic


def test_registry_equals_jax():
    assert tdata.AVAILABLE_DATASETS == jdata.AVAILABLE_DATASETS
    assert tdata.NATIVE_SIZES == jdata.NATIVE_SIZES
    for name in jdata.AVAILABLE_DATASETS:
        assert tdata.get_dataset_info(name) == jdata.get_dataset_info(name)
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.get_dataset_info("mnist")


@pytest.mark.parametrize("src,dst", [((32, 32), (20, 20)), ((20, 24), (64, 56)),
                                     ((300, 260), (224, 224)), ((7, 9), (7, 9))])
def test_resize_bilinear_equals_jax(src, dst):
    images = np.random.default_rng(sum(src)).random((3, *src, 3), dtype=np.float32)
    got = tdata._resize_bilinear(images, dst)
    want = jdata._resize_bilinear(images, dst)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, *dst, 3) and got.dtype == want.dtype


@pytest.mark.parametrize("split", ["train", "test"])
def test_imagenet_synthetic_fallback_equals_jax(split):
    kw = dict(dataset_name="imagenet", split=split, synthetic_size=8, seed=3)
    t, j = tdata.GenericVisionDataset(**kw), jdata.GenericVisionDataset(**kw)
    _same(t, j)
    assert t.is_synthetic and t.images.shape[1:] == (224, 224, 3)
    assert t.num_classes == 1000 and t.target_size == (224, 224)
    assert len(t) == (8 if split == "train" else 64)


def test_target_size_resizes_like_jax():
    kw = dict(dataset_name="synthetic", synthetic_size=16, seed=1,
              target_size=(48, 40))
    t, j = tdata.GenericVisionDataset(**kw), jdata.GenericVisionDataset(**kw)
    _same(t, j)
    assert t.images.shape[1:] == (48, 40, 3)


def _write_folder(root, rng):
    """2 classes × 3 RGB images of 300×260 per split, as PNG."""
    image_mod = pytest.importorskip("PIL.Image")
    for split in ("train", "val"):
        for cls in ("n00000002", "n00000001"):
            d = root / "imagenet" / split / cls
            d.mkdir(parents=True)
            for k in range(3):
                pixels = rng.integers(0, 256, (300, 260, 3), dtype=np.uint8)
                image_mod.fromarray(pixels).save(d / f"img_{k}.png")


@pytest.mark.parametrize("split", ["train", "test"])
def test_imagenet_folder_equals_jax(tmp_path, split):
    _write_folder(tmp_path / "data", np.random.default_rng(4))
    kw = dict(dataset_name="imagenet", split=split, data_root=str(tmp_path / "data"))
    t, j = tdata.GenericVisionDataset(**kw), jdata.GenericVisionDataset(**kw)
    _same(t, j)
    assert not t.is_synthetic
    assert t.images.shape == (6, 224, 224, 3)
    assert t.labels.tolist() == [0, 0, 0, 1, 1, 1]
    small = dict(kw, target_size=(40, 48))
    _same(tdata.GenericVisionDataset(**small), jdata.GenericVisionDataset(**small))


def test_missing_folder_without_fallback_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic fallback disabled"):
        tdata.GenericVisionDataset("imagenet", data_root=str(tmp_path),
                                   synthetic_fallback=False)


@pytest.mark.parametrize("name,positive", [
    ("cifar10", ["cat", "dog", "not-a-class"]),
    ("imagenet", ["n00000003", "n00000007"]),
])
def test_binary_remap_and_truncation_equal_jax(name, positive):
    kw = dict(dataset_name=name, split="train", synthetic_size=40, seed=5,
              binary_classification={"positive_classes": positive},
              max_samples=30, subset=0.5)
    if name == "imagenet":
        kw["target_size"] = (16, 16)
    t, j = tdata.GenericVisionDataset(**kw), jdata.GenericVisionDataset(**kw)
    _same(t, j)
    assert len(t) == 15 and t.class_names == ["negative", "positive"]
    assert t.get_class_distribution() == j.get_class_distribution()
    plain = tdata.GenericVisionDataset(**{k: v for k, v in kw.items()
                                          if k != "binary_classification"})
    want = {}
    for lab in plain.labels.tolist():
        key = "positive" if plain.class_names[lab] in positive else "negative"
        want[key] = want.get(key, 0) + 1
    assert sorted(t.get_class_distribution().items()) == sorted(want.items())


def test_class_distribution_equals_jax():
    kw = dict(dataset_name="imagenet", split="test", synthetic_size=8, seed=2,
              target_size=(8, 8))
    t, j = tdata.GenericVisionDataset(**kw), jdata.GenericVisionDataset(**kw)
    assert t.get_class_distribution() == j.get_class_distribution()
    assert list(t.get_class_distribution()) == list(j.get_class_distribution())
    assert sum(t.get_class_distribution().values()) == 64


def test_imagenet_loaders_equal_jax():
    kw = dict(dataset_name="imagenet", batch_size=4, synthetic_size=12, seed=6,
              use_augmentation=True, augmentation_strength="heavy")
    t_loaders = tloaders.create_data_loaders(**kw)
    j_loaders = jloaders.create_data_loaders(**kw)
    for t, j in zip(t_loaders, j_loaders):
        assert len(t) == len(j)
        assert t.dataset.use_augmentation == j.dataset.use_augmentation
        assert t.dataset.augmentation_strength == "heavy"
        for _ in range(2):  # two epochs of the shuffling train loader
            t_batches, j_batches = list(t), list(j)
            assert len(t_batches) == len(j_batches)
            for (ti, tl), (ji, jl) in zip(t_batches, j_batches):
                assert ti.shape[1:] == (224, 224, 3)
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(tl, jl)
    assert [ld.dataset.use_augmentation for ld in t_loaders] == [True, False, False]


def test_dataset_stats_equal_jax():
    for name in jdata.AVAILABLE_DATASETS:
        assert tloaders.get_dataset_stats(name) == jloaders.get_dataset_stats(name)
    kw = dict(dataset_name="synthetic", batch_size=16, synthetic_size=32, seed=2)
    t = tloaders.create_data_loaders(**kw)[1]
    j = jloaders.create_data_loaders(**kw)[1]
    assert tloaders.calculate_dataset_statistics(t) == \
        jloaders.calculate_dataset_statistics(j)


@pytest.mark.parametrize("name,split", [("imagenet", "train"), ("cifar10", "test")])
def test_inspector_report_equals_jax(name, split):
    got = tinspect.inspect_dataset(name, split, max_samples=6)
    assert got == jinspect.inspect_dataset(name, split, max_samples=6)
    assert got["synthetic"] and got["num_samples"] == 6


def test_inspector_cli_prints_the_report(capsys):
    assert tinspect.main(["imagenet", "--max-samples", "4"]) == 0
    out = capsys.readouterr().out
    assert "=== ImageNet (train) ===" in out
    assert "image_shape: (224, 224, 3)" in out
