"""The port's training core held against the JAX package on the same numpy
inputs: the straight-through threshold (F2), the optimizer's update of
every param including `nnue2score` (F1), the loss and gradients of a train
step, three SGD steps, the LR schedule, the init, and the data that feeds
them (datasets, loader order).

Tolerances: float32 sums run in another order in XLA and in torch, so a
loss agrees to rtol 1e-5 and a gradient or a parameter after a few steps to
atol 1e-5. The binary mask is compared exactly first: the inputs are made
so that no conv output lies within 1e-3 of the threshold, where summation
order could flip a feature.
"""

import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from nnue_vision_tpu import formats
from nnue_vision_tpu.data import datasets as jdata
from nnue_vision_tpu.data import loaders as jloaders
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import optim as joptim
from nnue_vision_tpu.training import step as jstep
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data import datasets as tdata
from nnue_vision_tpu_torch.data import loaders as tloaders
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import optim as toptim
from nnue_vision_tpu_torch.training import step as tstep

GRID, CH, H = 4, 4, 12
WIDTHS = dict(l1_size=32, l2_size=16, l3_size=8, num_classes=10, input_size=H)
F_ALL = GRID * GRID * CH


def _cfgs(**kw):
    j = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    t = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(GRID, CH), **WIDTHS, **kw)
    return j, t


def _params(rng, thresholds=(0.1, 0.14, 0.06, 0.1)):
    """Float params with the JAX package's init distributions (numpy), and
    a nonzero FT bias so that no FT sum is exactly 0."""
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    l1, l2, l3, c = 32, 16, 8, 10
    return {
        "conv_w": u((CH, 3, 3, 3), 27),
        "visual_threshold": np.asarray(thresholds, np.float32),
        "ft_w": (rng.standard_normal((F_ALL, l1)) * 0.1).astype(np.float32),
        "ft_b": (rng.standard_normal(l1) * 0.05).astype(np.float32),
        "fc1_w": u((l2, l1), l1), "fc1_b": u((l2,), l1),
        "fc2_w": u((l3, l2), l2), "fc2_b": u((l3,), l2),
        "out_w": u((c, l3), l3), "out_b": u((c,), l3),
        "nnue2score": np.float32(600.0),
    }


def _margin(p, x, cfg):
    """Per image, min |conv - threshold| in float64 with the weights and
    threshold the forward uses (x: normalized NHWC)."""
    w = p["conv_w"].astype(np.float64)
    t = p["visual_threshold"].astype(np.float64)
    if cfg.qat:
        t = np.full_like(t, t.mean())
        if cfg.qat_rounding:
            w = np.round(np.clip(w, -127 / 64, 127 / 64) * 64) / 64
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                    torch.from_numpy(w), stride=cfg.conv_stride, padding=1)
    return np.abs(conv.permute(0, 2, 3, 1).numpy() - t).min(axis=(1, 2, 3))


def _clear_batch(rng, p, cfg, b, margin=1e-3):
    """`b` normalized images with every conv output at least `margin` from
    the threshold, and labels."""
    raw = rng.random((8 * b, H, H, 3), dtype=np.float32)
    x = normalize_images(torch.from_numpy(raw)).numpy()
    keep = x[_margin(p, x, cfg) > margin][:b]
    assert len(keep) == b
    return keep, rng.integers(0, 10, b).astype(np.int32)


# ---------------------------------------------------------------------------
# F2: the straight-through threshold
# ---------------------------------------------------------------------------


def _ste_grads_jax(x, t, g):
    def f(x, t):
        return jnp.sum(jnnue.binary_activation_ste(x, t) * g)

    return jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(t))


def _ste_grads_torch(x, t, g):
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    (tnnue.binary_activation_ste(xt, tt) * torch.from_numpy(g)).sum().backward()
    return xt.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("case", ["per-channel", "pad-tail-negative"])
def test_ste_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "per-channel":
        x = rng.normal(0.1, 0.3, (5, 3, 3, 4)).astype(np.float32)
        t = np.asarray([0.1, -0.05, 0.2, 0.0], np.float32)
    else:  # the QAT zero tail against a negative deployed threshold
        x = np.zeros((5, 1, 7, 1), np.float32)
        t = np.asarray([-0.02], np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jnnue.binary_activation_ste(jnp.asarray(x), jnp.asarray(t)))
    got = tnnue.binary_activation_ste(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)  # forward bit-equal
    if case == "pad-tail-negative":
        assert want.min() == 1.0  # the whole tail is active
    jx, jt = _ste_grads_jax(x, t, g)
    tx, tt = _ste_grads_torch(x, t, g)
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-5)
    assert np.abs(tt).max() > 1e-3  # the surrogate gradient is not empty


# ---------------------------------------------------------------------------
# loss and gradients of one step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(qat=False), dict(qat=True)],
                         ids=["float", "qat"])
def test_loss_and_grads_match_jax(kw):
    rng = np.random.default_rng(11)
    jcfg, tcfg = _cfgs(**kw)
    p = _params(rng)
    x, y = _clear_batch(rng, p, tcfg, 8)

    jp = jax.tree_util.tree_map(jnp.asarray, p)
    _, jaux = jnnue.nnue_apply(jp, jnp.asarray(x), jcfg, return_aux=True)

    def jloss(params):
        logits = jnnue.nnue_apply(params, jnp.asarray(x), jcfg)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jl, jg = jax.value_and_grad(jloss)(jp)

    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    logits, taux = model(torch.from_numpy(x), return_aux=True)
    np.testing.assert_array_equal(taux["mask"].detach().numpy(),
                                  np.asarray(jaux["mask"]))
    if kw["qat"]:  # the zero tail is thresholded, inactive at t > 0
        assert taux["mask"].shape[1] == F_ALL
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, t in model.named_parameters():
        got = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    # the threshold learns through the STE; under QAT through the mean
    vt = model.visual_threshold.grad.numpy()
    assert np.abs(vt).max() > 0
    if kw["qat"]:
        np.testing.assert_allclose(vt, np.full_like(vt, vt.mean()), atol=1e-7)


# ---------------------------------------------------------------------------
# K optimizer steps in both frameworks (F1 and the SGD chain)
# ---------------------------------------------------------------------------

K_STEPS = 3
TRAIN_CFG = types.SimpleNamespace(
    learning_rate=0.02, weight_decay=2e-4, momentum=0.9, optimizer_type="sgd",
    max_epochs=2, max_grad_norm=1.0, use_cosine_scheduler=True, decay_lr=True,
    use_cyclical_lr=False,
)


def _run_steps(optimizer_type):
    rng = np.random.default_rng(5)
    jcfg, tcfg = _cfgs(qat=True)
    p = _params(rng)
    batches = [_clear_batch(rng, p, tcfg, 16, margin=5e-3) for _ in range(K_STEPS)]
    cfg = types.SimpleNamespace(**{**vars(TRAIN_CFG),
                                   "optimizer_type": optimizer_type})

    jopt = joptim.create_optimizer(cfg, steps_per_epoch=10)
    jstate = jstep.make_train_state(jax.tree_util.tree_map(jnp.asarray, p), jopt)
    topt = toptim.create_optimizer(cfg, steps_per_epoch=10)
    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    tstate = tstep.make_train_state(model, topt)
    masks, losses = [], []
    for x, y in batches:
        _, jaux = jnnue.nnue_apply(jstate.params, jnp.asarray(x), jcfg,
                                   return_aux=True)
        _, taux = model(torch.from_numpy(x), return_aux=True)
        masks.append((taux["mask"].detach().numpy(), np.asarray(jaux["mask"])))
        jstate, jm = jstep.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                      model_type="nnue", model_cfg=jcfg,
                                      optimizer=jopt)
        tm = tstep.train_step(tstate, torch.from_numpy(x),
                              torch.from_numpy(y).long(), optimizer=topt)
        losses.append((float(tm["loss"]), float(jm["loss"])))
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    return dict(model=model, tcfg=tcfg, jcfg=jcfg, jparams=jparams,
                masks=masks, losses=losses, tstate=tstate, init=p)


@pytest.fixture(scope="module")
def sgd_run():
    return _run_steps("sgd")


@pytest.mark.parametrize("optimizer_type", ["sgd", "adam"])
def test_optimizer_steps_match_jax(optimizer_type, sgd_run):
    run = sgd_run if optimizer_type == "sgd" else _run_steps("adam")
    for got, want in run["masks"]:
        np.testing.assert_array_equal(got, want)
    for got, want in run["losses"]:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    tparams = bridge.nnue_to_numpy(run["model"])
    for name, want in run["jparams"].items():
        np.testing.assert_allclose(tparams[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not np.array_equal(tparams[name], run["init"][name]), name
    assert run["tstate"].step == K_STEPS
    assert run["tstate"].opt_state["count"] == K_STEPS
    for w in ("ft_w", "fc1_w", "fc2_w", "out_w"):  # clip_weights
        assert np.abs(tparams[w]).max() <= 1.0


def test_nnue2score_decays_like_jax(sgd_run):
    """F1: nnue2score has no gradient, but weight decay moves it, as optax's
    add_decayed_weights does for every leaf of the params pytree."""
    got = float(sgd_run["model"].nnue2score.detach())
    want = float(sgd_run["jparams"]["nnue2score"])
    assert want < 600.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_nnue_bytes_after_steps_match_jax(sgd_run, tmp_path):
    """F1: the `.nnue` written from the trained params, nnue2score in its
    header included, equals the JAX package's bytes."""
    formats.write_nnue(tnnue.nnue_quantize(sgd_run["model"]), tmp_path / "t.nnue")
    formats.write_nnue(jnnue.nnue_quantize(sgd_run["jparams"], sgd_run["jcfg"]),
                       tmp_path / "j.nnue")
    assert (tmp_path / "t.nnue").read_bytes() == (tmp_path / "j.nnue").read_bytes()


def test_optimizer_clips_like_optax():
    """Clip by global norm only when the norm reaches max_norm, as
    (g / norm) · max_norm with no epsilon; a None gradient counts as 0."""
    opt = toptim.Optimizer(lambda _: 1.0, kind="sgd", momentum=0.0,
                           max_grad_norm=1.0)
    for g, want in (([0.3, 0.4], [0.3, 0.4]), ([3.0, 4.0], [0.6, 0.8])):
        params = {"a": torch.zeros(2), "b": torch.zeros(())}
        state = opt.init(params)
        opt.step(params, {"a": torch.tensor(g), "b": None}, state)
        np.testing.assert_allclose(-params["a"].numpy(), want, rtol=1e-6)
        assert float(params["b"]) == 0.0


# ---------------------------------------------------------------------------
# LR schedule, init, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(min_lr=1e-4),
    dict(warmup_iters=7),
    dict(use_cyclical_lr=True, cyclical_lr_period=9, cyclical_lr_amplitude=0.1),
    dict(use_cosine_scheduler=False),
], ids=["cosine", "cosine-min-lr", "warmup", "cyclical", "constant"])
def test_lr_per_step_matches_optax(kw):
    """Every step of a 3-epoch run of 39 steps. The port takes the correctly
    rounded cosine, XLA's float32 cosine can be 1 ulp off it: the LR may
    differ by that ulp times LR/2, plus the rounding of the three float32
    operations after it (atol lr·2⁻²³)."""
    cfg = types.SimpleNamespace(learning_rate=0.02, use_cosine_scheduler=True,
                                max_epochs=3, decay_lr=True,
                                use_cyclical_lr=False)
    for k, v in kw.items():
        setattr(cfg, k, v)
    js = joptim.make_schedule(cfg, 39)
    ts = toptim.make_schedule(cfg, 39)
    steps = range(3 * 39 + 5)
    want = np.array([np.float32(js(jnp.int32(i))) for i in steps])
    got = np.array([ts(i) for i in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * 2**-23)
    assert got[0] == want[0] and got.dtype == np.float32


def test_init_distributions():
    _, tcfg = _cfgs()
    model = tnnue.nnue_init(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p = bridge.nnue_to_numpy(model)
    ref = jax.tree_util.tree_map(
        np.asarray, jnnue.nnue_init(jax.random.PRNGKey(0), _cfgs()[0]))
    assert set(p) == set(ref)
    for name in p:
        assert p[name].shape == ref[name].shape and p[name].dtype == np.float32
    for name, fan_in in (("conv_w", 27), ("fc1_w", 32), ("fc1_b", 32),
                         ("fc2_w", 16), ("out_w", 8), ("out_b", 8)):
        assert np.abs(p[name]).max() <= 1 / math.sqrt(fan_in)
    assert 0.08 < p["ft_w"].std() < 0.12 and abs(p["ft_w"].mean()) < 0.02
    np.testing.assert_array_equal(p["ft_b"], ref["ft_b"])
    np.testing.assert_array_equal(p["visual_threshold"], ref["visual_threshold"])
    assert p["nnue2score"] == ref["nnue2score"] == 600.0
    same = tnnue.nnue_init(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert all(np.array_equal(v, bridge.nnue_to_numpy(same)[k]) for k, v in p.items())


@pytest.mark.parametrize("name", ["synthetic", "synthetic-hard"])
def test_datasets_equal_jax(name):
    for split in ("train", "test"):
        kw = dict(dataset_name=name, split=split, synthetic_size=96, seed=7)
        t = tdata.GenericVisionDataset(**kw)
        j = jdata.GenericVisionDataset(**kw)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert t.images.dtype == np.float32 and t.labels.dtype == np.int64


def test_cifar_tarball_extracts_only_into_the_cache(tmp_path, monkeypatch):
    """A CIFAR-10 tarball under NV_DATA_DIR is read through
    ~/.cache/nnue_vision_tpu; nothing is written next to the tarball."""
    import io
    import pickle
    import tarfile

    rng = np.random.default_rng(5)
    batches = {f"data_batch_{i}": 6 for i in range(1, 6)}
    batches["test_batch"] = 4
    arrays = {}
    root, home = tmp_path / "data", tmp_path / "home"
    root.mkdir()
    with tarfile.open(root / "cifar-10-python.tar.gz", "w:gz") as tf:
        for name, n in batches.items():
            data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
            labels = rng.integers(0, 10, n).tolist()
            arrays[name] = (data, labels)
            blob = pickle.dumps({b"data": data, b"labels": labels})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    monkeypatch.setenv("NV_DATA_DIR", str(root))
    monkeypatch.setenv("HOME", str(home))
    assert tdata.default_data_root() == root

    train = tdata.GenericVisionDataset("cifar10", split="train")
    test = tdata.GenericVisionDataset("cifar10", split="test")
    assert not train.is_synthetic and not test.is_synthetic
    want = np.concatenate([arrays[f"data_batch_{i}"][0] for i in range(1, 6)])
    want = want.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1) / np.float32(255)
    np.testing.assert_array_equal(train.images, want.astype(np.float32))
    assert test.labels.tolist() == arrays["test_batch"][1]
    assert sorted(p.name for p in root.iterdir()) == ["cifar-10-python.tar.gz"]
    assert (home / ".cache" / "nnue_vision_tpu" / "cifar10"
            / "cifar-10-batches-py" / "test_batch").is_file()


def test_data_root_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("NV_DATA_DIR", raising=False)
    repo = Path(tdata.__file__).resolve().parents[2]
    assert tdata.default_data_root() == repo / "data" / "raw"
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.GenericVisionDataset("imagenet")


def test_loader_index_order_equals_jax():
    kw = dict(dataset_name="synthetic", batch_size=8, max_samples_per_split=44,
              synthetic_size=64, seed=3)
    t_loaders = tloaders.create_data_loaders(**kw)
    j_loaders = jloaders.create_data_loaders(**kw)
    for t, j in zip(t_loaders, j_loaders):
        assert len(t) == len(j)
        for _ in range(2):  # two epochs of the shuffling train loader
            t_idx, j_idx = list(t.iter_indices()), list(j.iter_indices())
            assert len(t_idx) == len(j_idx)
            for a, b in zip(t_idx, j_idx):
                np.testing.assert_array_equal(a, b)
    head = tloaders.head_subset_loader(t_loaders[0], 10, batch_size=4)
    assert [len(b) for _, b in head] == [4, 4, 2]
