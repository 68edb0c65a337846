"""The port's upstream checkpoint import (`nnue_vision_tpu_torch/torch_import.py`)
held against the JAX package's `torch_import` on the same upstream files:
the params and batch statistics exactly equal, the forward logits at the
model tests' bars (NNUE atol 1e-4 / rtol 1e-5, EtinyNet atol 1e-5), the
wrapped and auto forms, a one-element threshold, an unknown stem width,
and the sniff on both packages' own pickles. The upstream state dicts
are built in memory from seeded torch generators."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu import torch_import as jimport
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch import torch_import as timport
from nnue_vision_tpu_torch.models import etinynet as tetiny

GRID, CH, L1, L2, L3, CLASSES = 4, 4, 16, 8, 4, 3


def upstream_nnue_state_dict(seed=0, threshold=None, grid=GRID, ch=CH):
    """An upstream NNUE state dict (`input.weight` is (F, L1))."""
    g = torch.Generator().manual_seed(seed)
    f = grid * grid * ch

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    return {
        "conv.weight": t(ch, 3, 3, 3),
        "visual_threshold": (torch.full((ch,), 0.1) if threshold is None
                             else threshold),
        "input.weight": t(f, L1),
        "input.bias": t(L1),
        "classifier.classifier.0.weight": t(L2, L1),
        "classifier.classifier.0.bias": t(L2),
        "classifier.classifier.2.weight": t(L3, L2),
        "classifier.classifier.2.bias": t(L3),
        "classifier.classifier.4.weight": t(CLASSES, L3),
        "classifier.classifier.4.bias": t(CLASSES),
        "nnue2score": torch.tensor(600.0),
    }


def upstream_etinynet_state_dict(variant="micro", classes=10, seed=0):
    """An upstream EtinyNet state dict: `stage{k}.{i}[.lb].*` blocks (the
    `.lb` prefix in the dense stages), `dense_proj` on the stride-1 dense
    blocks that keep their width, norms with random affines and running
    statistics."""
    g = torch.Generator().manual_seed(seed)
    cfg = tetiny.EtinyNetConfig(variant=variant, num_classes=classes)
    t = cfg.table
    sd = {}

    def w(key, *shape):  # N(0, 1/fan_in), the scale of JAX's init
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        sd[key] = torch.randn(*shape, generator=g) / fan_in ** 0.5

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 0.6 + 0.8 * torch.rand(c, generator=g)
        sd[f"{prefix}.bias"] = 0.6 * torch.rand(c, generator=g) - 0.3
        sd[f"{prefix}.running_mean"] = 0.6 * torch.rand(c, generator=g) - 0.3
        sd[f"{prefix}.running_var"] = 0.5 + 1.5 * torch.rand(c, generator=g)

    w("conv_initial.weight", t["conv_channels"], 3, 3, 3)
    bn("bn_initial", t["conv_channels"])
    stage_lengths = [len(t[f"stage{k}"]) for k in range(1, 5)]
    stage, idx = 1, 0
    for _, in_c, mid, out, stride, dense in cfg.block_specs():
        base = f"stage{stage}.{idx}"
        inner = f"{base}.lb" if dense else base
        w(f"{inner}.pw_expand.weight", mid, in_c, 1, 1)
        bn(f"{inner}.bn1", mid)
        w(f"{inner}.dw_conv.weight", mid, 1, 3, 3)
        bn(f"{inner}.bn2", mid)
        w(f"{inner}.pw_project.weight", out, mid, 1, 1)
        bn(f"{inner}.bn3", out)
        if dense and stride == 1 and in_c == out:
            w(f"{base}.dense_proj.weight", out, in_c + out, 1, 1)
            bn(f"{base}.dense_bn", out)
        idx += 1
        if idx >= stage_lengths[stage - 1]:
            stage, idx = stage + 1, 0
    w("conv_final.weight", t["final_channels"], t["stage4"][-1][2], 1, 1)
    bn("bn_final", t["final_channels"])
    w("classifier.weight", classes, t["final_channels"])
    w("classifier.bias", classes)
    return sd


def _save(tmp_path, obj, name="upstream.pt"):
    path = tmp_path / name
    torch.save(obj, path)
    return path


def _clear_images(p, n=4, h=32, margin=1e-3):
    """Images whose every conv output lies `margin` or more from its
    channel's threshold (a float-rounding flip of the hard threshold would
    otherwise decide the comparison), drawn from a seeded pool."""
    rng = np.random.default_rng(7)
    stride = -(-(h - 1) // (GRID - 1))
    w = p["conv_w"].astype(np.float64)
    thr = np.broadcast_to(p["visual_threshold"].astype(np.float64), (CH,))
    kept = []
    while len(kept) < n:
        img = rng.random((h, h, 3), dtype=np.float32)
        pad = np.pad(img.astype(np.float64), ((1, 1), (1, 1), (0, 0)))
        conv = np.einsum("ijkhw,okhw->ijo", np.lib.stride_tricks.sliding_window_view(
            pad, (3, 3), axis=(0, 1))[::stride, ::stride], w)
        if np.abs(conv - thr).min() > margin:
            kept.append(img)
    return np.stack(kept)


def _assert_state_equal(model, params, stats=None):
    flat = {**bridge._flatten(params), **bridge._flatten(stats or {})}
    state = model.state_dict()
    assert set(state) == set(flat)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), np.broadcast_to(
            np.asarray(flat[k]), tuple(v.shape)), err_msg=k)


def test_nnue_params_equal_jax(tmp_path):
    sd = upstream_nnue_state_dict()
    path = _save(tmp_path, sd)
    model, cfg = timport.load_torch_nnue(path, device="cpu")
    jparams, jcfg = jimport.load_torch_nnue(path)
    _assert_state_equal(model, jparams)
    assert cfg.feature_set == timport.GridFeatureSet(GRID, CH)
    assert (cfg.l1_size, cfg.l2_size, cfg.l3_size, cfg.num_classes) == (
        jcfg.l1_size, jcfg.l2_size, jcfg.l3_size, jcfg.num_classes)
    # upstream `input.weight` is (F, L1), the layout the port keeps
    np.testing.assert_array_equal(model.ft_w.detach().numpy(),
                                  sd["input.weight"].numpy())


@pytest.mark.parametrize("threshold", [None, torch.tensor([0.1])],
                         ids=["per-channel", "one-element"])
def test_nnue_forward_matches_jax(tmp_path, threshold):
    """A one-element upstream threshold loads broadcast to (C,) and
    computes JAX's function, which broadcasts the (1,) it keeps."""
    path = _save(tmp_path, upstream_nnue_state_dict(seed=1, threshold=threshold))
    model, _ = timport.load_torch_nnue(path, device="cpu")
    jparams, jcfg = jimport.load_torch_nnue(path)
    assert model.visual_threshold.shape == (CH,)
    assert jparams["visual_threshold"].shape == ((CH,) if threshold is None else (1,))
    imgs = _clear_images(jparams)
    jl = jnnue.nnue_apply({k: jnp.asarray(v) for k, v in jparams.items()},
                          jnp.asarray(imgs), jcfg)
    with torch.no_grad():
        tl = model(torch.from_numpy(imgs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)


def test_nnue_wrapped_and_auto(tmp_path):
    sd = upstream_nnue_state_dict(seed=2)
    path = _save(tmp_path, {"state_dict": sd}, "wrapped.ckpt")
    model_type, model, cfg = timport.load_torch_checkpoint_auto(path, device="cpu")
    jtype, jparams, jstats, _ = jimport.load_torch_checkpoint_auto(path)
    assert model_type == jtype == "nnue" and jstats is None
    assert model.cfg == cfg
    _assert_state_equal(model, jparams)


@pytest.mark.parametrize("variant", ["micro", "0.98M"])
def test_etinynet_params_and_stats_equal_jax(tmp_path, variant):
    path = _save(tmp_path, upstream_etinynet_state_dict(variant))
    model, cfg = timport.load_torch_etinynet(path, device="cpu")
    jparams, jstats, jcfg = jimport.load_torch_etinynet(path)
    assert cfg.variant == jcfg.variant == variant
    assert cfg.num_classes == jcfg.num_classes == 10
    _assert_state_equal(model, jparams, jstats)


@pytest.mark.parametrize("variant", ["micro", "0.98M"])
def test_etinynet_forward_matches_jax(tmp_path, variant):
    path = _save(tmp_path, upstream_etinynet_state_dict(variant, seed=3))
    model, _ = timport.load_torch_etinynet(path, device="cpu")
    jparams, jstats, jcfg = jimport.load_torch_etinynet(path)
    x = np.random.default_rng(4).standard_normal((4, 32, 32, 3)).astype(np.float32)
    want, _ = jetiny.etinynet_apply(jparams, jstats, jnp.asarray(x), jcfg,
                                    train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_etinynet_wrapped_and_auto(tmp_path):
    path = _save(tmp_path, {"state_dict": upstream_etinynet_state_dict()},
                 "wrapped.ckpt")
    model_type, model, cfg = timport.load_torch_checkpoint_auto(path, device="cpu")
    jtype, jparams, jstats, _ = jimport.load_torch_checkpoint_auto(path)
    assert model_type == jtype == "etinynet"
    assert isinstance(model, tetiny.EtinyNet) and model.cfg == cfg
    _assert_state_equal(model, jparams, jstats)


def test_unknown_stem_width_raises(tmp_path):
    sd = upstream_etinynet_state_dict()
    sd["conv_initial.weight"] = torch.zeros(12, 3, 3, 3)
    path = _save(tmp_path, sd)
    with pytest.raises(ValueError, match="unknown stem width 12"):
        timport.load_torch_etinynet(path, device="cpu")
    with pytest.raises(ValueError, match="unknown stem width 12"):
        jimport.load_torch_etinynet(path)


def test_grid_that_does_not_divide_raises(tmp_path):
    sd = upstream_nnue_state_dict()
    sd["input.weight"] = torch.zeros(GRID * GRID * CH + 1, L1)
    with pytest.raises(ValueError, match="cannot infer grid"):
        timport.load_torch_nnue(_save(tmp_path, sd), device="cpu")


def test_unrecognized_checkpoint_raises(tmp_path):
    path = _save(tmp_path, {"encoder.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unrecognized torch checkpoint"):
        timport.load_torch_checkpoint_auto(path, device="cpu")


def test_sniff_true_on_torch_files(tmp_path):
    """Zip files in both packages; a legacy (protocol 2) file in the port
    only: the JAX sniff compares four bytes with two and never matches
    (a fault of the reference the port does not carry)."""
    sd = upstream_nnue_state_dict()
    zipped = _save(tmp_path, sd, "zip.pt")
    legacy = tmp_path / "legacy.pt"
    torch.save(sd, legacy, _use_new_zipfile_serialization=False)
    assert legacy.read_bytes()[:2] == b"\x80\x02"
    assert timport.is_torch_checkpoint(zipped) and jimport.is_torch_checkpoint(zipped)
    assert timport.is_torch_checkpoint(legacy)
    assert not jimport.is_torch_checkpoint(legacy)
    model, _ = timport.load_torch_nnue(legacy, device="cpu")
    np.testing.assert_array_equal(model.conv_w.detach().numpy(),
                                  sd["conv.weight"].numpy())


def test_sniff_false_on_both_packages_pickles(tmp_path):
    import jax

    from nnue_vision_tpu.training.checkpoint import save_checkpoint as jsave
    from nnue_vision_tpu_torch.models.nnue import NNUEConfig, nnue_init
    from nnue_vision_tpu_torch.training.checkpoint import save_checkpoint as tsave

    tcfg = NNUEConfig(feature_set=timport.GridFeatureSet(4, 4), l1_size=16,
                      l2_size=8, l3_size=4, num_classes=3, input_size=16)
    ours = tmp_path / "port.ckpt"
    tsave(ours, model_type="nnue", model_config=tcfg, epoch=0, metrics={},
          model=nnue_init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    jcfg = jnnue.NNUEConfig(**{f.name: getattr(tcfg, f.name)
                               for f in dataclasses.fields(jnnue.NNUEConfig)
                               if f.name != "feature_set"},
                            feature_set=jnnue.GridFeatureSet(4, 4))
    theirs = tmp_path / "jax.ckpt"
    jsave(theirs, model_type="nnue", model_config=jcfg, epoch=0, metrics={},
          params=jnnue.nnue_init(jax.random.PRNGKey(0), jcfg))
    for path in (ours, theirs):
        assert path.read_bytes()[:2] == b"\x80\x05"
        assert not timport.is_torch_checkpoint(path)
        assert not jimport.is_torch_checkpoint(path)
