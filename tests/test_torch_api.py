"""The port's model facade (`nnue_vision_tpu_torch/models/api.py`) held to
the JAX package's (`nnue_vision_tpu/models/api.py`) with the same params
carried across: outputs at the model tests' bars (NNUE atol 1e-4 / rtol
1e-5, EtinyNet atol 1e-5), `count_parameters`, the quantized arrays,
`set_visual_threshold`, `count_flops` per variant and the running
statistics a `train=True` call leaves."""

import jax
import numpy as np
import pytest
import torch

from nnue_vision_tpu import formats as jformats
from nnue_vision_tpu.models import api as japi
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch import formats as tformats
from nnue_vision_tpu_torch.models import api as tapi
from nnue_vision_tpu_torch.models import nnue as tnnue
from tests.test_torch_serialize import _nnue_params

NNUE_KW = dict(l1_size=16, l2_size=8, l3_size=4, num_classes=3, input_size=12)


def _nnue_pair(seed=0):
    p = _nnue_params(seed)
    j = japi.NNUE(feature_set=jnnue.GridFeatureSet(4, 6), **NNUE_KW, params=p)
    t = tapi.NNUE(feature_set=tnnue.GridFeatureSet(4, 6), **NNUE_KW, params=p,
                  device="cpu")
    return j, t


def _clear_images(p, n=5, h=12, margin=1e-3):
    """Images whose conv outputs all lie `margin` or more from the
    thresholds, from a seeded pool (a float-rounding flip of the hard
    threshold would decide the comparison otherwise)."""
    rng = np.random.default_rng(21)
    w = p["conv_w"].astype(np.float64)
    thr = p["visual_threshold"].astype(np.float64)
    stride = -(-(h - 1) // 3)
    kept = []
    while len(kept) < n:
        img = rng.random((h, h, 3), dtype=np.float32)
        pad = np.pad(img.astype(np.float64), ((1, 1), (1, 1), (0, 0)))
        win = np.lib.stride_tricks.sliding_window_view(pad, (3, 3), axis=(0, 1))
        conv = np.einsum("ijkhw,okhw->ijo", win[::stride, ::stride], w)
        if np.abs(conv - thr).min() > margin:
            kept.append(img)
    return np.stack(kept)


def _etiny_pair(variant="micro", seed=0):
    j = japi.EtinyNet(variant=variant, num_classes=10, input_size=32, seed=seed)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(  # non-trivial running statistics
        lambda v: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32),
        jax.device_get(j.batch_stats))
    j.batch_stats = stats
    t = tapi.EtinyNet(variant=variant, num_classes=10, input_size=32,
                      params=jax.device_get(j.params), batch_stats=stats,
                      device="cpu")
    return j, t


def test_nnue_outputs_and_aux_match_jax():
    j, t = _nnue_pair(1)
    x = _clear_images(j.params)
    jl, jaux = j(x, return_aux=True)
    with torch.no_grad():
        tl, taux = t(x, return_aux=True)
        assert torch.equal(t(torch.from_numpy(x)), tl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(taux["mask"].numpy(), np.asarray(jaux["mask"]))
    np.testing.assert_array_equal(taux["density"].numpy(), np.asarray(jaux["density"]))


def test_nnue_attributes_and_count_match_jax():
    j, t = _nnue_pair(2)
    for name in ("l1_size", "l2_size", "l3_size", "num_classes", "input_size"):
        assert getattr(t, name) == getattr(j, name), name
    assert (t.feature_set.grid_size, t.feature_set.num_features_per_square) == (
        j.feature_set.grid_size, j.feature_set.num_features_per_square)
    assert t.count_parameters() == j.count_parameters()
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k], np.asarray(v), err_msg=k)


def test_nnue_quantized_model_data_equal_jax():
    j, t = _nnue_pair(3)
    jd = bridge._flatten(j.get_quantized_model_data())
    td = bridge._flatten(t.get_quantized_model_data())
    assert set(jd) == set(td)
    for k, v in jd.items():
        if k == "metadata.feature_set":
            assert (td[k].grid_size, td[k].num_features_per_square) == (
                v.grid_size, v.num_features_per_square)
        else:
            np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(v), err_msg=k)
            assert np.asarray(td[k]).dtype == np.asarray(v).dtype, k


def test_nnue_set_visual_threshold_matches_jax(tmp_path):
    j, t = _nnue_pair(4)
    j.set_visual_threshold(0.2)
    t.set_visual_threshold(0.2)
    np.testing.assert_array_equal(t.visual_threshold, np.asarray(j.visual_threshold))
    assert t.visual_threshold.shape == (6,)
    jformats.write_nnue(j.quantize(), tmp_path / "j.nnue")
    tformats.write_nnue(t.quantize(), tmp_path / "t.nnue")
    assert (tmp_path / "j.nnue").read_bytes() == (tmp_path / "t.nnue").read_bytes()


def test_nnue_seed_builds_the_init_of_the_seed():
    a = tapi.NNUE(feature_set=tnnue.GridFeatureSet(4, 6), **NNUE_KW, seed=5,
                  device="cpu")
    b = tnnue.nnue_init(a.cfg, torch.Generator().manual_seed(5), device="cpu")
    for k, v in b.state_dict().items():
        assert torch.equal(a.module.state_dict()[k], v), k
    assert not torch.equal(a.module.ft_w, tapi.NNUE(
        feature_set=tnnue.GridFeatureSet(4, 6), **NNUE_KW, seed=6,
        device="cpu").module.ft_w)


@pytest.mark.parametrize("variant", ["micro", "0.75", "0.98M", "1.0"])
def test_count_flops_equals_jax(variant):
    """The MAC rule needs no params: the JAX facade gets an empty tree
    (its init would only cost time)."""
    cfg = dict(variant=variant, num_classes=10, input_size=32)
    t = tapi.EtinyNet(**cfg, device="cpu")
    assert t.count_flops() == japi.EtinyNet(**cfg, params={}).count_flops() > 0


def test_count_flops_at_the_default_input_equals_jax():
    from benchmarks.mcu_simulation import count_mac_operations

    assert tapi.count_mac_operations(tapi.EtinyNet(device="cpu").cfg) == \
        count_mac_operations(japi.EtinyNet(params={}))


def test_etinynet_eval_outputs_and_quantize_match_jax(tmp_path):
    j, t = _etiny_pair(seed=7)
    x = np.random.default_rng(8).standard_normal((4, 32, 32, 3)).astype(np.float32)
    jl = j(x)
    with torch.no_grad():
        tl = t(x)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for name in ("variant", "num_classes", "input_size", "use_asq",
                 "final_channels", "configs"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.count_parameters() == j.count_parameters()
    jformats.write_etiny(j.quantize(), tmp_path / "j.etiny")
    tformats.write_etiny(t.quantize(), tmp_path / "t.etiny")
    assert (tmp_path / "j.etiny").read_bytes() == (tmp_path / "t.etiny").read_bytes()


def test_etinynet_train_call_updates_running_stats_like_jax():
    j, t = _etiny_pair(seed=9)
    before = bridge._flatten(t.batch_stats)
    x = np.random.default_rng(10).standard_normal((6, 32, 32, 3)).astype(np.float32)
    jl = j(x, train=True)
    with torch.no_grad():
        tl = t(x, train=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    got, want = bridge._flatten(t.batch_stats), bridge._flatten(
        jax.device_get(j.batch_stats))
    assert set(got) == set(want)
    assert any(not np.array_equal(got[k], before[k]) for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # an eval call after it leaves them as they are
    with torch.no_grad():
        t(x)
    for k, v in bridge._flatten(t.batch_stats).items():
        np.testing.assert_array_equal(v, got[k])
