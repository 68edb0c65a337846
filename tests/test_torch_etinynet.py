"""The port's EtinyNet held against the JAX package's on the same numpy
params, batch statistics and images: forward logits and new batch
statistics in training and eval mode, the gradients of the cross-entropy
loss, the bf16 forward, the init, the bridge, and the `.etiny` bytes of
the quantizer, directly and through `serialize.py`.

Tolerances: in float32 the two frameworks sum in other orders, so logits,
statistics agree to atol 1e-5. A gradient tensor agrees to atol 1e-4 times
max(1, its largest magnitude): with batch statistics of 6 images every
gradient passes through a dozen norms, and the worst error measured over
four seeds was 4.9e-5 of that scale (a stem gradient reaches ~20, where
float32 rounding of its ~1,500-term sum alone is ~1e-4). In bfloat16 both round every
conv and matmul output to 8 bits of mantissa, so the port's bf16 logits
are held to twice JAX's own bf16-against-float32 error (see the test). The `.etiny` bytes are compared exactly.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from nnue_vision_tpu import formats
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.training import checkpoint as jckpt
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.training import checkpoint as tckpt

REPO = Path(__file__).resolve().parent.parent
B, H = 6, 32


def _cfgs(variant="micro", dtype="float32", num_classes=10):
    kw = dict(variant=variant, num_classes=num_classes, input_size=H, dtype=dtype)
    return jetiny.EtinyNetConfig(**kw), tetiny.EtinyNetConfig(**kw)


def _perturb(rng, tree, key):
    """Give every norm a non-trivial affine and running statistics."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = _perturb(rng, v, k)
            elif k == "scale":
                out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            elif k == "bias" or k == "mean":
                out[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return [_perturb(rng, v, key) for v in tree]


def _model(seed=0, variant="micro"):
    """(numpy params, numpy batch_stats) from the JAX init, perturbed."""
    jcfg, _ = _cfgs(variant)
    params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    return _perturb(rng, params, ""), _perturb(rng, stats, "")


def _images(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, H, H, 3)).astype(np.float32)


def _assert_tree_close(got, want, atol):
    flat_g, flat_w = bridge._flatten(got), bridge._flatten(want)
    assert set(flat_g) == set(flat_w)
    for k in flat_w:
        np.testing.assert_allclose(np.asarray(flat_g[k]), np.asarray(flat_w[k]),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_and_stats_match_jax_f32(train):
    """Logits and the new batch statistics (JAX's `new_stats`; the port's
    buffers after the forward) on a model with a DLB block's dense path."""
    jcfg, tcfg = _cfgs()
    assert any(s[5] and s[4] == 1 and s[1] == s[3] for s in tcfg.block_specs())
    params, stats = _model()
    x = _images()
    want, want_stats = jetiny.etinynet_apply(params, stats, jnp.asarray(x), jcfg,
                                             train=train)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu")
    model.train(train)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    _, got_stats = bridge.etinynet_to_numpy(model)
    _assert_tree_close(got_stats, jax.device_get(want_stats), atol=1e-5)


def test_loss_grads_match_jax_f32():
    jcfg, tcfg = _cfgs()
    params, stats = _model(seed=3)
    x = _images(seed=4)
    labels = np.random.default_rng(5).integers(0, 10, B)

    def loss_fn(p):
        logits, _ = jetiny.etinynet_apply(p, stats, jnp.asarray(x), jcfg, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").train()
    loss = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    flat = bridge._flatten(jax.device_get(want_grads))
    for name, p in model.named_parameters():
        scale = max(1.0, float(np.abs(flat[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), flat[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_bf16_forward_matches_jax():
    """bf16 convs and matmuls, float32 norms, statistics and logits. The
    port's bf16 logits stay as close to JAX's bf16 logits as JAX's bf16
    logits are to its own float32 ones (times 2, plus 1e-3 of the logits'
    scale): in eval mode they were equal on these inputs; in training mode
    the batch-of-6 statistics amplify one bf16 rounding that differs."""
    params, stats = _model(seed=6)
    x = _images(seed=7)
    for train in (True, False):
        out = {}
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(dtype=dtype)
            want, want_stats = jetiny.etinynet_apply(
                params, stats, jnp.asarray(x), jcfg, train=train)
            model = bridge.etinynet_from_jax(params, stats, tcfg,
                                             device="cpu").train(train)
            got = model(torch.from_numpy(x)).detach().numpy()
            assert got.dtype == np.float32
            out[dtype] = (got, np.asarray(want))
        got, want = out["bfloat16"]
        own = float(np.abs(want - out["float32"][1]).max())
        bound = 2 * own + 1e-3 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)
        _, got_stats = bridge.etinynet_to_numpy(model)
        flat_g = bridge._flatten(got_stats)
        for k, v in bridge._flatten(jax.device_get(want_stats)).items():
            np.testing.assert_allclose(flat_g[k], v, rtol=3e-2, atol=3e-2, err_msg=k)


def test_init_distributions_and_count():
    """Every conv U(±1/√fan_in), norms at 1/0, running stats at 0/1, and the
    parameter count equal to the JAX package's for each variant."""
    for variant in ("micro", "0.98M"):
        jcfg, tcfg = _cfgs(variant)
        model = tetiny.etinynet_init(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        jp, js = jetiny.etinynet_init(jax.random.PRNGKey(0), jcfg)
        assert tetiny.count_parameters(model) == jetiny.count_parameters(jp)
        tp, ts = bridge.etinynet_to_numpy(model)
        flat_j, flat_t = bridge._flatten(jax.device_get(jp)), bridge._flatten(tp)
        assert {k: v.shape for k, v in flat_t.items()} == \
            {k: v.shape for k, v in flat_j.items()}
        for k, v in flat_t.items():
            leaf = k.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias"):
                np.testing.assert_array_equal(v, flat_j[k], err_msg=k)
                continue
            fan_in = (v.shape[1] if leaf == "cls_w" else
                      tcfg.table["final_channels"] if leaf == "cls_b" else
                      v.shape[0] * v.shape[1] * v.shape[2])
            bound = 1.0 / math.sqrt(fan_in)
            assert np.abs(v).max() <= bound, k
            if v.size >= 500:
                assert np.abs(v).max() > 0.9 * bound, k
                assert abs(float(v.mean())) < 0.1 * bound, k
        for k, v in bridge._flatten(ts).items():
            np.testing.assert_array_equal(v, 0.0 if k.endswith("mean") else 1.0)


def test_bridge_round_trip():
    params, stats = _model(seed=8)
    _, tcfg = _cfgs()
    p2, s2 = bridge.etinynet_to_numpy(
        bridge.etinynet_from_jax(params, stats, tcfg, device="cpu"))
    _assert_tree_close(p2, params, atol=0)
    _assert_tree_close(s2, stats, atol=0)
    assert isinstance(p2["blocks"], list) and "dense_proj_w" in p2["blocks"][-1]


@pytest.mark.parametrize("variant", ["micro", "0.98M"])
def test_quantized_bytes_equal_jax(tmp_path, variant):
    """The same float params and statistics give the same `.etiny` bytes."""
    jcfg, tcfg = _cfgs(variant)
    params, stats = _model(seed=9, variant=variant)
    formats.write_etiny(jetiny.etinynet_quantize(params, stats, jcfg),
                        tmp_path / "jax.etiny")
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu")
    formats.write_etiny(tetiny.etinynet_quantize(model), tmp_path / "port.etiny")
    assert (tmp_path / "port.etiny").read_bytes() == \
        (tmp_path / "jax.etiny").read_bytes()


def test_serialize_reads_a_port_checkpoint(tmp_path):
    """`serialize.py --force` writes the same bytes from the port's
    checkpoint as from the JAX package's checkpoint of the same model."""
    jcfg, tcfg = _cfgs()
    params, stats = _model(seed=10)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu")
    tckpt.save_checkpoint(tmp_path / "port.ckpt", model_type="etinynet",
                          model_config=tcfg, model=model, epoch=0, metrics={})
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", model_type="etinynet",
                          model_config=jcfg, params=params, batch_stats=stats,
                          epoch=0, metrics={})
    sys.path.insert(0, str(REPO))
    try:
        import serialize
    finally:
        sys.path.remove(str(REPO))
    outs = [serialize.serialize_checkpoint(tmp_path / f"{n}.ckpt",
                                           tmp_path / f"{n}.etiny", force=True)
            for n in ("port", "jax")]
    assert outs[0].read_bytes() == outs[1].read_bytes()
    back = tckpt.etinynet_from_checkpoint(
        tckpt.load_checkpoint(tmp_path / "port.ckpt"), device="cpu")
    _assert_tree_close(bridge.etinynet_to_numpy(back)[1], stats, atol=0)
