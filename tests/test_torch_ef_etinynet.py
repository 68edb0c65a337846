"""The port's engine_friendly EtinyNet held against the JAX package's on the
same numpy params, norm statistics, LSQ scales and images: the quantizer
functions, the continuous (warm-up) and quantized forwards with their new
statistics, the loss gradients, the init, the `.etiny` bytes (directly and
through `serialize.py`), the engine sim on the quantized file, and the
loop's warm-up switch.

Every model here has non-trivial norm affines and running statistics and
nonzero `qlog`s (LSQ scales in [0.5, 1.5]), so each fold and each clip
bound is exercised.

Tolerances:
- the quantizer functions, values and gradients: bit-equal (inputs that lie
  exactly on the rails 0 and 6 included);
- logits and statistics: atol 1e-5, as `test_torch_etinynet.py` holds the
  plain model. The 0.75-width continuous forward is compared in eval mode:
  in training mode the batch statistics of 6 images over the 2×2 final map
  amplify the frameworks' summation orders past 1e-5 for the plain 0.75
  model too (1.4e-5), which is not an engine_friendly matter;
- a quantized forward rounds to 7 levels (and 1/16 at block boundaries):
  where the two frameworks' pre-activations straddle a rounding boundary
  by an ulp, a level flips. The test counts the flips site by site. An
  image without one is held to atol 1e-5; the images that hold one (in
  training mode the whole batch, whose statistics it shifts) to JAX's own
  float-against-engine bar, a relative logit error below 0.1
  (`tests/test_engine_friendly.py`). One flip early in the network moves
  the pre-activations of its receptive field and flips more there (0.75,
  eval mode: 84 of 315,648 values in 5 of 6 images, up to 30 in one), so
  the flips must stay below 1% of the quantized values, which a fault of
  a rounding mode, a scale or a fold would exceed;
- gradients: atol 1e-4 × max(1, the tensor's largest magnitude), the bar of
  `test_torch_etinynet.py`, the quantized ones with JAX run on the port's
  rounding decisions (a flipped level moves a training-mode gradient far
  past the bar, JAX against itself too), the flips counted; a parameter
  the ef forward does not use (the dense path, the scale-only norms'
  biases) has no gradient in the port and a zero one in JAX;
- `.etiny` bytes and the engine sim: exact.
"""

import dataclasses
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

from config import load_config
from nnue_vision_tpu import formats
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.training import checkpoint as jckpt
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from nnue_vision_tpu_torch.training import loop as tloop

REPO = Path(__file__).resolve().parent.parent
B, H = 6, 32
EF_CONFIGS = ("anchor_qat", "hard", "hard_scratch", "hard_ext", "hard_ext2")


def _cfgs(variant="micro", quantizers=True):
    kw = dict(variant=variant, num_classes=10, input_size=H,
              engine_friendly=True, ef_quantizers=quantizers)
    return jetiny.EtinyNetConfig(**kw), tetiny.EtinyNetConfig(**kw)


def _perturb(rng, tree):
    """Non-trivial norm affines, running statistics and LSQ scales."""
    if isinstance(tree, list):
        return [_perturb(rng, v) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _perturb(rng, v)
            continue
        lo, hi = {"scale": (0.6, 1.4), "bias": (-0.3, 0.3), "mean": (-0.3, 0.3),
                  "var": (0.5, 2.0), "qlog1": (-0.7, 0.4), "qlog2": (-0.7, 0.4),
                  "final_qlog": (-0.5, 0.4)}.get(k, (None, None))
        out[k] = (np.asarray(v) if lo is None
                  else rng.uniform(lo, hi, v.shape).astype(np.float32))
    return out


def _model(seed=0, variant="micro"):
    """(numpy params, numpy batch_stats) of an ef model from the JAX init."""
    jcfg, _ = _cfgs(variant)
    params, stats = jax.device_get(
        jetiny.etinynet_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    return _perturb(rng, params), _perturb(rng, stats)


def _images(seed=1, b=B):
    return np.random.default_rng(seed).standard_normal((b, H, H, 3)).astype(np.float32)


def _assert_tree_close(got, want, atol):
    flat_g, flat_w = bridge._flatten(got), bridge._flatten(want)
    assert set(flat_g) == set(flat_w)
    for k in flat_w:
        np.testing.assert_allclose(np.asarray(flat_g[k]), np.asarray(flat_w[k]),
                                   rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# (a) the quantizer functions
# ---------------------------------------------------------------------------


def _act_inputs(n=4096, seed=0):
    """x, s, g with x on the rails 0 and 6·s, on and between levels, and
    beyond the clip range."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.4, 1.7, n).astype(np.float32)
    x = rng.uniform(-2.0, 12.0, n).astype(np.float32)
    z = np.array([0.0, 6.0, 0.0, 6.0, 3.0, 2.5, 6.5, -0.5, 5.5, 0.5], np.float32)
    x[:z.size] = s[:z.size] * z
    g = rng.standard_normal(n).astype(np.float32)
    return x, s, g


def _jax_vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _torch_vjp(fn, args, g):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _bits_equal(jax_fn, torch_fn, args, g):
    want, want_g = _jax_vjp(jax_fn, args, g)
    got, got_g = _torch_vjp(torch_fn, args, g)
    np.testing.assert_array_equal(got, want)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        np.testing.assert_array_equal(a, b, err_msg=f"gradient of argument {i}")


@pytest.mark.parametrize("round_name", ["round", "floor"])
def test_q_act_lsq_bit_equal(round_name):
    """Values and the gradients of x and of the LSQ scale s, the rails
    included (ties at 0 and 6 pass half the gradient in both)."""
    x, s, g = _act_inputs()
    jr, tr = getattr(jnp, round_name), getattr(torch, round_name)
    _bits_equal(lambda a, b: jetiny._q_act_lsq(a, b, jr),
                lambda a, b: tetiny._q_act_lsq(a, b, tr), (x, s), g)
    got = tetiny._q_act_lsq(torch.from_numpy(x), torch.from_numpy(s), tr)
    z = (got / torch.from_numpy(s)).numpy()
    assert (np.abs(z[:4] - [0, 6, 0, 6]) < 1e-6).all()  # on the rails


def test_q_act_lsq_restore_and_s3_deploy_bit_equal():
    """The final block's form: the deployed restore multiplier
    round(64·s3)/64, straight through to s3."""
    x, s, g = _act_inputs(seed=1)

    def jfn(a, b):
        return jetiny._q_act_lsq(a, b, jnp.round,
                                 restore=jetiny._ste(b, jnp.round(b * 64.0) / 64.0))

    def tfn(a, b):
        return tetiny._q_act_lsq(a, b, torch.round, restore=tetiny.s3_deploy(b))

    _bits_equal(jfn, tfn, (x, s), g)


def test_q_grid16_and_ste_bit_equal():
    x, _, g = _act_inputs(seed=2)
    x[:6] = [127 / 16, -127 / 16, 8.5, -9.0, 0.03125, -0.03125]
    _bits_equal(jetiny._q_grid16, tetiny._q_grid16, (x,), g)
    q = np.round(x * 7.0) / 7.0
    _bits_equal(lambda a: jetiny._ste(a, jnp.asarray(q)),
                lambda a: tetiny._ste(a, torch.from_numpy(q)), (x,), g)


def test_wq_plain_bit_equal():
    rng = np.random.default_rng(3)
    w = rng.uniform(-2.5, 2.5, (10, 96)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    _bits_equal(lambda a: jetiny._wq_plain(a, 64.0),
                lambda a: tetiny._wq_plain(a, 64.0), (w,), g)


@pytest.mark.parametrize("form", ["out_mul", "in_mul"])
def test_wq_folded_bit_equal(form):
    """`_wq_folded` on a norm's running statistics with the LSQ scales'
    out- or in-channel multiplier. The norm gain g·rsqrt(var + eps) is an
    elementary function that the frameworks round differently (XLA's CPU
    rsqrt is neither torch's nor the correctly rounded one: they differ by
    an ulp on about a third of float32 inputs, and the gain then by one or
    two). So the output channels whose gain is equal in both are held
    bit-equal, values and gradients; the others to the few ulps that carry
    through the division by the gain (rtol 4e-7), with any level that flips
    counted (at most 1%). The gradient (straight through) is bit-equal
    everywhere."""
    rng = np.random.default_rng(3)
    w = rng.uniform(-0.4, 0.4, (1, 1, 96, 128)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    scale = rng.uniform(0.6, 1.4, 128).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 128).astype(np.float32)
    mul = np.exp(rng.uniform(-0.7, 0.4, 128 if form == "out_mul" else 96)
                 ).astype(np.float32)
    norm = tetiny.BatchNorm(128)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.var.copy_(torch.from_numpy(var))
    p, st = {"scale": jnp.asarray(scale)}, {"var": jnp.asarray(var)}
    want, (want_g,) = _jax_vjp(
        lambda a: jetiny._wq_folded(a, p, st, 64.0, **{form: jnp.asarray(mul)}),
        (w,), g)
    got, (got_g,) = _torch_vjp(
        lambda a: tetiny._wq_folded(a, norm, 64.0, **{form: torch.from_numpy(mul)}),
        (w,), g)
    np.testing.assert_array_equal(got_g, want_g)
    k_jax = np.asarray(jnp.asarray(scale) * jax.lax.rsqrt(jnp.asarray(var) + 1e-5))
    k_port = (norm.scale * torch.rsqrt(norm.var + 1e-5)).detach().numpy()
    same = k_jax == k_port
    assert same.sum() > 32 and (~same).sum() > 0  # both kinds occur
    assert (np.abs(k_jax.view(np.int32) - k_port.view(np.int32)) <= 2).all()
    np.testing.assert_array_equal(got[..., same], want[..., same])
    f = k_jax.reshape(1, 1, 1, -1) * (mul.reshape(1, 1, -1, 1) if form == "in_mul"
                                      else mul.reshape(1, 1, 1, -1))
    lv_got = np.round(got * f * 64.0)[..., ~same]
    lv_want = np.round(want * f * 64.0)[..., ~same]
    flips = lv_got != lv_want
    assert flips.mean() < 0.01
    np.testing.assert_allclose(got[..., ~same][~flips], want[..., ~same][~flips],
                               rtol=4e-7, atol=0)


# ---------------------------------------------------------------------------
# (b), (c) forwards and statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,train", [("micro", True), ("micro", False),
                                           ("0.75", False)],
                         ids=["micro-train", "micro-eval", "0.75-eval"])
def test_continuous_forward_and_stats_match_jax(variant, train):
    """The warm-up function (ef_quantizers=False): scale-only norms, no
    residual or dense path, clamps ±127/16 and [0, 6·s]."""
    jcfg, tcfg = _cfgs(variant, quantizers=False)
    params, stats = _model(seed=0, variant=variant)
    x = _images()
    want, want_stats = jetiny.etinynet_apply(params, stats, jnp.asarray(x), jcfg,
                                             train=train)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").train(train)
    got = model(torch.from_numpy(x))
    assert got.shape == (B, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    _, got_stats = bridge.etinynet_to_numpy(model)
    _assert_tree_close(got_stats, jax.device_get(want_stats), atol=1e-5)
    # the scale-only norms keep their running mean; the dense norms are not run
    flat = bridge._flatten(got_stats)
    for k, v in bridge._flatten(stats).items():
        if k.endswith(("bn2.mean", "bn3.mean")) or "dense_bn" in k:
            np.testing.assert_array_equal(flat[k], v, err_msg=k)


def _record_levels(monkeypatch, module, xp):
    """Wrap the module's activation quantizers so that each call records
    its integer levels, (B, ...) per site, in call order."""
    levels = []
    act, grid = module._q_act_lsq, module._q_grid16

    def lsq(x, s, round_fn, restore=None):
        levels.append(np.asarray(xp.clip(round_fn(x / s), 0.0, 6.0)))
        return act(x, s, round_fn, restore)

    def grid16(x):
        lim = 127.0 / 16.0
        levels.append(np.asarray(xp.trunc(xp.clip(x, -lim, lim) * 16.0)))
        return grid(x)

    monkeypatch.setattr(module, "_q_act_lsq", lsq)
    monkeypatch.setattr(module, "_q_grid16", grid16)
    return levels


@pytest.mark.parametrize("variant", ["micro", "0.75"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_quantized_forward_and_stats_match_jax(monkeypatch, variant, train):
    """The quantized function: folded weight grids from the running
    statistics before the step, LSQ 7-level activations, 1/16 block
    boundaries, the final block's deployed multiplier. Rounding flips are
    counted and bounded as the module docstring states."""
    jcfg, tcfg = _cfgs(variant)
    params, stats = _model(seed=1, variant=variant)
    x = _images(seed=2)
    jlevels = _record_levels(monkeypatch, jetiny, jnp)
    want, want_stats = jetiny.etinynet_apply(params, stats, jnp.asarray(x), jcfg,
                                             train=train)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").train(train)
    tlevels = _record_levels(monkeypatch, tetiny, torch)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert len(tlevels) == len(jlevels) == 1 + 3 * len(tcfg.block_specs()) + 1
    flips = np.zeros(B, np.int64)
    total = 0
    for t, j in zip(tlevels, jlevels):
        assert t.shape == j.shape
        flips += (t != j).reshape(B, -1).sum(axis=1)
        total += t.size
    assert flips.sum() * 100 < total, f"{flips.sum()} flips in {total}"
    held = flips > 0
    if train and held.any():
        held[:] = True  # the flip moved the batch statistics of every image
    err = np.abs(got - want).max(axis=1)
    rel = err / np.maximum(1e-3, np.abs(want).max(axis=1))
    assert (err[~held] <= 1e-5).all(), (err, flips)
    assert (rel[held] < 0.1).all(), (rel, flips)
    if not held.any():
        _, got_stats = bridge.etinynet_to_numpy(model)
        _assert_tree_close(got_stats, jax.device_get(want_stats), atol=1e-5)


# ---------------------------------------------------------------------------
# (d) loss and gradients
# ---------------------------------------------------------------------------


def _force_port_decisions(monkeypatch, decisions):
    """Make JAX's quantized forward take the port's rounding decisions:
    every straight-through site (`_ste`, `_wq_folded`, `_wq_plain`) uses the
    next recorded quantized value in place of its own, in call order (the
    list is consumed again from its start by each forward). Returns a list
    that the first forward fills with the count, per site, of the values
    where JAX's own decision differed; run it outside a transformation."""
    queue = []
    flips = []

    def take(own, step=None):
        """The forced value; a decision is the level own/step (a weight's
        step is 1/(scale·f), whose f differs by ulps between the
        frameworks), or the value itself."""
        if not queue:
            queue.extend(decisions)
        forced = queue.pop(0)
        assert forced.shape == own.shape
        if len(flips) < len(decisions):
            mine, theirs = np.asarray(own), forced
            if step is not None:
                mine, theirs = (np.round(np.asarray(v / step)) for v in (own, forced))
            flips.append(int((mine != theirs).sum()))
        return jnp.asarray(forced)

    def ste(x, quantized, step=None):
        return x + jax.lax.stop_gradient(take(quantized, step) - x)

    def wq_folded(w, norm_p, norm_s, scale, out_mul=None, in_mul=None):
        k = norm_p["scale"] * jax.lax.rsqrt(norm_s["var"] + jetiny.BN_EPS)
        if out_mul is not None:
            k = k * out_mul
        f = k.reshape((1, 1, 1, -1))
        if in_mul is not None:
            f = f * in_mul.reshape((1, 1, -1, 1))
        own = jnp.clip(jnp.round(w * f * scale), -127.0, 127.0) / (scale * f)
        return ste(w, own, 1.0 / (scale * f))

    def wq_plain(w, scale):
        return ste(w, jnp.clip(jnp.round(w * scale), -127.0, 127.0) / scale)

    monkeypatch.setattr(jetiny, "_ste", ste)
    monkeypatch.setattr(jetiny, "_wq_folded", wq_folded)
    monkeypatch.setattr(jetiny, "_wq_plain", wq_plain)
    return flips


@pytest.mark.parametrize("quantizers", [False, True], ids=["continuous", "quantized"])
def test_loss_grads_match_jax(monkeypatch, quantizers):
    """Loss and every gradient, the qlogs' included. A rounding decision
    that an ulp flips moves a training-mode gradient far past the bar (JAX
    against itself, jitted against eager, differs by 0.1 of the stem
    weight's gradient scale on this model for that reason). So the
    quantized comparison runs JAX on the port's decisions, recorded at
    every straight-through site, and counts where JAX's own differ (below
    1%); the gradients then hold the arithmetic to the bar."""
    jcfg, tcfg = _cfgs(quantizers=quantizers)
    params, stats = _model(seed=3)
    x = _images(seed=4)
    labels = np.random.default_rng(5).integers(0, 10, B)

    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").train()
    decisions = []
    real_ste = tetiny._ste

    def record(v, quantized):
        decisions.append(quantized.detach().numpy().copy())
        return real_ste(v, quantized)

    monkeypatch.setattr(tetiny, "_ste", record)
    loss = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(labels))
    loss.backward()

    def loss_fn(p):
        logits, _ = jetiny.etinynet_apply(p, stats, jnp.asarray(x), jcfg, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    if quantizers:
        flips = _force_port_decisions(monkeypatch, decisions)
        loss_fn(params)  # counts the flips
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    if quantizers:
        assert len(flips) == len(decisions) == 2 + 6 * len(tcfg.block_specs()) + 4
        assert sum(flips) * 100 < sum(d.size for d in decisions), flips
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    flat = bridge._flatten(jax.device_get(want_grads))
    unused = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            np.testing.assert_array_equal(flat[name], 0.0, err_msg=name)
            unused += 1
            continue
        scale = max(1.0, float(np.abs(flat[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), flat[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert unused > 0
    qlog = {n: p.grad for n, p in model.named_parameters() if "qlog" in n}
    assert len(qlog) == 2 * len(tcfg.block_specs()) + 1
    moved = [float(g.abs().max()) > 0 for g in qlog.values()]
    assert all(moved) if quantizers else any(moved)


# ---------------------------------------------------------------------------
# (e) init and parameter count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["micro", "0.75"])
def test_init_and_count_match_jax(variant):
    """The ef model builds (no refusal), has JAX's parameter count and
    names, bn1.bias at 1.5, and its LSQ scales at exp(0) = 1; the plain
    model of the same variant has no qlog."""
    jcfg, tcfg = _cfgs(variant)
    model = tetiny.etinynet_init(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    jp, _ = jetiny.etinynet_init(jax.random.PRNGKey(0), jcfg)
    assert tetiny.count_parameters(model) == jetiny.count_parameters(jp)
    tp, _ = bridge.etinynet_to_numpy(model)
    flat_t, flat_j = bridge._flatten(tp), bridge._flatten(jax.device_get(jp))
    assert {k: v.shape for k, v in flat_t.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    for k, v in flat_t.items():
        if "qlog" in k:
            np.testing.assert_array_equal(v, 0.0, err_msg=k)
        elif k.endswith("bn1.bias"):
            np.testing.assert_array_equal(v, 1.5, err_msg=k)
    plain = tetiny.EtinyNet(dataclasses.replace(tcfg, engine_friendly=False))
    assert not [n for n, _ in plain.named_parameters() if "qlog" in n]
    assert tetiny.count_parameters(model) - tetiny.count_parameters(plain) == sum(
        v.size for k, v in flat_t.items() if "qlog" in k)


def test_bf16_quantizers_warn_as_jax():
    with pytest.warns(UserWarning, match="quantizer grids"):
        tetiny.EtinyNetConfig(variant="micro", engine_friendly=True,
                              dtype="bfloat16")


# ---------------------------------------------------------------------------
# (f) the .etiny bytes and the checkpoints; (g) the engine sim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["micro", "0.75"])
def test_quantized_bytes_and_sim_equal_jax(tmp_path, variant):
    """The same ef params give the same `.etiny` bytes (the LSQ folds, the
    amplifier diag(64·s3), the +0.5 rounding biases), and the port's engine
    sim on that file gives the JAX sim's logits bit for bit."""
    jcfg, tcfg = _cfgs(variant)
    params, stats = _model(seed=9, variant=variant)
    qj = jetiny.etinynet_quantize(params, stats, jcfg)
    formats.write_etiny(qj, tmp_path / "jax.etiny")
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu")
    qt = tetiny.etinynet_quantize(model)
    formats.write_etiny(qt, tmp_path / "port.etiny")
    assert (tmp_path / "port.etiny").read_bytes() == \
        (tmp_path / "jax.etiny").read_bytes()
    diag = qt.blocks[-1].pw_project
    assert (diag != np.diag(np.diag(diag))).sum() == 0
    assert len(set(np.diag(diag).tolist())) > 1  # diag(64·s3), not 64·I

    x = _images(seed=10, b=5)
    tp, tc = tsim.etiny_sim_params(qt, device="cpu")
    got = tsim.etiny_engine_forward(tp, torch.from_numpy(x), cfg=tc, image_h=H,
                                    image_w=H).numpy()
    jp, jc = jsim.etiny_sim_params(qj)
    want = np.asarray(jsim.etiny_engine_forward(jp, jnp.asarray(x), cfg=jc,
                                                image_h=H, image_w=H))
    np.testing.assert_array_equal(got, want)


def test_checkpoints_round_trip_and_serialize(tmp_path):
    """`serialize.py --force` writes the same bytes from the port's ef
    checkpoint as from the JAX package's; each package's checkpoint loads
    into the port with its qlogs, statistics and config."""
    jcfg, tcfg = _cfgs()
    params, stats = _model(seed=11)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu")
    tckpt.save_checkpoint(tmp_path / "port.ckpt", model_type="etinynet",
                          model_config=tcfg, model=model, epoch=3, metrics={})
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", model_type="etinynet",
                          model_config=jcfg, params=params, batch_stats=stats,
                          epoch=3, metrics={})
    sys.path.insert(0, str(REPO))
    try:
        import serialize
    finally:
        sys.path.remove(str(REPO))
    outs = [serialize.serialize_checkpoint(tmp_path / f"{n}.ckpt",
                                           tmp_path / f"{n}.etiny", force=True)
            for n in ("port", "jax")]
    assert outs[0].read_bytes() == outs[1].read_bytes()
    for n in ("port", "jax"):
        back = tckpt.etinynet_from_checkpoint(
            tckpt.load_checkpoint(tmp_path / f"{n}.ckpt"), device="cpu")
        assert back.cfg == tcfg
        p2, s2 = bridge.etinynet_to_numpy(back)
        _assert_tree_close(p2, params, atol=0)
        _assert_tree_close(s2, stats, atol=0)


# ---------------------------------------------------------------------------
# (h) the warm-up switch in the loop
# ---------------------------------------------------------------------------


class _SwitchCfg:
    """`tests/test_progressive_qat.py`'s config, with a cosine schedule so
    the restart's schedule shows."""
    name = "two-phase-test"
    project_name = "test"
    dataset_name = "synthetic"
    batch_size = 8
    num_workers = 0
    max_epochs = 3
    ef_warmup_epochs = 2
    synthetic_size = 32
    etinynet_variant = "micro"
    engine_friendly = True
    num_classes = 10
    input_size = 32
    learning_rate = 0.001
    weight_decay = 0.0
    momentum = 0.9
    optimizer_type = "adam"
    max_grad_norm = 1.0
    use_cosine_scheduler = True
    decay_lr = False
    use_cyclical_lr = False
    use_augmentation = False
    augmentation_strength = "light"
    steps_per_dispatch = 2
    keep_alive = True
    seed = 0


def test_ef_warmup_switches_config(tmp_path, monkeypatch, capsys):
    """As `test_progressive_qat.py::test_ef_warmup_switches_config`: epochs
    0-1 train and evaluate the continuous ef model, epoch 2 the quantized
    one; the optimizer restarts at the switch with a cosine over the
    remaining epoch; only epoch 2 may become the best model, though the
    warm-up epochs score higher."""
    flags = []
    opts, opt_states = [], []

    def flag(model):
        return (model.cfg.engine_friendly, model.cfg.ef_quantizers)

    def fake_gathered(state, di, dl, idx, gen, *, optimizer, strength, augment,
                      noise_gen):
        flags.append(flag(state.model))
        opts.append(optimizer)
        opt_states.append(state.opt_state)
        return {"loss": torch.ones(()), "accuracy": torch.ones(())}

    def fake_scanned(state, di, dl, idx_chunk, gen, **kw):
        for idx in idx_chunk:
            fake_gathered(state, di, dl, idx, gen, optimizer=kw["optimizer"],
                          strength=kw["strength"], augment=kw["augment"],
                          noise_gen=kw["noise_gen"])
        return {"loss": torch.ones(len(idx_chunk)),
                "accuracy": torch.ones(len(idx_chunk))}

    eval_flags = []
    f1s = iter([0.9, 0.9, 0.8, 0.8, 0.7, 0.7, 0.5])

    def fake_eval(model, loader, *, mesh=None):
        eval_flags.append(flag(model))
        return 1.0, {"f1": next(f1s), "acc": 0.5}

    def fake_int8(model, loader, *, use_pallas=False, mesh=None):
        eval_flags.append(flag(model))
        return {"f1": 0.5, "acc": 0.5, "ms_per_sample": 0.0, "latent_density": 0.0}

    saved = []
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.setattr(tloop, "gathered_train_step", fake_gathered)
    monkeypatch.setattr(tloop, "scanned_train_steps", fake_scanned)
    monkeypatch.setattr(tloop, "evaluate_model", fake_eval)
    monkeypatch.setattr(tloop, "evaluate_int8_sim", fake_int8)
    monkeypatch.setattr(tloop.ckpt, "save_checkpoint",
                        lambda path, **kw: saved.append(kw))
    cfg = _SwitchCfg()
    cfg.log_dir = str(tmp_path)
    assert tloop.train_model(cfg, "etinynet", device="cpu") == 0

    warm, quant = (True, False), (True, True)
    assert flags == [warm] * 8 + [quant] * 4  # 4 steps per epoch
    assert eval_flags[:3] == [warm] * 3 and eval_flags[3:6] == [warm] * 3
    assert eval_flags[6:9] == [quant] * 3 and eval_flags[-1] == quant  # + test
    assert len(set(map(id, opts[:8]))) == 1 and len(set(map(id, opts[8:]))) == 1
    warm_opt, ft_opt = opts[0], opts[8]
    assert ft_opt is not warm_opt
    assert opt_states[8] is not opt_states[7] and opt_states[8]["count"] == 0
    assert ft_opt.schedule(0) == warm_opt.schedule(0)
    assert ft_opt.schedule(4) == 0.0 < warm_opt.schedule(4)
    assert "quantizer switch at epoch 2" in capsys.readouterr().out
    assert [kw["epoch"] for kw in saved] == [2]
    assert saved[0]["model_config"].ef_quantizers


def test_train_model_ef_on_cpu(tmp_path, monkeypatch):
    """A real two-epoch run of the test config with engine_friendly on and
    one warm-up epoch: finite losses, the qlogs trained away from zero, and
    the best checkpoint from the quantized epoch, whose int8 sim reproduces
    that epoch's compiled metrics."""
    from nnue_vision_tpu_torch.training.evaluate import evaluate_int8_sim

    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(REPO / "config" / "train_etinynet_test.py"))
    cfg.log_dir = str(tmp_path / "logs")
    cfg.engine_friendly = True
    cfg.ef_warmup_epochs = 1
    cfg.max_epochs = 2
    assert tloop.train_model(cfg, "etinynet", device="cpu") == 0
    metrics = next((tmp_path / "logs" / "runs").rglob("metrics.jsonl"))
    import json

    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 16 and all(math.isfinite(v) for v in losses)
    payload = tckpt.load_checkpoint(
        next((tmp_path / "logs" / "checkpoints").rglob("best_model.ckpt")))
    assert payload["epoch"] == 1
    assert payload["model_config"]["engine_friendly"]
    assert payload["model_config"]["ef_quantizers"]
    qlogs = [v for k, v in bridge._flatten(payload["params"]).items() if "qlog" in k]
    assert qlogs and all(np.abs(v).max() > 0 for v in qlogs)
    model = tckpt.etinynet_from_checkpoint(payload, device="cpu")
    loader = tloop.create_data_loaders(
        dataset_name=cfg.dataset_name, batch_size=cfg.batch_size,
        max_samples_per_split=cfg.max_samples_per_split, seed=cfg.seed)[1]
    epoch = [r for r in records if "compiled/f1" in r][1]
    assert evaluate_int8_sim(model, loader)["acc"] == epoch["compiled/accuracy"]


@pytest.mark.parametrize("name", EF_CONFIGS)
def test_synthetic_hard_ef_configs_are_not_refused(monkeypatch, name):
    """Each synthetic-hard engine_friendly config passes the loop's
    refusals and builds its model."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    cfg = load_config(str(REPO / "config" / f"train_etinynet_{name}.py"))
    assert cfg.engine_friendly and cfg.dataset_name == "synthetic-hard"
    tloop._check_backend(cfg)
    model, mcfg = tloop.build_model(cfg, "etinynet", torch.Generator().manual_seed(0),
                                    "cpu")
    assert mcfg.engine_friendly and mcfg.ef_quantizers
    assert hasattr(model, "final_qlog")


def test_deploy_etiny_cli_on_cpu(tmp_path, capsys):
    """`deploy_etiny` on a JAX ef checkpoint: the `.etiny` it writes is the
    JAX quantizer's file, its int8 accuracy is the JAX sim's on the same
    val images, and its float accuracy the port model's."""
    import json

    from nnue_vision_tpu_torch import deploy_etiny
    from nnue_vision_tpu_torch.data.augment import normalize_images

    jcfg, tcfg = _cfgs()
    params, stats = _model(seed=12)
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", model_type="etinynet",
                          model_config=jcfg, params=params, batch_stats=stats,
                          epoch=4, metrics={})
    config = str(REPO / "config" / "train_etinynet_test.py")
    assert deploy_etiny.main([str(tmp_path / "jax.ckpt"), "--config", config,
                              "--max_samples", "16", "--out",
                              str(tmp_path / "port.etiny"), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 16 and out["checkpoint_epoch"] == 4
    assert out["k6_max_abs_err_vs_sim"] is None and out["device"] == "cpu"
    q = jetiny.etinynet_quantize(params, stats, jcfg)
    formats.write_etiny(q, tmp_path / "jax.etiny")
    assert (tmp_path / "port.etiny").read_bytes() == (tmp_path / "jax.etiny").read_bytes()
    cfg = load_config(config)
    val = tloop.create_data_loaders(
        dataset_name=cfg.dataset_name, batch_size=16, max_samples_per_split=16,
        seed=cfg.seed)[1].dataset
    x = normalize_images(torch.from_numpy(val.images))  # as the CLI does
    jp, jc = jsim.etiny_sim_params(q)
    il = np.asarray(jsim.etiny_engine_forward(jp, jnp.asarray(x.numpy()), cfg=jc,
                                              image_h=H, image_w=H))
    assert out["int8_acc"] == float((il.argmax(1) == val.labels).mean())
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").eval()
    with torch.no_grad():
        fl = model(x).numpy()
    assert out["float_acc"] == float((fl.argmax(1) == val.labels).mean())
    assert out["agree"] == float((fl.argmax(1) == il.argmax(1)).mean())
    assert 0.0 <= out["rel_err_median"] <= out["rel_err_p90"] <= out["rel_err_max"]
