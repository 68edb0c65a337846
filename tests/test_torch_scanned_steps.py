"""`scanned_train_steps` (K train steps in one dispatch) in the port: held
to the JAX package's function on the same numpy inputs, to K
`gathered_train_step` calls bit for bit on every tier and with a teacher,
the in-place optimizer with per-chunk scalar vectors to the eager update
bit for bit, and the loop's routing of full chunks.

Sizes are `tests/test_scanned_steps.py`'s: a grid-4, L1-16 NNUE (and a
micro EtinyNet) on 16×16 images, K = 4 steps of batch 8. Tolerance against
JAX: float32 sums run in another order in XLA and in torch. The losses of
both families and the NNUE's params are held to that test's own bar
(losses rtol 2e-5, params rtol 1e-5 and atol 1e-7). The EtinyNet's params
miss it (a norm bias after 4 steps: 3.6e-7 apart on 6.5e-4), because every
gradient passes through a dozen norms over a batch of 8; they are held to
the repository's EtinyNet bar instead (`tests/test_torch_etinynet.py`: a
gradient to 1e-4 of max(1, its largest magnitude)), carried to the chunk:
each param to 1e-4 of max(LR, its largest update), each running statistic
to 1e-4 of max(1, its largest magnitude) (measured: 4.1e-5 and 9.4e-6 of
those scales). Everything inside the port is `torch.equal`: on the CPU
the scanned chunk runs the same operations on the same values as the
step-by-step one.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import optim as joptim
from nnue_vision_tpu.training import step as jstep
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data.augment import device_generator
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import optim as toptim
from nnue_vision_tpu_torch.training import step as tstep

K_STEPS, BATCH, N, H = 4, 8, 64, 16
NNUE_WIDTHS = dict(l1_size=16, l2_size=8, l3_size=4, num_classes=3, input_size=H)
OPT = dict(learning_rate=0.05, weight_decay=1e-4, momentum=0.9,
           optimizer_type="sgd", max_grad_norm=1.0, use_cosine_scheduler=False,
           max_epochs=1, decay_lr=False, use_cyclical_lr=False)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((N, H, H, 3), dtype=np.float32)
    labels = rng.integers(0, 3, N).astype(np.int64)
    idx = rng.integers(0, N, (K_STEPS, BATCH))
    return images, labels, idx


def _nnue_pair():
    jcfg = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(4, 4), **NNUE_WIDTHS)
    tcfg = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 4), **NNUE_WIDTHS)
    p = jax.tree_util.tree_map(np.asarray, jnnue.nnue_init(jax.random.PRNGKey(0), jcfg))
    return ("nnue", jcfg, (p, None),
            bridge.nnue_from_jax_params(p, tcfg, device="cpu"))


def _etiny_pair():
    kw = dict(variant="micro", num_classes=3, input_size=H)
    jcfg = jetiny.EtinyNetConfig(**kw)
    params, stats = jetiny.etinynet_init(jax.random.PRNGKey(0), jcfg)
    params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (params, stats))
    return ("etinynet", jcfg, (params, stats),
            bridge.etinynet_from_jax(params, stats, tetiny.EtinyNetConfig(**kw),
                                     device="cpu"))


@pytest.mark.parametrize("family", ["nnue", "etinynet"])
def test_scanned_steps_match_jax(family):
    """(a) The port's scanned chunk against JAX's with augment=False: the
    per-step losses and the params after the chunk."""
    model_type, jcfg, (p, stats), model = (_nnue_pair() if family == "nnue"
                                           else _etiny_pair())
    images, labels, idx = _data()
    cfg = types.SimpleNamespace(**OPT)
    jopt = joptim.create_optimizer(cfg, steps_per_epoch=K_STEPS)
    jparams = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jstep.make_train_state(
        jparams, jopt, None if stats is None
        else jax.tree_util.tree_map(jnp.asarray, stats))
    jstate, jm = jstep.scanned_train_steps(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(idx),
        jax.random.PRNGKey(7), model_type=model_type, model_cfg=jcfg,
        optimizer=jopt, strength="light", augment=False)

    topt = toptim.create_optimizer(cfg, steps_per_epoch=K_STEPS)
    state = tstep.make_train_state(model, topt)
    tm = tstep.scanned_train_steps(
        state, torch.from_numpy(images), torch.from_numpy(labels), idx,
        torch.Generator().manual_seed(7), optimizer=topt, augment=False)

    assert tm["loss"].shape == (K_STEPS,) and state.step == K_STEPS
    assert state.opt_state["count"] == K_STEPS
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=2e-5)
    if family == "nnue":
        got = bridge.nnue_to_numpy(model)
        want = jax.tree_util.tree_map(np.asarray, jstate.params)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        return
    got_p, got_s = (bridge._flatten(t) for t in bridge.etinynet_to_numpy(model))
    want_p, want_s = (bridge._flatten(jax.tree_util.tree_map(np.asarray, t))
                      for t in (jstate.params, jstate.batch_stats))
    init = bridge._flatten(p)
    assert set(got_p) == set(want_p) and set(got_s) == set(want_s)
    for name, w in want_p.items():
        scale = max(OPT["learning_rate"], float(np.abs(w - init[name]).max()))
        np.testing.assert_allclose(got_p[name], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    for name, w in want_s.items():
        np.testing.assert_allclose(got_s[name], w, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (b) scanned == K gathered steps, bit for bit
# ---------------------------------------------------------------------------


def _tnnue(seed=0):
    cfg = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 4), **NNUE_WIDTHS)
    return tnnue.nnue_init(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _tetiny(seed=0):
    cfg = tetiny.EtinyNetConfig(variant="micro", num_classes=3, input_size=H)
    return tetiny.etinynet_init(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")


CASES = {
    "light": dict(model=_tnnue, strength="light"),
    "medium": dict(model=_tnnue, strength="medium"),
    "heavy": dict(model=_tetiny, strength="heavy"),
    "teacher": dict(model=_tetiny, strength="heavy", teacher=True, adam=True),
}


def _gen_copy(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


@pytest.mark.parametrize("case", list(CASES))
def test_scanned_equals_gathered_steps(case):
    """(b) One scanned chunk and K `gathered_train_step` calls from equal
    states and generators: equal metrics, params, norm statistics,
    optimizer state, counts and generator states."""
    spec = CASES[case]
    images, labels, idx = _data(1)
    cfg = types.SimpleNamespace(**{**OPT, "use_cosine_scheduler": True,
                                   "warmup_iters": 2, "max_epochs": 3})
    if spec.get("adam"):
        cfg.optimizer_type = "adam"
    opt = toptim.create_optimizer(cfg, steps_per_epoch=K_STEPS)
    kw = dict(optimizer=opt, strength=spec["strength"])
    if spec.get("teacher"):
        kw["teacher"] = tstep.Teacher(_tetiny(3).eval().requires_grad_(False),
                                      alpha=0.3, temp=4.0)
    model = spec["model"]()
    gen = torch.Generator().manual_seed(11)
    noise = device_generator(gen, "cpu")
    states = [tstep.make_train_state(m, opt) for m in (model, copy.deepcopy(model))]
    gens = [gen, _gen_copy(gen)]
    noises = [noise, _gen_copy(noise)]
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    # one chunk in, so the optimizer's count and moments are not at zero
    tstep.scanned_train_steps(states[0], x, y, idx, gens[0], noise_gen=noises[0],
                              **kw)
    for i in idx:
        tstep.gathered_train_step(states[1], x, y, i, gens[1],
                                  noise_gen=noises[1], **kw)

    got = tstep.scanned_train_steps(states[0], x, y, idx, gens[0],
                                    noise_gen=noises[0], **kw)
    want = [tstep.gathered_train_step(states[1], x, y, i, gens[1],
                                      noise_gen=noises[1], **kw) for i in idx]
    for key in ("loss", "accuracy"):
        assert torch.equal(got[key], torch.stack([m[key] for m in want])), key
    a, b = states
    assert a.step == b.step == 2 * K_STEPS
    assert a.opt_state["count"] == b.opt_state["count"] == 2 * K_STEPS
    for (name, t), (_, u) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        assert torch.equal(t, u), name
    for k, v in a.opt_state.items():
        if k != "count":
            for name, t in v.items():
                assert torch.equal(t, b.opt_state[k][name]), (k, name)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert torch.equal(noises[0].get_state(), noises[1].get_state())


def test_scanned_steps_need_a_noise_generator_for_the_warp_tiers():
    images, labels, idx = _data()
    opt = toptim.create_optimizer(types.SimpleNamespace(**OPT))
    state = tstep.make_train_state(_tnnue(), opt)
    with pytest.raises(ValueError, match="noise_gen"):
        tstep.scanned_train_steps(state, torch.from_numpy(images),
                                  torch.from_numpy(labels), idx,
                                  torch.Generator(), optimizer=opt,
                                  strength="heavy")


# ---------------------------------------------------------------------------
# (c) the in-place optimizer and its scalar vectors
# ---------------------------------------------------------------------------


def _parent_step(opt, params, grads, state):
    """The update before it wrote its state in place: every buffer rebound
    to a new tensor, the LR and Adam's corrections as host floats."""
    f32 = np.float32
    names = list(params)
    g = [grads[n] for n in names]
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
    keep = norm < opt.max_grad_norm
    g = [torch.where(keep, x, x / norm * opt.max_grad_norm) for x in g]
    g = [x + opt.weight_decay * params[n] for x, n in zip(g, names)]
    count = state["count"]
    if opt.kind == "sgd":
        trace = state["trace"]
        for x, n in zip(g, names):
            trace[n] = x + opt.momentum * trace[n]
        u = [trace[n] for n in names]
    else:
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1 = float(f32(1) - f32(b1) ** f32(count + 1))
        c2 = float(f32(1) - f32(b2) ** f32(count + 1))
        mu, nu = state["mu"], state["nu"]
        u = []
        for x, n in zip(g, names):
            mu[n] = (1 - b1) * x + b1 * mu[n]
            nu[n] = (1 - b2) * (x * x) + b2 * nu[n]
            u.append((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps))
    neg_lr = -opt.schedule(count)
    with torch.no_grad():
        for un, n in zip(u, names):
            params[n].add_(un * neg_lr)
    state["count"] = count + 1


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("form", ["host", "vector"])
def test_in_place_optimizer_equals_the_parent_update(kind, form):
    """(c) Seven steps of the in-place update, given host floats or a
    chunk's per-step scalar rows (`step_scalars`), bit-equal to the update
    as it was; the state's buffers stay the same tensors."""
    cfg = types.SimpleNamespace(**{**OPT, "optimizer_type": kind,
                                   "use_cosine_scheduler": True,
                                   "warmup_iters": 3, "max_epochs": 2,
                                   "max_grad_norm": 0.5})
    opt = toptim.create_optimizer(cfg, steps_per_epoch=5)
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,), "c": ()}
    start = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, s in shapes.items()}
    params = [{n: t.clone() for n, t in start.items()} for _ in range(2)]
    states = [opt.init(p) for p in params]
    buffers = {k: dict(v) for k, v in states[0].items() if k != "count"}
    steps = 7
    table = torch.from_numpy(opt.step_scalars(0, steps))
    for k in range(steps):
        grads = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for n, s in shapes.items()}
        opt.step(params[0], grads, states[0],
                 scalars=table[k] if form == "vector" else None)
        _parent_step(opt, params[1], grads, states[1])
    assert states[0]["count"] == states[1]["count"] == steps
    for n in shapes:
        assert torch.equal(params[0][n], params[1][n]), n
        assert not torch.equal(params[0][n], start[n]), n
    for k, v in buffers.items():
        for n, t in v.items():
            assert states[0][k][n] is t, (k, n)
            assert torch.equal(t, states[1][k][n]), (k, n)


def test_step_scalars_are_the_host_values():
    cfg = types.SimpleNamespace(**{**OPT, "optimizer_type": "adam",
                                   "use_cosine_scheduler": True,
                                   "warmup_iters": 2})
    opt = toptim.create_optimizer(cfg, steps_per_epoch=6)
    table = opt.step_scalars(4, 3)
    assert table.shape == (3, toptim.SCALARS) and table.dtype == np.float32
    for k, count in enumerate(range(4, 7)):
        c1 = np.float32(1) - np.float32(0.9) ** np.float32(count + 1)
        c2 = np.float32(1) - np.float32(0.999) ** np.float32(count + 1)
        assert table[k].tolist() == [-opt.schedule(count), c1, c2]


# ---------------------------------------------------------------------------
# (d) the loop's routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["none", "heavy"])
def test_loop_routes_full_chunks_through_scanned_steps(tmp_path, monkeypatch,
                                                       capsys, tier):
    """Full non-fused chunks of `train_model` go through
    `scanned_train_steps`, as in JAX's loop; the partial last chunk of each
    epoch step by step through `gathered_train_step`. 8 steps an epoch in
    chunks of 3: two scanned chunks and two gathered steps an epoch."""
    from config import load_config

    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config("/".join(__file__.split("/")[:-2])
                      + "/config/train_etinynet_test.py")
    cfg.log_dir = str(tmp_path / "logs")
    cfg.max_epochs = 2
    cfg.steps_per_dispatch = 3
    if tier != "none":
        cfg.use_augmentation = True
        cfg.augmentation_strength = tier
    scanned, gathered = [], []
    real_scanned, real_gathered = tloop.scanned_train_steps, tloop.gathered_train_step
    monkeypatch.setattr(tloop, "scanned_train_steps", lambda *a, **k: (
        scanned.append(len(a[3])), real_scanned(*a, **k))[1])
    monkeypatch.setattr(tloop, "gathered_train_step", lambda *a, **k: (
        gathered.append(1), real_gathered(*a, **k))[1])
    assert tloop.train_model(cfg, "etinynet", device="cpu") == 0
    assert scanned == [3] * 4 and len(gathered) == 4
    out = capsys.readouterr().out
    assert out.count("full chunks of 3 steps: eager on the CPU") == 1
