"""The reference optimizers on the CPU: Adam against Adam written out in
float64, and both chains against the program's `Optimizer`; and the
reference EtinyNet-0.75's parameters against the program's."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench.reference import etinynet
from perfbench.reference import optim as ref_optim

SHAPES = {"w": (6, 5), "b": (5,), "unused": (3,)}
RECIPE = {"learning_rate": 8e-4, "weight_decay": 1e-4, "momentum": 0.9,
          "use_cosine_scheduler": True, "steps_per_epoch": 19,
          "max_epochs": 35}
# max_grad_norm: off, on (every step clips: the gradients' norm is ~5), and
# on but never reached
CLIPS = (0.0, 1.0, 100.0)


def _leaves(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=gen) for n, s in SHAPES.items()}


def _grads(seed: int):
    g = _leaves(seed)
    g["unused"] = None  # a leaf no loss reaches: decayed all the same
    return g


def _adam64(params, grads_by_step, recipe):
    """Adam written out in float64 from optax's definition."""
    p = {n: v.double() for n, v in params.items()}
    mu = {n: torch.zeros_like(v) for n, v in p.items()}
    nu = {n: torch.zeros_like(v) for n, v in p.items()}
    total = recipe["steps_per_epoch"] * recipe["max_epochs"]
    for t, grads in enumerate(grads_by_step, start=1):
        g = {n: (grads[n].double() if grads[n] is not None
                 else torch.zeros_like(p[n])) for n in p}
        norm = math.sqrt(sum(float((x * x).sum()) for x in g.values()))
        clip = recipe["max_grad_norm"]
        if clip > 0 and norm >= clip:
            g = {n: x * (clip / norm) for n, x in g.items()}
        g = {n: x + recipe["weight_decay"] * p[n] for n, x in g.items()}
        lr = recipe["learning_rate"] * 0.5 * (1 + math.cos(math.pi * (t - 1) / total))
        for n in p:
            mu[n] = 0.1 * g[n] + 0.9 * mu[n]
            nu[n] = 0.001 * g[n] ** 2 + 0.999 * nu[n]
            m_hat = mu[n] / (1 - 0.9 ** t)
            v_hat = nu[n] / (1 - 0.999 ** t)
            p[n] = p[n] - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return p


@pytest.mark.parametrize("clip", CLIPS)
def test_adam_step_is_adam_in_float64(clip):
    recipe = dict(RECIPE, optimizer_type="adam", max_grad_norm=clip)
    params = _leaves(0)
    grads = [_grads(s) for s in (1, 2, 3)]
    state = ref_optim.init(recipe, params)
    assert set(state) == {"count", "mu", "nu"}
    p = {n: v.clone() for n, v in params.items()}
    for g in grads:
        ref_optim.step(p, g, state, recipe)
    assert state["count"] == 3
    want = _adam64(params, grads, recipe)
    for n in p:
        change = want[n] - params[n].double()
        # float32 rounding of the moments and of 3 updates of ~lr each
        assert float((p[n].double() - want[n]).abs().max()) < 1e-4 * float(
            change.abs().max()), n
    # the leaf no loss reaches moved by the decay alone, Adam-scaled
    assert float((p["unused"] - params["unused"]).abs().min()) > 0


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("kind", ("sgd", "adam"))
def test_reference_chain_is_the_programs_on_the_cpu(kind, clip):
    """On the CPU the program divides Adam's moments by its bias
    corrections as the reference does (true division; on the card it
    multiplies by their float32 reciprocals), and every other operation
    comes in the same order: the two agree bit for bit."""
    from types import SimpleNamespace

    from nnue_vision_tpu_torch.training.optim import create_optimizer
    recipe = dict(RECIPE, optimizer_type=kind, max_grad_norm=clip)
    opt = create_optimizer(SimpleNamespace(**recipe), recipe["steps_per_epoch"])
    params = _leaves(0)
    prog_p = {n: v.clone() for n, v in params.items()}
    ref_p = {n: v.clone() for n, v in params.items()}
    prog_s = opt.init(prog_p)
    ref_s = ref_optim.init(recipe, ref_p)
    assert set(prog_s) == set(ref_s)
    for seed in (1, 2, 3):
        opt.step(prog_p, _grads(seed), prog_s)
        ref_optim.step(ref_p, _grads(seed), ref_s, recipe)
    assert prog_s["count"] == ref_s["count"] == 3
    for n in params:
        assert torch.equal(prog_p[n], ref_p[n]), n
        for b in ref_optim.BUFFERS[kind]:
            assert torch.equal(prog_s[b][n], ref_s[b][n]), (b, n)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="'lamb'"):
        ref_optim.init(dict(RECIPE, optimizer_type="lamb"), _leaves(0))
    with pytest.raises(ValueError, match="None"):
        ref_optim.kind(RECIPE)


def test_first_moment_after_one_adam_step():
    """Adam's `mu` after step 1 is (1 − b1) times the clipped, decayed
    gradient: the first gradient as the optimizer takes it."""
    recipe = dict(RECIPE, optimizer_type="adam", max_grad_norm=0.0)
    p = _leaves(0)
    g = _grads(1)
    want = {n: ((g[n] if g[n] is not None else torch.zeros_like(v))
                + recipe["weight_decay"] * v) for n, v in p.items()}
    state = ref_optim.init(recipe, p)
    ref_optim.step(p, g, state, recipe)
    for n in p:
        np.testing.assert_allclose(state["mu"][n].numpy(),
                                   (0.1 * want[n]).numpy(), rtol=1e-6)


def test_reference_etinynet_075_is_the_programs():
    """The reference's EtinyNet-0.75 (not engine-friendly) has the
    program's parameters, by name and shape."""
    from perfbench.families import etinynet as fam
    cfg = {"variant": "0.75", "num_classes": 10, "input_size": 32,
           "dtype": "float32"}
    model = fam.port_model(cfg, torch.device("cpu"))
    prog = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = {n: tuple(s) for n, s, _ in etinynet.param_specs(cfg)}
    assert prog == ref
    assert ref["stem_w"] == (3, 3, 3, 24) and ref["final_w"] == (1, 1, 192, 960)

