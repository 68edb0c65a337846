"""The plain optimizers: optax's clip_by_global_norm → add_decayed_weights →
sgd(momentum) or adam chain and its cosine schedule, written out in plain
torch.

Part of the benchmark's yardstick: it imports nothing of the program. The
schedule is optax's `cosine_decay_schedule` evaluated in float32 in optax's
expression order. Both chains start alike:

    g ← g · min(1, max_norm / ‖g‖)   (only when max_norm > 0 and ‖g‖ ≥ max_norm)
    g ← g + weight_decay · p

then SGD (`sgd_step`, state {"trace"})

    trace ← g + momentum · trace
    p ← p − lr · trace

or Adam (`adam_step`, state {"mu", "nu"}; optax's `scale_by_adam` with b1
0.9, b2 0.999, eps 1e-8, eps_root 0, the bias corrections 1 − bᵗ in float32
at the 1-based step t)

    mu ← (1 − b1) · g + b1 · mu
    nu ← (1 − b2) · g² + b2 · nu
    p ← p − lr · (mu / (1 − b1ᵗ)) / (√(nu / (1 − b2ᵗ)) + eps)

A recipe names its chain by `optimizer_type`; `init` makes that chain's
state ({"count": 0} and a zero buffer dict by leaf for each of its
buffers) and `step` takes one update.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

_F32 = np.float32
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax's scale_by_adam defaults


def cosine_lr(recipe: dict, count: int) -> float:
    """The float32 learning rate of step `count` (0-based) of a cosine
    schedule over steps_per_epoch · max_epochs steps, alpha = 0."""
    lr = recipe["learning_rate"]
    if not recipe.get("use_cosine_scheduler", False):
        return float(_F32(lr))
    total = max(1, recipe["steps_per_epoch"] * recipe["max_epochs"])
    c = _F32(min(count, total))
    x = _F32(math.pi) * c / _F32(total)
    decay = _F32(0.5) * (_F32(1) + _F32(math.cos(x)))
    return float(_F32(lr) * (_F32(1) * decay + _F32(0)))


def _clipped_decayed(params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], recipe: dict
                     ) -> List[torch.Tensor]:
    """The gradients in `params`' order after the clip and the decay (a
    missing gradient is zero: every leaf is decayed)."""
    g = [grads[n] if grads.get(n) is not None else torch.zeros_like(p)
         for n, p in params.items()]
    max_norm = recipe.get("max_grad_norm", 0.0)
    if max_norm and max_norm > 0:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = norm < max_norm
        g = [torch.where(keep, x, x / norm * max_norm) for x in g]
    wd = recipe.get("weight_decay", 0.0)
    if wd:
        g = [x + wd * params[n] for x, n in zip(g, params)]
    return g


def _lr(recipe: dict, count: int, device) -> torch.Tensor:
    return torch.tensor(cosine_lr(recipe, count), dtype=torch.float32,
                        device=device)


@torch.no_grad()
def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict, recipe: dict, count: int) -> None:
    """One SGD update of `params` and `state["trace"]` in place."""
    g = _clipped_decayed(params, grads, recipe)
    lr = _lr(recipe, count, g[0].device)
    mom, trace = recipe["momentum"], state["trace"]
    for x, n in zip(g, params):
        trace[n].copy_(x + mom * trace[n])
        params[n].sub_(trace[n] * lr)


@torch.no_grad()
def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: dict, recipe: dict, count: int) -> None:
    """One Adam update of `params`, `state["mu"]` and `state["nu"]` in
    place, at the 0-based step `count`."""
    g = _clipped_decayed(params, grads, recipe)
    dev = g[0].device
    lr = _lr(recipe, count, dev)
    t = _F32(count + 1)
    c1 = torch.tensor(_F32(1) - _F32(B1) ** t, dtype=torch.float32, device=dev)
    c2 = torch.tensor(_F32(1) - _F32(B2) ** t, dtype=torch.float32, device=dev)
    mu, nu = state["mu"], state["nu"]
    for x, n in zip(g, params):
        mu[n].copy_((1 - B1) * x + B1 * mu[n])
        nu[n].copy_((1 - B2) * (x * x) + B2 * nu[n])
        params[n].sub_(mu[n] / c1 / (torch.sqrt(nu[n] / c2) + EPS) * lr)


STEPS = {"sgd": sgd_step, "adam": adam_step}
BUFFERS = {"sgd": ("trace",), "adam": ("mu", "nu")}
# the buffer that holds the first gradient as the optimizer takes it, after
# step 1: the clipped, decayed gradient (SGD), (1 − b1) times it (Adam)
FIRST_MOMENT = {"sgd": "trace", "adam": "mu"}


def kind(recipe: dict) -> str:
    """The recipe's `optimizer_type`; raises ValueError for one this file
    does not follow."""
    name = recipe.get("optimizer_type")
    if name not in STEPS:
        raise ValueError(f"the reference follows the optimizers {sorted(STEPS)}; "
                         f"the recipe names optimizer_type {name!r}")
    return name


def init(recipe: dict, params: Dict[str, torch.Tensor]) -> dict:
    """The recipe's optimizer state at step 0: the count and a zero buffer
    dict by leaf for each buffer."""
    return {"count": 0, **{b: {n: torch.zeros_like(p) for n, p in params.items()}
                           for b in BUFFERS[kind(recipe)]}}


def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: dict, recipe: dict) -> None:
    """One update of the recipe's optimizer: `params` and `state` in place,
    the count advanced."""
    STEPS[kind(recipe)](params, grads, state, recipe, state["count"])
    state["count"] += 1
