"""The plain optimizer: optax's clip_by_global_norm → add_decayed_weights →
sgd(momentum) chain and its cosine schedule, written out in plain torch.

Part of the benchmark's yardstick: it imports nothing of the program. The
schedule is optax's `cosine_decay_schedule` evaluated in float32 in optax's
expression order; the update is

    g ← g · min(1, max_norm / ‖g‖)   (only when max_norm > 0 and ‖g‖ ≥ max_norm)
    g ← g + weight_decay · p
    trace ← g + momentum · trace
    p ← p − lr · trace
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_F32 = np.float32


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


@torch.no_grad()
def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             trace: Dict[str, torch.Tensor], recipe: dict, count: int) -> None:
    """One update of `params` and `trace` in place (a missing gradient is
    zero: every leaf is decayed)."""
    names = list(params)
    g = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
         for n in names]
    max_norm = recipe.get("max_grad_norm", 0.0)
    if max_norm and max_norm > 0:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = norm < max_norm
        g = [torch.where(keep, x, x / norm * max_norm) for x in g]
    wd = recipe.get("weight_decay", 0.0)
    if wd:
        g = [x + wd * params[n] for x, n in zip(g, names)]
    lr = torch.tensor(cosine_lr(recipe, count), dtype=torch.float32,
                      device=g[0].device)
    mom = recipe["momentum"]
    for x, n in zip(g, names):
        trace[n].copy_(x + mom * trace[n])
        params[n].sub_(trace[n] * lr)
