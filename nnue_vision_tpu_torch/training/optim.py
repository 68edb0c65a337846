"""Optimizers and LR schedules, written by hand to update what optax updates.

Port of `nnue_vision_tpu/training/optim.py:18-140`. The JAX package chains
optax's `clip_by_global_norm` → `add_decayed_weights` → `sgd` (momentum) or
`adam`. `torch.optim` differs from that chain in three places, so the port
writes the update out:

* it skips a parameter whose `.grad` is None; optax decays every leaf of
  the params pytree, `nnue2score` included (its gradient is 0, its decay
  term is not);
* `clip_grad_norm_` scales by max_norm / (norm + 1e-6) always; optax scales
  by (g / norm) · max_norm only when norm ≥ max_norm;
* weight decay enters after the clip and before the momentum trace.

The LR of each step is the optax schedule's float32 value at the step
count before the increment, computed on the host in numpy float32 in the
order optax computes it (equal to it, or 1 ulp away where XLA's float32
cosine is).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

OptState = Dict[str, Any]
_F32 = np.float32
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # Adam's (optax's defaults)
SCALARS = 3  # a step's row of `Optimizer.step_scalars`


def get_lr(it: int, *, cfg: Any) -> float:
    """Warmup → (optional) cosine decay → (optional) cyclical modulation:
    linear warmup is 1-based; past `lr_decay_iters` the rate floors at
    `min_lr`; the final rate is at least `min_lr` except during warmup."""
    lr = cfg.learning_rate
    warmup = getattr(cfg, "warmup_iters", 0)
    decay_iters = getattr(cfg, "lr_decay_iters", 0)
    min_lr = getattr(cfg, "min_lr", 0.0)
    decay = getattr(cfg, "decay_lr", True)

    if it < warmup:
        base = lr * (it + 1) / warmup if warmup > 0 else lr
    elif decay_iters and it > decay_iters:
        base = min_lr
    elif not decay or not decay_iters:
        base = lr
    else:
        ratio = (it - warmup) / (decay_iters - warmup)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        base = min_lr + coeff * (lr - min_lr)

    final = base
    if getattr(cfg, "use_cyclical_lr", False) and it >= warmup:
        period = cfg.cyclical_lr_period
        amplitude = cfg.cyclical_lr_amplitude
        progress = ((it - warmup) % period) / period
        final *= 1.0 + amplitude * math.sin(2 * math.pi * progress)

    if it < warmup:
        return final
    return max(min_lr, final)


def _cosine(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule in float32. The cosine is the correctly
    rounded one; XLA's float32 cosine may be 1 ulp away from it."""
    def schedule(count: int) -> _F32:
        c = _F32(min(count, decay_steps))
        x = _F32(math.pi) * c / _F32(decay_steps)
        cosine_decay = _F32(0.5) * (_F32(1) + _F32(math.cos(x)))
        decayed = _F32(1 - alpha) * cosine_decay + _F32(alpha)
        return _F32(init_value) * decayed
    return schedule


def _linear(init_value: float, end_value: float, steps: int):
    """optax.linear_schedule in float32."""
    def schedule(count: int) -> _F32:
        c = min(max(count, 0), steps)
        frac = _F32(1) - _F32(c) / _F32(steps)
        return _F32(init_value - end_value) * frac + _F32(end_value)
    return schedule


def make_schedule(cfg: Any, steps_per_epoch: int) -> Callable[[int], float]:
    """step count → the learning rate of that step (a float32 value).

    `use_cosine_scheduler` anneals over `lr_decay_iters`, else over
    steps_per_epoch · max_epochs, with `alpha = min_lr / learning_rate`;
    `warmup_iters` prepends a linear warmup; `use_cyclical_lr` samples
    `get_lr` into a float32 table."""
    lr = cfg.learning_rate
    if not getattr(cfg, "use_cosine_scheduler", False):
        return lambda _: float(_F32(lr))

    total = getattr(cfg, "lr_decay_iters", 0) or max(
        1, steps_per_epoch * getattr(cfg, "max_epochs", 1)
    )
    warmup = getattr(cfg, "warmup_iters", 0)
    min_lr = getattr(cfg, "min_lr", 0.0)
    if not getattr(cfg, "use_cyclical_lr", False):
        cosine = _cosine(lr, max(1, total - warmup), min_lr / lr if lr else 0.0)
        if warmup <= 0:
            return lambda step: float(cosine(step))
        linear = _linear(lr / max(1, warmup), lr, warmup)
        return lambda step: float(
            linear(step) if step < warmup else cosine(step - warmup))

    shim = SimpleNamespace(
        learning_rate=lr, warmup_iters=warmup, lr_decay_iters=total,
        min_lr=min_lr, decay_lr=getattr(cfg, "decay_lr", True),
        use_cyclical_lr=True,
        cyclical_lr_period=getattr(cfg, "cyclical_lr_period", 1000),
        cyclical_lr_amplitude=getattr(cfg, "cyclical_lr_amplitude", 0.1),
    )
    table = np.array([get_lr(i, cfg=shim) for i in range(total + 1)], _F32)
    return lambda step: float(table[min(max(step, 0), total)])


class Optimizer:
    """clip_by_global_norm → add_decayed_weights → sgd | adam, as optax
    chains them, over a dict of named parameters.

    `init(params)` makes the state: {"count": 0, "trace": {name: zeros}}
    for SGD, {"count", "mu", "nu"} for Adam. `step(params, grads, state)`
    updates the parameters and the state's buffers in place (a captured
    step keeps writing the same buffers); a gradient of None counts as
    zeros, so every parameter is decayed. `sq_norm`, given the
    gradients by name, returns their squared global norm for the clip
    where some are shards of a tensor-parallel model (default: the sum of
    their squares).
    """

    def __init__(self, schedule: Callable[[int], float], *, kind: str,
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0):
        if kind not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.schedule = schedule
        self.kind = kind
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        def zeros():
            return {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for n, p in params.items()}

        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def step_scalars(self, count: int, steps: int = 1) -> np.ndarray:
        """(steps, SCALARS) float32: for each step from `count` on, the
        step's -LR and Adam's bias corrections c1 and c2, the host values
        `step` computes when it is given none (SGD reads only the first)."""
        rows = []
        for c in range(count, count + steps):
            c1 = _F32(1) - _F32(_B1) ** _F32(c + 1)
            c2 = _F32(1) - _F32(_B2) ** _F32(c + 1)
            rows.append((-_F32(self.schedule(c)), c1, c2))
        return np.array(rows, dtype=_F32).reshape(steps, SCALARS)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]], state: OptState, *,
             sq_norm: Optional[Callable[[Dict[str, torch.Tensor]],
                                        torch.Tensor]] = None,
             scalars: Optional[torch.Tensor] = None) -> None:
        """One update, in place. `scalars`: this step's row of
        `step_scalars` as a (SCALARS,) float32 tensor on the params' device,
        read there instead of host floats (a CUDA graph bakes a host float
        in as a constant); the update is the same bits either way."""
        names = list(params)
        g = [grads[n] if grads.get(n) is not None
             else torch.zeros_like(params[n]) for n in names]
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g) if sq_norm is None
                              else sq_norm(dict(zip(names, g))))
            keep = norm < self.max_grad_norm
            g = [torch.where(keep, x, x / norm * self.max_grad_norm) for x in g]
        if self.weight_decay:
            g = [x + self.weight_decay * params[n] for x, n in zip(g, names)]

        count = state["count"]
        if scalars is None:
            neg_lr, c1, c2 = self.step_scalars(count)[0].tolist()
        else:
            neg_lr, c1, c2 = scalars.unbind()
        if self.kind == "sgd":
            trace = state["trace"]
            for x, n in zip(g, names):
                trace[n].copy_(x + self.momentum * trace[n])
            u = [trace[n] for n in names]
        else:
            if scalars is None:
                # optax divides by the bias corrections; ATen divides a
                # CUDA tensor by a host float as the product with its
                # float32 reciprocal, an ulp away, and by a device tensor
                # truly: so they go to the device (a fill, no copy)
                c1, c2 = (torch.full((), c, dtype=torch.float32,
                                     device=g[0].device) for c in (c1, c2))
            mu, nu = state["mu"], state["nu"]
            u = []
            for x, n in zip(g, names):
                mu[n].copy_((1 - _B1) * x + _B1 * mu[n])
                nu[n].copy_((1 - _B2) * (x * x) + _B2 * nu[n])
                u.append(mu[n] / c1 / (torch.sqrt(nu[n] / c2) + _EPS))
        for un, n in zip(u, names):
            params[n].add_(un * neg_lr)
        state["count"] = count + 1


def create_optimizer(cfg: Any, steps_per_epoch: int = 1) -> Optimizer:
    """SGD(momentum, weight_decay) or Adam(weight_decay), per config, with
    gradient clipping by global norm first when `max_grad_norm > 0`."""
    return Optimizer(
        make_schedule(cfg, steps_per_epoch),
        kind=getattr(cfg, "optimizer_type", "adam"),
        momentum=getattr(cfg, "momentum", 0.9),
        weight_decay=getattr(cfg, "weight_decay", 0.0),
        max_grad_norm=getattr(cfg, "max_grad_norm", 0.0),
    )


def opt_state_numpy(state: OptState) -> Dict[str, Any]:
    """The state for a checkpoint: the count, and each buffer as numpy,
    keyed by parameter name."""
    return {k: (v if k == "count" else
                {n: t.detach().cpu().numpy().copy() for n, t in v.items()})
            for k, v in state.items()}
