"""What the benchmark makes from `--seed` and hands to the program and the
reference alike: weights, data, image buffers, batch indices and the
trainer's draw generator. Every stream has a seed of its own, derived from
the run's seed and a fixed tag, so that changing one stream's consumer
moves no other.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

TAGS = {"weights": 1, "data": 2, "indices": 3, "draws": 4, "sample": 5,
        "calibration": 6, "labels": 7, "serving": 8}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of the run's `seed` (any
    non-negative integer)."""
    state = np.random.SeedSequence([int(seed), TAGS[tag]]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def make_params(specs: List[Tuple[str, tuple, tuple]], seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """Float32 leaves on `device` from `specs` [(name, shape, init)]: one
    uniform and one normal draw for all leaves together, then sliced and
    scaled; init ("uniform", fan_in) is U(±1/√fan_in), ("normal", std) is
    N(0, std²), ("const", value) a fill."""
    gen = device_generator(seed, "weights", device)
    n_u = sum(math.prod(s) for _, s, i in specs if i[0] == "uniform")
    n_n = sum(math.prod(s) for _, s, i in specs if i[0] == "normal")
    u = torch.rand(n_u, generator=gen, device=device)
    g = torch.randn(n_n, generator=gen, device=device)
    out, pu, pn = {}, 0, 0
    for name, shape, (how, arg) in specs:
        n = math.prod(shape)
        if how == "uniform":
            bound = 1.0 / math.sqrt(max(1, arg))
            out[name] = (u[pu:pu + n] * (2 * bound) - bound).reshape(shape)
            pu += n
        elif how == "normal":
            out[name] = (g[pn:pn + n] * arg).reshape(shape)
            pn += n
        else:
            out[name] = torch.full(shape, float(arg), device=device)
    return {k: v.contiguous() for k, v in out.items()}


def make_images(n: int, hw: int, seed: int, tag: str, device) -> torch.Tensor:
    """(n, hw, hw, 3) float32 pixels in [0, 1)."""
    gen = device_generator(seed, tag, device)
    return torch.rand((n, hw, hw, 3), generator=gen, device=device)


def make_labels(n: int, classes: int, seed: int, device) -> torch.Tensor:
    gen = device_generator(seed, "labels", device)
    return torch.randint(0, classes, (n,), generator=gen, device=device)


class Batches:
    """(steps, batch) index chunks over a dataset of n rows: each chunk a
    slice of a fresh permutation, so that the rows of a chunk all differ."""

    def __init__(self, seed: int, n: int, batch: int):
        if batch > n:
            raise ValueError(f"batch {batch} exceeds the dataset's {n} rows")
        self.rng = np.random.default_rng(sub_seed(seed, "indices"))
        self.n, self.batch = n, batch

    def chunk(self, steps: int) -> np.ndarray:
        need = steps * self.batch
        parts = []
        while need > 0:
            take = min(need, (self.n // self.batch) * self.batch)
            parts.append(self.rng.permutation(self.n)[:take])
            need -= take
        return np.concatenate(parts).reshape(steps, self.batch)
