"""Move NNUE params between the JAX package's numpy pytree and the port.

The JAX package keeps its NNUE params as a dict (`models/nnue.py:157-184`
there): `conv_w` (C, 3, 3, 3) OIHW, `visual_threshold` (C,), `ft_w`
(F, L1), `ft_b`, `fc1_w` (L2, L1), `fc2_w` (L3, L2), `out_w` (classes, L3)
with their biases, and the scalar `nnue2score`. The port's `NNUE` module
holds the same names in the same layouts, so both directions are copies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nnue_vision_tpu_torch.models.nnue import NNUE, NNUEConfig


def nnue_from_jax_params(
    np_params: Dict[str, np.ndarray], cfg: NNUEConfig, device=None
) -> NNUE:
    """An `NNUE` holding exactly `np_params` (float32), on `device`."""
    model = NNUE(cfg, device=device)
    state = model.state_dict()
    missing = set(state) - set(np_params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    new_state = {}
    for name, ref in state.items():
        value = np.asarray(np_params[name], np.float32)
        if value.shape != tuple(ref.shape):
            raise ValueError(
                f"{name}: shape {value.shape} != expected {tuple(ref.shape)}"
            )
        new_state[name] = torch.from_numpy(value.copy())
    model.load_state_dict(new_state)
    return model


def nnue_to_numpy(model: NNUE) -> Dict[str, np.ndarray]:
    """The model's params as the JAX package's numpy dict."""
    return {name: t.detach().to("cpu", torch.float32).numpy().copy()
            for name, t in model.state_dict().items()}
