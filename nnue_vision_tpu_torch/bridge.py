"""Move NNUE and EtinyNet params between the JAX package's numpy pytrees
and the port.

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
from nnue_vision_tpu_torch.ops.engine_sim import resolve_device


def nnue_from_jax_params(
    np_params: Dict[str, np.ndarray], cfg: NNUEConfig, device="cuda"
) -> NNUE:
    """An `NNUE` holding exactly `np_params` (float32), on `device` (the
    card unless the caller names another; raises without one)."""
    model = NNUE(cfg, device=resolve_device(device))
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


# ---------------------------------------------------------------------------
# EtinyNet
# ---------------------------------------------------------------------------
#
# The JAX package keeps EtinyNet as two nested pytrees (`models/etinynet.py`
# there): params {"stem_w", "stem_bn": {"scale", "bias"}, "blocks": [{
# "pw_expand_w", "bn1", "dw_w", "bn2", "pw_project_w", "bn3"[, "dense_proj_w",
# "dense_bn"]}, ...], "final_w", "final_bn", "cls_w", "cls_b"} and
# batch_stats {"stem_bn": {"mean", "var"}, "blocks": [{"bn1", "bn2", "bn3"
# [, "dense_bn"]}, ...], "final_bn"}. An engine_friendly model's params also
# hold its LSQ scales in log space: "qlog1" and "qlog2" in every block and
# "final_qlog" (its scale-only norms keep the mean-square in "var"). The
# port's module names are the same paths joined by dots
# ("blocks.3.bn1.scale", "blocks.3.qlog1", "blocks.3.bn1.mean"), in the same
# layouts, so both directions are copies.


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(_flatten(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _nest(flat: Dict[str, np.ndarray]):
    """Inverse of `_flatten`: dotted paths → nested dicts, with a dict whose
    keys are 0..n-1 turned into a list."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def etinynet_from_jax(params, batch_stats, cfg, device="cuda"):
    """An `EtinyNet` holding exactly the JAX pytrees' values (float32), on
    `device` (the card unless the caller names another; raises without
    one)."""
    from nnue_vision_tpu_torch.models.etinynet import EtinyNet

    model = EtinyNet(cfg, device=resolve_device(device))
    flat = {**_flatten(params), **_flatten(batch_stats)}
    state = model.state_dict()
    missing = set(state) - set(flat)
    if missing:
        raise KeyError(f"params/batch_stats lack {sorted(missing)}")
    new_state = {}
    for name, ref in state.items():
        value = np.asarray(flat[name], np.float32)
        if value.shape != tuple(ref.shape):
            raise ValueError(
                f"{name}: shape {value.shape} != expected {tuple(ref.shape)}")
        new_state[name] = torch.from_numpy(value.copy())
    model.load_state_dict(new_state)
    return model


def etinynet_to_numpy(model):
    """(params, batch_stats) as the JAX package's nested numpy pytrees."""
    buffers = {name for name, _ in model.named_buffers()}
    flat = {name: t.detach().to("cpu", torch.float32).numpy().copy()
            for name, t in model.state_dict().items()}
    return (_nest({k: v for k, v in flat.items() if k not in buffers}),
            _nest({k: v for k, v in flat.items() if k in buffers}))
