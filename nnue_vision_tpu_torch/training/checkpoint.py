"""Best-model checkpoints in the JAX package's pickle format (port of
`nnue_vision_tpu/training/checkpoint.py:32-133`).

The payload is the one the JAX package writes and `serialize.py` reads:
{"epoch", "model_type", "model_config" (dict), "params" and
"batch_stats" (the JAX package's numpy pytrees, via `bridge.py`; an NNUE
has no batch_stats, an EtinyNet's are its running norm statistics in the
nested layout), "opt_state", "metrics", "config_name", "saved_at",
"format_version"}. `opt_state` holds the step
count and the optimizer's buffers as numpy, keyed by parameter name; no
optax object is pickled or unpickled.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Any, Dict, Optional

from torch import nn

from nnue_vision_tpu_torch.bridge import (
    etinynet_from_jax,
    etinynet_to_numpy,
    nnue_from_jax_params,
    nnue_to_numpy,
)
from nnue_vision_tpu_torch.models.etinynet import EtinyNet, EtinyNetConfig
from nnue_vision_tpu_torch.models.nnue import NNUE, GridFeatureSet, NNUEConfig
from nnue_vision_tpu_torch.training.optim import OptState, opt_state_numpy


def save_checkpoint(
    path: Path, *, model_type: str, model_config: Any, model: nn.Module,
    epoch: int, metrics: Dict[str, float],
    opt_state: Optional[OptState] = None, config_name: str = "",
) -> None:
    if model_type == "etinynet":
        params, batch_stats = etinynet_to_numpy(model)
    else:
        params, batch_stats = nnue_to_numpy(model), None
    payload = {
        "epoch": epoch,
        "model_type": model_type,
        "model_config": dataclasses.asdict(model_config),
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": opt_state_numpy(opt_state) if opt_state is not None else None,
        "metrics": metrics,
        "config_name": config_name,
        "saved_at": time.time(),
        "format_version": 1,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.rename(path)


def load_checkpoint(path: Path) -> Dict[str, Any]:
    """The payload of a checkpoint this package (or the JAX package) wrote.
    Unpickling runs code: load only checkpoints you made."""
    with open(path, "rb") as f:
        return pickle.load(f)


def nnue_from_checkpoint(payload: Dict[str, Any], device="cuda") -> NNUE:
    """The NNUE of a loaded checkpoint payload, with its `model_config`
    (fields the port's NNUEConfig does not have are dropped), on `device`
    (the card unless the caller names another; raises without one)."""
    mc = dict(payload["model_config"])
    fields = {f.name for f in dataclasses.fields(NNUEConfig)}
    cfg = NNUEConfig(
        feature_set=GridFeatureSet(**mc.pop("feature_set")),
        **{k: v for k, v in mc.items() if k in fields},
    )
    return nnue_from_jax_params(payload["params"], cfg, device=device)


def etinynet_from_checkpoint(payload: Dict[str, Any], device="cuda"
                             ) -> EtinyNet:
    """The EtinyNet of a loaded checkpoint payload (this package's or the
    JAX package's), with its `model_config`, on `device` (the card unless
    the caller names another; raises without one)."""
    mc = dict(payload["model_config"])
    if isinstance(mc.get("input_size"), (list, tuple)):
        mc["input_size"] = mc["input_size"][0]
    fields = {f.name for f in dataclasses.fields(EtinyNetConfig)}
    cfg = EtinyNetConfig(**{k: v for k, v in mc.items() if k in fields})
    return etinynet_from_jax(payload["params"], payload["batch_stats"], cfg,
                             device=device)
