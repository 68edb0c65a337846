"""Best-model checkpoints in the JAX package's pickle format (port of
`nnue_vision_tpu/training/checkpoint.py:32-133`).

The payload is the one the JAX package writes and `serialize.py` reads:
{"epoch", "model_type", "model_config" (dict), "params" (the JAX numpy
params dict, via `bridge.py`), "batch_stats", "opt_state", "metrics",
"config_name", "saved_at", "format_version"}. `opt_state` holds the step
count and the optimizer's buffers as numpy, keyed by parameter name; no
optax object is pickled or unpickled.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Any, Dict, Optional

from nnue_vision_tpu_torch.bridge import nnue_from_jax_params, nnue_to_numpy
from nnue_vision_tpu_torch.models.nnue import NNUE, GridFeatureSet, NNUEConfig
from nnue_vision_tpu_torch.training.optim import OptState, opt_state_numpy


def save_checkpoint(
    path: Path, *, model_type: str, model_config: Any, model: NNUE,
    epoch: int, metrics: Dict[str, float],
    opt_state: Optional[OptState] = None, config_name: str = "",
) -> None:
    payload = {
        "epoch": epoch,
        "model_type": model_type,
        "model_config": dataclasses.asdict(model_config),
        "params": nnue_to_numpy(model),
        "batch_stats": None,
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


def nnue_from_checkpoint(payload: Dict[str, Any], device=None) -> NNUE:
    """The NNUE of a loaded checkpoint payload, with its `model_config`
    (fields the port's NNUEConfig does not have are dropped)."""
    mc = dict(payload["model_config"])
    fields = {f.name for f in dataclasses.fields(NNUEConfig)}
    cfg = NNUEConfig(
        feature_set=GridFeatureSet(**mc.pop("feature_set")),
        **{k: v for k, v in mc.items() if k in fields},
    )
    return nnue_from_jax_params(payload["params"], cfg, device=device)
