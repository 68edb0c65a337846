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

`StepCheckpointer` stands in for the JAX package's `OrbaxStepCheckpointer`
(`checkpoint.py:135-203`, `checkpoint_backend="orbax"`): one directory
per step under its root, holding `state.pt` (`torch.save` of the given
state: the model's state dict, the optimizer state, the generators) and
`metadata.json`, written under a temporary name and renamed into place,
the oldest steps beyond `max_to_keep` removed. Writes are synchronous.
In a data-parallel run rank 0 writes both kinds (a barrier follows each
write, `training/loop.py`) and every rank reads a step it resumes from.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
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


class StepCheckpointer:
    """Retention-managed step checkpoints for resume.

    `save(step, state, metadata)` writes `<dir>/<step>/state.pt` (the
    `state` dict through `torch.save`: tensors, dicts, lists and numbers)
    and `<dir>/<step>/metadata.json`; `restore()` returns (state on the
    CPU, metadata) of the latest step, and raises FileNotFoundError when
    there is none.
    """

    def __init__(self, directory: Path, max_to_keep: int = 3):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def all_steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> None:
        final = self.dir / str(int(step))
        tmp = self.dir / f".{int(step)}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / "state.pt")
        (tmp / "metadata.json").write_text(json.dumps(metadata or {}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.dir / str(old))

    def restore(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no step checkpoints under {self.dir}")
        root = self.dir / str(step)
        state = torch.load(root / "state.pt", map_location="cpu",
                           weights_only=True)
        return state, json.loads((root / "metadata.json").read_text())
