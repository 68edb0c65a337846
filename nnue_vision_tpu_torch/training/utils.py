"""Training utilities: git provenance, run names, disk monitoring, NaN
checks (port of `nnue_vision_tpu/training/utils.py`).

Capability parity with upstream training_utils.py (:74-142 git info,
:148-197 disk-space emergency handling, :203-228 run-name generation,
:356-370 non-finite diagnostics). `generate_run_name`'s rule,
`<model>-<config>-<commit>-<ts>[-note]`, is not `training/logging.py`'s
`default_run_name` (`run_<ts>`, the loop's default); both are kept, as in
the JAX package.
"""

from __future__ import annotations

import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn


def get_git_info() -> Dict[str, str]:
    """Commit / branch / dirty-state provenance for run logging (empty
    strings outside a git repository)."""
    def run(*args):
        try:
            r = subprocess.run(["git", *args], capture_output=True, text=True,
                               timeout=10)
            return r.stdout.strip() if r.returncode == 0 else ""
        except Exception:
            return ""

    status = run("status", "--porcelain")
    return {
        "commit": run("rev-parse", "HEAD"),
        "commit_short": run("rev-parse", "--short", "HEAD"),
        "branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": "true" if status else "false",
        "remote": run("remote", "get-url", "origin"),
    }


def generate_run_name(model_type: str, config_name: str = "",
                      note: str = "") -> str:
    """Readable unique run names: <model>-<config>-<commit>-<ts>[-note]."""
    git = get_git_info()
    parts = [model_type]
    if config_name:
        parts.append(config_name)
    if git["commit_short"]:
        parts.append(git["commit_short"])
    parts.append(time.strftime("%m%d_%H%M%S"))
    if note:
        parts.append(note.replace(" ", "_")[:32])
    return "-".join(parts)


def check_disk_space(path: str = ".", min_free_gb: float = 1.0) -> Dict:
    """Free-space check used by the emergency monitor."""
    usage = shutil.disk_usage(path)
    free_gb = usage.free / 1e9
    return {
        "free_gb": free_gb,
        "total_gb": usage.total / 1e9,
        "critical": free_gb < min_free_gb,
    }


def emergency_cleanup(log_dir: str = "logs", keep_latest: int = 2) -> List[Path]:
    """Delete the oldest run folders under `<log_dir>/checkpoints`, keeping
    the `keep_latest` newest (upstream training_utils.py:148-197). Returns
    what was removed."""
    root = Path(log_dir) / "checkpoints"
    if not root.exists():
        return []
    run_dirs = sorted(root.iterdir(), key=lambda p: p.stat().st_mtime)
    removed = []
    for d in run_dirs[:-keep_latest] if keep_latest else run_dirs:
        if d.is_dir():
            shutil.rmtree(d, ignore_errors=True)
            removed.append(d)
    return removed


def disk_space_guard(log_dir: str = "logs", min_free_gb: float = 1.0) -> bool:
    """Check + cleanup when critical; True if space is now fine."""
    state = check_disk_space(min_free_gb=min_free_gb)
    if not state["critical"]:
        return True
    emergency_cleanup(log_dir)
    return not check_disk_space(min_free_gb=min_free_gb)["critical"]


def check_for_nonfinite(tree: Union[nn.Module, Dict], where: str = ""
                        ) -> Optional[str]:
    """A diagnostic naming every floating tensor with NaN or Inf values in
    a module's state dict or a dict of tensors/arrays, or None."""
    items = tree.state_dict().items() if isinstance(tree, nn.Module) else tree.items()
    problems = []
    for name, value in items:
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        if n_nan or n_inf:
            problems.append(f"{name}: {n_nan} NaN, {n_inf} Inf")
    if not problems:
        return None
    prefix = f"[{where}] " if where else ""
    return prefix + "; ".join(problems)


def enable_nan_debugging() -> None:
    """Make autograd raise where a backward op produces NaN
    (`torch.autograd.set_detect_anomaly`). This checks the backward pass
    only; the JAX package's `jax_debug_nans` checks every op."""
    torch.autograd.set_detect_anomaly(True)
