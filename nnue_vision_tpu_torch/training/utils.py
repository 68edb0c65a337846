"""Training utilities (port of `nnue_vision_tpu/training/utils.py:91-111`)."""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn


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
