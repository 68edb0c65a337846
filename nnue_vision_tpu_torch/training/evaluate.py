"""Bit-exact int8 evaluation of an NNUE (port of the NNUE branch of
`nnue_vision_tpu/training/evaluate.py:152-265`).

`evaluate_int8_sim` quantizes the float model exactly as serialization does
and computes the C++ engine's logits for every batch, so its accuracy/F1
equal the engine subprocess path's. Three backends give the same bits:
`use_pallas=False` the plain torch sim, `True` the exact conv + head kernel
(`nnue_engine_forward_fused`), `"mega"` the single kernel
(`nnue_engine_forward_mega`). On a CPU device all three run their plain
versions.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.nnue import NNUE, nnue_quantize
from nnue_vision_tpu_torch.ops.engine_sim import (
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.ops.nnue_kernels import (
    mega_head_params,
    nnue_engine_forward_fused,
    nnue_engine_forward_mega,
    pallas_head_params,
)
from nnue_vision_tpu_torch.training.metrics import compute_metrics


def evaluate_int8_sim(
    model: NNUE, loader: Iterable[Tuple[np.ndarray, np.ndarray]], *,
    use_pallas=False, device=None,
) -> Dict[str, float]:
    """Metrics of the deployed int8 model over `loader`.

    `loader` yields (images (B, H, W, 3) float in [0, 1], labels (B,));
    images are normalized here, on `device` (default: the model's).
    Returns acc/f1/precision/recall, `ms_per_sample` (host clock over the
    whole loop, which ends in a device-to-host copy of each batch's logits)
    and `latent_density`.
    """
    if use_pallas not in (False, True, "mega"):
        raise ValueError(f"use_pallas must be False, True or 'mega': {use_pallas!r}")
    if device is None:
        device = next(model.parameters()).device
    q = nnue_quantize(model)
    sim_params, cfg = nnue_sim_params(q, device=device)
    if use_pallas == "mega":
        heads = {}

        def fwd(x, h, w):
            if (h, w) not in heads:
                heads[(h, w)] = mega_head_params(sim_params, cfg, h, w)
            return nnue_engine_forward_mega(
                heads[(h, w)], x.reshape(x.shape[0], -1), cfg=cfg, image_h=h,
                image_w=w,
            )
    elif use_pallas:
        head = pallas_head_params(sim_params)

        def fwd(x, h, w):
            return nnue_engine_forward_fused(
                sim_params, head, x, cfg=cfg, image_h=h, image_w=w
            )
    else:
        def fwd(x, h, w):
            return nnue_engine_forward(
                sim_params, x, cfg=cfg, image_h=h, image_w=w
            )

    outs, targets, densities = [], [], []
    n = 0
    t0 = time.perf_counter()
    for images, labels in loader:
        x = normalize_images(
            torch.as_tensor(np.asarray(images, np.float32), device=device)
        ).contiguous()
        logits, _, count = fwd(x, x.shape[1], x.shape[2])
        outs.append(logits.cpu().numpy())
        targets.append(np.asarray(labels))
        densities.append(
            count.cpu().numpy().astype(np.float32) / np.float32(q.num_features)
        )
        n += len(labels)
    elapsed = time.perf_counter() - t0
    if not outs:
        raise ValueError("evaluation loader produced 0 batches")

    metrics = compute_metrics(np.concatenate(outs), np.concatenate(targets))
    metrics["ms_per_sample"] = (elapsed / max(1, n)) * 1000.0
    metrics["latent_density"] = float(np.concatenate(densities).mean())
    return metrics
