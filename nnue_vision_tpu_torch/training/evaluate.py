"""Evaluation of an NNUE or an EtinyNet: the float path and bit-exact int8
(port of `nnue_vision_tpu/training/evaluate.py:45-265`).

`evaluate_model` runs the float model over a loader (an EtinyNet in eval
mode, on its running statistics): mean CE loss per batch and the metrics.
`evaluate_int8_sim` quantizes the float model exactly as serialization
does and computes the C++ engine's logits for every batch, so its
accuracy/F1 equal the engine subprocess path's. For an NNUE three backends
give the same bits: `use_pallas=False` the plain torch sim, `True` the
exact conv + head kernel (`nnue_engine_forward_fused`), `"mega"` the
single kernel (`nnue_engine_forward_mega`); on a CPU device all three run
their plain versions. An EtinyNet runs the engine sim
(`etiny_engine_forward`), as in the JAX package, whatever `use_pallas`
says; its `latent_density` is 0.

Both take a loader of raw (images [0, 1], labels) numpy batches, or a
`ResidentEvalLoader`, whose split sits normalized on the device.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from nnue_vision_tpu_torch.data.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)
from nnue_vision_tpu_torch.models.etinynet import EtinyNet, etinynet_quantize
from nnue_vision_tpu_torch.models.nnue import nnue_quantize
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
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
from nnue_vision_tpu_torch.training.step import eval_step


class ResidentEvalLoader:
    """A normalized eval split uploaded to `device` once and sliced there
    every epoch. Yields (device images normalized, host labels)."""

    device_resident = True

    def __init__(self, loader, device, batch_size=None):
        self.dataset = loader.dataset
        self.batch_size = int(batch_size or loader.batch_size)
        self.drop_last = bool(getattr(loader, "drop_last", False))
        imgs = np.asarray(loader.dataset.images, np.float32)
        normed = (imgs - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
            IMAGENET_STD, np.float32
        )
        self._images = torch.from_numpy(normed).to(device)
        self._labels = np.asarray(loader.dataset.labels)

    def __len__(self) -> int:
        n = len(self._labels)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self._labels)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            end = min(start + self.batch_size, n)
            yield self._images[start:end], self._labels[start:end]


def maybe_resident(loader, max_bytes, device, batch_size=None):
    """`loader` as a ResidentEvalLoader iff its own split fits `max_bytes`."""
    if loader.dataset.images.nbytes <= max_bytes:
        return ResidentEvalLoader(loader, device, batch_size=batch_size)
    return loader


def _batches(loader, device):
    """(normalized images on `device`, labels) of each batch."""
    resident = getattr(loader, "device_resident", False)
    for images, labels in loader:
        if not resident:
            images = normalize_images(
                torch.as_tensor(np.asarray(images, np.float32), device=device))
        yield images.contiguous(), labels


def evaluate_model(model: nn.Module, loader, *, device=None
                   ) -> Tuple[float, Dict[str, float]]:
    """Float-path evaluation: (mean per-sample CE loss averaged over
    batches, metrics)."""
    if device is None:
        device = next(model.parameters()).device
    total_loss, n_batches = 0.0, 0
    outs, targets = [], []
    for x, labels in _batches(loader, device):
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device)
        loss, logits = eval_step(model, x, y)
        total_loss += float(loss) / len(labels)
        n_batches += 1
        outs.append(logits.cpu().numpy())
        targets.append(np.asarray(labels))
    if not outs:
        raise ValueError(
            f"evaluation loader produced 0 batches (dataset of "
            f"{len(loader.dataset.labels)} samples, batch_size "
            f"{loader.batch_size}, drop_last={loader.drop_last}) — "
            "reduce batch_size or raise max_samples/subset"
        )
    metrics = compute_metrics(np.concatenate(outs), np.concatenate(targets))
    return total_loss / max(1, n_batches), metrics


def _nnue_forward(sim_params, cfg, use_pallas):
    """(x, h, w) → (logits, density, count) on the chosen NNUE backend."""
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
    return fwd


def evaluate_int8_sim(
    model: nn.Module, loader: Iterable[Tuple[np.ndarray, np.ndarray]], *,
    use_pallas=False, device=None,
) -> Dict[str, float]:
    """Metrics of the deployed int8 model over `loader`.

    `loader` yields (images (B, H, W, 3) float in [0, 1], labels (B,)),
    normalized here on `device` (default: the model's), or is a
    `ResidentEvalLoader`.
    Returns acc/f1/precision/recall, `ms_per_sample` (host clock over the
    whole loop, which ends in a device-to-host copy of each batch's logits)
    and `latent_density`.
    """
    if use_pallas not in (False, True, "mega"):
        raise ValueError(f"use_pallas must be False, True or 'mega': {use_pallas!r}")
    if device is None:
        device = next(model.parameters()).device
    if isinstance(model, EtinyNet):
        sim_params, cfg = etiny_sim_params(etinynet_quantize(model),
                                           device=device)

        def fwd(x, h, w):
            return etiny_engine_forward(sim_params, x, cfg=cfg, image_h=h,
                                        image_w=w), None, None
    else:
        q = nnue_quantize(model)
        sim_params, cfg = nnue_sim_params(q, device=device)
        fwd = _nnue_forward(sim_params, cfg, use_pallas)

    outs, targets, densities = [], [], []
    n = 0
    t0 = time.perf_counter()
    for x, labels in _batches(loader, device):
        logits, _, count = fwd(x, x.shape[1], x.shape[2])
        outs.append(logits.cpu().numpy())
        targets.append(np.asarray(labels))
        if count is not None:
            densities.append(count.cpu().numpy().astype(np.float32)
                             / np.float32(q.num_features))
        n += len(labels)
    elapsed = time.perf_counter() - t0
    if not outs:
        raise ValueError("evaluation loader produced 0 batches")

    metrics = compute_metrics(np.concatenate(outs), np.concatenate(targets))
    metrics["ms_per_sample"] = (elapsed / max(1, n)) * 1000.0
    metrics["latent_density"] = (float(np.concatenate(densities).mean())
                                 if densities else 0.0)
    return metrics
