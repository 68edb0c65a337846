"""The train and eval steps of both model families (port of
`nnue_vision_tpu/training/step.py:23-112, 178-328`).

The JAX package's steps are jitted pure functions over a TrainState
pytree; here a step runs eagerly and updates the model's parameters, its
norm statistics (an EtinyNet's running mean and variance, which a
training-mode forward updates in place: JAX's `new_stats`) and the
optimizer state in place. The loss is cross-entropy; after every optimizer
step an NNUE's FT and classifier weights are clipped to [-1, 1] (an
EtinyNet's are not, as in JAX).

`scanned_train_steps_fused` is the fused light-tier path: one host draw of
the augmentation parameters for all K steps of a chunk, one upload, then
per step one K3 launch (`fused_light_pipeline`) and one train step. The
losses come back as one (K,) tensor, so the chunk syncs with the host once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nnue_vision_tpu_torch.data.augment import preprocess_batch
from nnue_vision_tpu_torch.models.nnue import NNUE, nnue_clip_weights
from nnue_vision_tpu_torch.ops.input_pipeline import (
    draw_light_params,
    fused_light_pipeline,
)
from nnue_vision_tpu_torch.training.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and norm statistics), the optimizer state
    and the step count."""
    model: nn.Module
    opt_state: OptState
    step: int = 0


def make_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())))


@dataclasses.dataclass(frozen=True)
class Teacher:
    """A frozen model whose softened logits the student also fits: weight
    `alpha` on the hard-label CE, 1 − alpha on the teacher term, at
    temperature `temp`."""
    model: nn.Module
    alpha: float = 0.5
    temp: float = 4.0


def distillation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      images: torch.Tensor, teacher: Optional[Teacher]
                      ) -> torch.Tensor:
    """The CE of `logits`, and with a teacher the JAX package's
    alpha·CE + (1 − alpha)·T²·CE(logits / T, softmax(teacher(images) / T))."""
    loss = F.cross_entropy(logits, labels)
    if teacher is None:
        return loss
    with torch.no_grad():
        t_logits = teacher.model.eval()(images)
    temp = teacher.temp
    t_prob = torch.softmax(t_logits / temp, dim=-1)
    kd = -(t_prob * F.log_softmax(logits / temp, dim=-1)).sum(dim=-1).mean()
    return teacher.alpha * loss + (1.0 - teacher.alpha) * (temp * temp) * kd


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               *, optimizer: Optimizer, teacher: Optional[Teacher] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on normalized images (B, H, W, 3) and labels (B,),
    then, for an NNUE, the FT and classifier weights clipped to [-1, 1].
    Returns {"loss", "accuracy"} as device scalars."""
    model = state.model.train()
    params = dict(model.named_parameters())
    logits = model(images)
    loss = distillation_loss(logits, labels, images, teacher)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    optimizer.step(params, dict(zip(params, grads)), state.opt_state)
    if isinstance(model, NNUE):
        nnue_clip_weights(model)
    state.step += 1
    acc = (logits.detach().argmax(dim=-1) == labels).to(torch.float32).mean()
    return {"loss": loss.detach(), "accuracy": acc}


def _check_indices(idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"batch indices outside [0, {n})")


def gathered_train_step(state: TrainState, device_images: torch.Tensor,
                        device_labels: torch.Tensor, idx: np.ndarray,
                        gen: torch.Generator, *, optimizer: Optimizer,
                        strength: str = "medium", augment: bool = True,
                        noise_gen: Optional[torch.Generator] = None,
                        teacher: Optional[Teacher] = None
                        ) -> Dict[str, torch.Tensor]:
    """Gather a batch by index from the device-resident dataset, augment,
    normalize, train one step. The medium and heavy tiers draw their noise
    from `noise_gen`, a generator on the dataset's device."""
    idx = np.asarray(idx)
    _check_indices(idx, device_labels.shape[0])
    i = torch.as_tensor(idx, dtype=torch.int64).to(device_images.device)
    x = preprocess_batch(gen, device_images[i], strength=strength,
                         augment=augment, noise_gen=noise_gen)
    return train_step(state, x, device_labels[i], optimizer=optimizer,
                      teacher=teacher)


def scanned_train_steps_fused(state: TrainState, gather_dataset: torch.Tensor,
                              device_labels: torch.Tensor,
                              idx_chunk: np.ndarray, gen: torch.Generator, *,
                              optimizer: Optimizer, height: int, width: int
                              ) -> Dict[str, torch.Tensor]:
    """K train steps of the light tier with the whole input path in one K3
    launch per step. The (K, B) draws are made once, on the host, and the
    effective indices (flip folded in as +N) are checked there, while they
    are numpy."""
    idx_chunk = np.asarray(idx_chunk)
    steps, batch = idx_chunk.shape
    n = device_labels.shape[0]
    _check_indices(idx_chunk, n)
    params = draw_light_params(gen, steps, batch, height, width)
    idx_eff = idx_chunk + n * params.flip.numpy().astype(np.int64)
    _check_indices(idx_eff, 2 * n)
    dev = gather_dataset.device
    idx_eff = torch.as_tensor(idx_eff, dtype=torch.int32).to(dev)
    labels = device_labels[torch.as_tensor(idx_chunk, dtype=torch.int64).to(dev)]
    pf, pi = params.pf.to(dev), params.pi.to(dev)

    metrics = []
    for k in range(steps):
        x = fused_light_pipeline(gather_dataset, idx_eff[k], pf[k], pi[k],
                                 h=height, w=width)
        metrics.append(train_step(state, x, labels[k], optimizer=optimizer))
    return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}


@torch.no_grad()
def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE loss over the batch, logits), the model in eval mode (an
    EtinyNet normalizes with its running statistics)."""
    logits = model.eval()(images)
    return F.cross_entropy(logits, labels, reduction="sum"), logits
