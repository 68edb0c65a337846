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

Data parallelism (a `Mesh` in the TrainState, `parallel/mesh.py`): each
rank holds the whole model and trains on its shard of the global batch.
Between `torch.autograd.grad` and the optimizer the gradients are averaged
over the mesh in one float32 all-reduce, the step's loss and accuracy with
them (JAX's GSPMD psum; `.grad` stays empty, so DDP's reducer would never
fire), so the global-norm clip sees the reduced gradients, as in JAX. Every
rank draws the augmentation of the *global* batch from the same generator
stream, as JAX draws outside `shard_map`, and keeps its rows, so a dp run
computes what one process computes on the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nnue_vision_tpu_torch.data.augment import preprocess_batch, shard_rows
from nnue_vision_tpu_torch.models.nnue import NNUE, nnue_clip_weights
from nnue_vision_tpu_torch.ops.input_pipeline import (
    LightParams,
    draw_light_params,
    fused_light_pipeline,
    identity_light_params,
)
from nnue_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce,
    average_gradients,
    shard_map,
)
from nnue_vision_tpu_torch.training.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and norm statistics), the optimizer state,
    the step count, and the mesh the step runs over (None: one process)."""
    model: nn.Module
    opt_state: OptState
    step: int = 0
    mesh: Optional[Mesh] = None


def make_train_state(model: nn.Module, optimizer: Optimizer,
                     mesh: Optional[Mesh] = None) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())),
                      mesh=mesh)


def data_shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this rank's index, the number of shards) of the global batch along
    the mesh's data axis; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    axis = mesh.axis(DATA_AXIS)
    return axis.index, axis.size


def _sq_norm(model: nn.Module):
    """The squared global norm of a tensor-parallel model's gradients: the
    replicated ones whole here, the shards' parts summed over the model
    axis. None for an unsharded model (the optimizer's own sum)."""
    sharded = set(getattr(model, "tp_sharded", ()))
    if not sharded:
        return None

    def sq(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        whole = sum(torch.sum(g * g) for n, g in grads.items() if n not in sharded)
        part = sum(torch.sum(g * g) for n, g in grads.items() if n in sharded)
        return whole + all_reduce(part, model.tp_axis)

    return sq


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
    Under a mesh the images and labels are this rank's shard, and the
    gradients, loss and accuracy are averaged over the mesh first.
    Returns {"loss", "accuracy"} as device scalars."""
    model = state.model.train()
    params = dict(model.named_parameters())
    logits = model(images)
    loss = distillation_loss(logits, labels, images, teacher)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))
    loss = loss.detach()
    acc = (logits.detach().argmax(dim=-1) == labels).to(torch.float32).mean()
    if state.mesh is not None:
        grads, (loss, acc) = average_gradients(
            state.mesh, grads, params,
            sharded=getattr(model, "tp_sharded", ()), scalars=(loss, acc))
    optimizer.step(params, grads, state.opt_state, sq_norm=_sq_norm(model))
    if isinstance(model, NNUE):
        nnue_clip_weights(model)
    state.step += 1
    return {"loss": loss, "accuracy": acc}


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
    from `noise_gen`, a generator on the dataset's device. Under a mesh
    `idx` is the global batch: this rank gathers and trains on its rows,
    augmented with its rows of the global batch's draws."""
    idx = np.asarray(idx)
    _check_indices(idx, device_labels.shape[0])
    shard = data_shard(state.mesh)
    idx = idx[shard_rows(len(idx), shard)]
    i = torch.as_tensor(idx, dtype=torch.int64).to(device_images.device)
    x = preprocess_batch(gen, device_images[i], strength=strength,
                         augment=augment, noise_gen=noise_gen, shard=shard)
    return train_step(state, x, device_labels[i], optimizer=optimizer,
                      teacher=teacher)


def scanned_train_steps_fused(state: TrainState, gather_dataset: torch.Tensor,
                              device_labels: torch.Tensor,
                              idx_chunk: np.ndarray, gen: torch.Generator, *,
                              optimizer: Optimizer, height: int, width: int,
                              identity_augment: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """K train steps of the light tier with the whole input path in one K3
    launch per step. The (K, B) draws are made once, on the host, and the
    effective indices (flip folded in as +N) are checked there, while they
    are numpy. Under a mesh `idx_chunk` holds the global batches: the draws
    are the global batches', and this rank takes its columns of the
    indices, draws and labels before its K3 launches.

    `identity_augment`: no flip, α = 1, β = 0, no hole (JAX's option), so
    the step equals the unaugmented one."""
    idx_chunk = np.asarray(idx_chunk)
    steps, batch = idx_chunk.shape
    n = device_labels.shape[0]
    _check_indices(idx_chunk, n)
    params = (identity_light_params(steps, batch) if identity_augment
              else draw_light_params(gen, steps, batch, height, width))
    idx_eff = idx_chunk + n * params.flip.numpy().astype(np.int64)
    _check_indices(idx_eff, 2 * n)
    cols = shard_rows(batch, data_shard(state.mesh))
    idx_chunk, idx_eff = idx_chunk[:, cols], idx_eff[:, cols]
    params = LightParams(*(t[:, cols].contiguous() for t in params))
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
def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
              mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE loss over the batch, logits), the model in eval mode (an
    EtinyNet normalizes with its running statistics). Under a mesh each
    rank runs its rows of the batch and the logits are gathered: every
    rank gets the whole batch's."""
    model = model.eval()
    logits = model(images) if mesh is None else shard_map(model, mesh)(images)
    return F.cross_entropy(logits, labels, reduction="sum"), logits
