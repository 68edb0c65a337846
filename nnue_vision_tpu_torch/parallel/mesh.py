"""The mesh of processes, its sharding helpers and the collectives the port
uses (port of `nnue_vision_tpu/parallel/mesh.py`).

The JAX package lays a `Mesh` over chips, shards batches along its `data`
axis, replicates params, and lets GSPMD insert the gradient psum. Here one
process drives one card: a `Mesh` is this process's view of a grid of
ranks (the first `n` of the `torch.distributed` group), with a process
group per axis, and the step code calls the collectives itself:

* `all_reduce` — a differentiable SUM; its backward all-reduces the
  gradient (the adjoint of a sum that every rank receives);
* `all_gather` — an `all_reduce` of a zero-filled buffer in which this
  rank wrote its slot: `x + 0` is exact, so the result is bit-equal to a
  concatenation, for floats and ints; its backward is this rank's slot of
  the all-reduced gradient.

Both are built from `all_reduce` and `broadcast` only, which NCCL and
gloo (with CUDA tensors too) both take, and they reduce with SUM and
divide where a mean is wanted: gloo has no AVG. A bfloat16 or other
narrow tensor is reduced in float32 and cast back. A collective that
fails raises; nothing falls back to one process.

A mesh of one rank has no process groups, and every collective on it is
the identity, so the one-process path runs the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# dtypes both backends reduce natively; others go through float32
_NATIVE = (torch.float32, torch.float64, torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its size, this rank's index
    along it, and the process group of the ranks that differ from this one
    only along it (None when the axis has one rank)."""
    name: str
    size: int
    index: int
    group: Any = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a grid of ranks. `member` is False for a rank of
    the process group that lies outside the mesh (it takes no step);
    `group` spans every rank of the mesh; `device` holds the small tensors
    the mesh's own bookkeeping sends (flags, objects)."""
    axes: Tuple[Axis, ...]
    member: bool
    group: Any
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def size(self) -> int:
        return int(np.prod([a.size for a in self.axes]))

    @property
    def first(self) -> bool:
        """True on the mesh's first rank (rank 0 of the process group)."""
        return self.member and all(a.index == 0 for a in self.axes)

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise ValueError(f"mesh has no {name!r} axis: {self.axis_names}")

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's `obj` on every rank of the mesh."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def _default_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh over the first `n_devices` ranks of the process group (all of
    them by default), laid out row-major in `shape` (by default all ranks
    on the first axis and 1 on the others, as the JAX package fills
    trailing axes). Every rank of the group must call it, in the same
    order: it creates the axes' process groups."""
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    world = dist.get_world_size() if initialized else 1
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks on axes {axes}")
    device = torch.device(device) if device is not None else _default_device()
    member = rank < n
    if n == 1:
        return Mesh(tuple(Axis(a, 1, 0) for a in axes), member, None, device)

    mesh_group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    ids = np.arange(n).reshape(shape)
    coords = np.unravel_index(min(rank, n - 1), shape)
    built = []
    for i, name in enumerate(axes):
        group = None
        if shape[i] == n:
            group = mesh_group
        elif shape[i] > 1:
            rows = np.moveaxis(ids, i, -1).reshape(-1, shape[i])
            for row in rows:  # every rank creates every group
                g = dist.new_group([int(r) for r in row])
                if rank in row:
                    group = g
        built.append(Axis(name, shape[i], int(coords[i]), group))
    return Mesh(tuple(built), member, mesh_group if member else None, device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over `group` of a contiguous tensor, in place where its dtype is
    native to the backends, else through float32 (cast back)."""
    if t.dtype in _NATIVE:
        dist.all_reduce(t, group=group)
        return t
    wide = t.to(torch.float32)
    dist.all_reduce(wide, group=group)
    return wide.to(t.dtype)


def _broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's copy of a contiguous tensor (through float32 where its
    dtype is not native)."""
    if t.dtype in _NATIVE:
        dist.broadcast(t, src=0, group=group)
        return t
    wide = t.to(torch.float32)
    dist.broadcast(wide, src=0, group=group)
    return wide.to(t.dtype)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone(memory_format=torch.contiguous_format)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(_fresh(x), group)

    @staticmethod
    def backward(ctx, g):
        return _sum(_fresh(g), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * n, n).copy_(x)
        ctx.slot = (group, index * n, n, dim)
        return _sum(buf, group)

    @staticmethod
    def backward(ctx, g):
        group, start, n, dim = ctx.slot
        return (_sum(_fresh(g), group).narrow(dim, start, n).contiguous(),
                None, None, None, None)


def all_reduce(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """SUM of `x` over the ranks of `axis`, differentiable; `x` itself
    where the axis has one rank (or is None)."""
    if axis is None or axis.group is None:
        return x
    return _AllReduce.apply(x, axis.group)


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int = 0
               ) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim` in axis
    order, bit-equal to a concatenation, differentiable."""
    if axis is None or axis.group is None:
        return x
    return _AllGather.apply(x, axis.group, axis.size, axis.index, dim)


def average_gradients(mesh: Mesh, grads: Dict[str, Optional[torch.Tensor]],
                      params: Dict[str, torch.Tensor],
                      sharded: Iterable[str] = (),
                      scalars: Sequence[torch.Tensor] = ()
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Each gradient summed over the ranks that hold a copy of its
    parameter and divided by the mesh's size, with `scalars` (the step's
    loss and accuracy) averaged in the same reduction: one flat float32
    buffer per group, a None gradient counting as zeros. A parameter in
    `sharded` is split over the model axis, so its copies are the data
    axis's; every other one is replicated over the whole mesh.

    With the collectives' exact adjoints each rank's gradient is that of
    the sum of every rank's loss; the division makes it the gradient of
    the mean loss over the global batch."""
    sharded = set(sharded)
    dense = {n: g if g is not None else torch.zeros_like(params[n])
             for n, g in grads.items()}
    out = dict(dense)
    scalars_out: List[torch.Tensor] = []
    buckets = [([n for n in dense if n not in sharded], list(scalars),
                mesh.group)]
    if sharded:
        buckets.append(([n for n in dense if n in sharded], [],
                        mesh.axis(DATA_AXIS).group))
    for names, extra, group in buckets:
        parts = [dense[n].reshape(-1).to(torch.float32) for n in names]
        parts += [s.reshape(-1).to(torch.float32) for s in extra]
        if not parts:
            continue
        flat = torch.cat(parts)
        if group is not None:
            flat = _sum(flat, group)
        flat = flat / mesh.size
        pos = 0
        for n in names:
            k = dense[n].numel()
            out[n] = flat[pos:pos + k].view(dense[n].shape).to(dense[n].dtype)
            pos += k
        for s in extra:
            scalars_out.append(flat[pos:pos + s.numel()].view(s.shape).to(s.dtype))
            pos += s.numel()
    return out, scalars_out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree):
    """fn over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = DATA_AXIS, dim: int = 0):
    """This rank's slice of every array or tensor of `batch` along `dim`
    (the leading one by default; 1 for a (steps, batch) chunk), cut in
    equal parts over `axis`; contiguous."""
    ax = mesh.axis(axis)

    def cut(x):
        n = x.shape[dim]
        if n % ax.size:
            raise ValueError(
                f"dim {dim} of size {n} does not split over {ax.size} ranks "
                f"of axis {ax.name!r}")
        per = n // ax.size
        if isinstance(x, torch.Tensor):
            return x.narrow(dim, ax.index * per, per).contiguous()
        return np.ascontiguousarray(
            np.take(x, np.arange(ax.index * per, (ax.index + 1) * per), axis=dim))

    return tree_map(cut, batch)


def pad_batch_to_devices(batch, n_devices: int):
    """Zero-pad the leading dim of every array or tensor so it divides
    `n_devices`."""
    def pad(x):
        rem = (-x.shape[0]) % n_devices
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
        return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))

    return tree_map(pad, batch)


def _named_tensors(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().items())
    if isinstance(tree, torch.Tensor):
        return [(prefix or "tensor", tree)]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _named_tensors(v, f"{prefix}{k}.")
        return out
    return []


def replicate(mesh: Mesh, tree):
    """Rank 0's copy of every tensor of `tree` (a module's parameters and
    buffers, or a dict of tensors) on every rank of the mesh, in place, and
    a check that every rank held rank 0's values already: the ranks build
    their models and states from one seed, so a difference is a fault and
    raises on every rank."""
    if mesh.group is None:
        return tree
    differ = []
    for name, t in _named_tensors(tree):
        ref = _broadcast(_fresh(t), mesh.group)
        if not torch.equal(ref, t):
            differ.append(name)
        with torch.no_grad():
            t.copy_(ref)
    count = _sum(torch.tensor([len(differ)], dtype=torch.int64,
                              device=mesh.device), mesh.group)
    if int(count) > 0:
        raise RuntimeError(
            f"replicate: the ranks' copies differ ({int(count)} tensors in "
            f"all; here: {differ[:5]})")
    return tree


def nnue_param_shardings(mesh: Mesh, params) -> Dict[str, Tuple]:
    """The tensor-parallel plan over the mesh's model axis: per parameter,
    the axis each dim is split over (None: whole). The feature
    transformer's output dimension (L1) splits: `ft_w` (F, L1) and `ft_b`
    over L1, `fc1_w` (L2, L1) over its input dimension to match; the rest
    is replicated. `params` is a module or a dict of its parameters."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has no '{MODEL_AXIS}' axis: {mesh.axis_names}")
    names = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    plan = {"ft_w": (None, MODEL_AXIS), "ft_b": (MODEL_AXIS,),
            "fc1_w": (None, MODEL_AXIS)}
    return {name: plan.get(name, ()) for name in names}


def _split_dim(spec: Tuple) -> Optional[Tuple[int, str]]:
    for dim, axis in enumerate(spec):
        if axis is not None:
            return dim, axis
    return None


def shard_params(mesh: Mesh, model: nn.Module,
                 shardings: Optional[Dict[str, Tuple]] = None) -> nn.Module:
    """Keep this rank's slice of each split parameter of `model` (an NNUE)
    per the plan (`nnue_param_shardings` by default), in place. The model
    then computes on its shards and calls the collectives of the model
    axis in its forward (`models/nnue.py`); its `tp_sharded` names the
    split parameters, whose gradients are reduced over the data axis only
    (`average_gradients`)."""
    if shardings is None:
        shardings = nnue_param_shardings(mesh, model)
    split = []
    for name, spec in shardings.items():
        cut = _split_dim(spec)
        if cut is None:
            continue
        dim, axis = cut
        ax = mesh.axis(axis)
        p = getattr(model, name)
        if p.shape[dim] % ax.size:
            raise ValueError(f"{name} dim {dim} ({p.shape[dim]}) does not split "
                             f"over {ax.size} ranks")
        per = p.shape[dim] // ax.size
        setattr(model, name, nn.Parameter(
            p.detach().narrow(dim, ax.index * per, per).clone()))
        split.append(name)
    model.tp_axis = mesh.axis(MODEL_AXIS)
    model.tp_sharded = tuple(split)
    return model


def bind_data_axis(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Point every submodule of `model` that has a `data_axis` (an
    EtinyNet's norms) at the mesh's data axis, so that its training
    statistics span the global batch; unbind them for None or a data axis
    of one rank."""
    axis = None
    if mesh is not None and mesh.axis(DATA_AXIS).size > 1:
        axis = mesh.axis(DATA_AXIS)
    for m in model.modules():
        if hasattr(m, "data_axis"):
            m.data_axis = axis
    return model


def unshard_params(mesh: Mesh, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a model sharded by `shard_params`, whole (the
    split ones gathered over the model axis), detached."""
    shardings = nnue_param_shardings(mesh, model)
    out = {}
    for name, p in model.named_parameters():
        cut = _split_dim(shardings[name]) if name in model.tp_sharded else None
        t = p.detach()
        out[name] = t if cut is None else all_gather(t, mesh.axis(cut[1]), cut[0])
    return out


def shard_map(fn: Callable, mesh: Mesh, axis: str = DATA_AXIS) -> Callable:
    """`fn(batch)` run on this rank's rows of the batch (zero-padded to a
    multiple of the axis), its outputs (a tensor, or a tuple of tensors and
    Nones) gathered back to the whole batch on every rank: data-parallel
    serving and evaluation, JAX's `shard_map` with the batch split over
    `axis` and everything else replicated."""
    ax = mesh.axis(axis)

    def run(batch: torch.Tensor):
        b = batch.shape[0]
        out = fn(shard_batch(mesh, pad_batch_to_devices(batch, ax.size), axis))

        def gather(t):
            return None if t is None else all_gather(t, ax, 0)[:b]

        if isinstance(out, tuple):
            return tuple(gather(t) for t in out)
        return gather(out)

    return run
