"""Process-group initialization and per-process data feeding (port of
`nnue_vision_tpu/parallel/distributed.py`).

The JAX package wires hosts into one runtime with `jax.distributed` and
spans every chip with one global mesh. Here one process drives one card,
and the processes form a `torch.distributed` group: NCCL between cards,
gloo on the CPU (or, named explicitly, between processes that share one
card, which NCCL refuses). The same train CLI runs single-process, under
torchrun, or with explicit arguments:

    from nnue_vision_tpu_torch.parallel.distributed import initialize_distributed
    initialize_distributed(coordinator="10.0.0.1:29500", num_processes=4,
                           process_id=rank)

No tensor spans processes in PyTorch: each process feeds only its shard of
the global batch, so `host_batch_to_global` returns the local slice it is
given, on the process's device.

`spawn` starts a group of worker processes with a time limit and ends them
all when one fails, so that no rank waits on a dead peer.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nnue_vision_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh, tree_map

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def rank_and_world() -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _init_method(coordinator: str) -> str:
    """A coordinator "host:port" as a TCP rendezvous; a URL (tcp://,
    file://, env://) as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to a process group (idempotent); True when a
    group is up after the call.

    Arguments default to torchrun's variables (MASTER_ADDR and MASTER_PORT
    for the coordinator, WORLD_SIZE, RANK, LOCAL_RANK), so a launcher can
    configure processes without touching the command line. A no-op when
    neither arguments nor variables ask for distribution. The backend is
    NCCL where CUDA is available and gloo otherwise, unless `backend` names
    one (gloo for several processes on one card). Where CUDA is available
    the process takes card `local_device_ids[0]`, else LOCAL_RANK (or the
    rank) modulo the cards visible. Every collective of the group raises
    after `timeout_s` seconds instead of waiting forever on a lost rank.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return False  # single process
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs a coordinator, the number of processes and "
            f"this process's id: got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        if local_device_ids:
            card = int(local_device_ids[0])
        else:
            card = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(card % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_global_mesh(axes: Tuple[str, ...] = (DATA_AXIS,),
                     device=None) -> Mesh:
    """A mesh over every process of the group (1-D by default).

    For two axes the trailing (model) axis stays within a host: it takes
    the largest size up to the processes per host (LOCAL_WORLD_SIZE, else
    the cards visible) that divides the group, and the data axis spans the
    hosts, as the JAX package lays out its global mesh."""
    _, world = rank_and_world()
    if len(axes) == 1:
        return make_mesh(world, axes, device=device)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(
        1, torch.cuda.device_count())
    model = next(c for c in range(min(per_host, world), 0, -1) if world % c == 0)
    shape = (world // model, model) + (1,) * (len(axes) - 2)
    return make_mesh(world, axes, shape=shape, device=device)


def process_local_slice(n: int) -> Tuple[int, int]:
    """(start, stop) of this process's contiguous share of n samples: an
    equal split, the last process taking the remainder."""
    rank, world = rank_and_world()
    per = n // world
    start = rank * per
    stop = n if rank == world - 1 else start + per
    return start, stop


def host_batch_to_global(mesh: Mesh, batch):
    """This process's shard of a global batch, as tensors on the mesh's
    device. Each process passes its own shard (leading dim = global batch
    / processes); no tensor spans processes, so the shard is the result."""
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), batch)


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          timeout_s: Optional[float]) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes (the spawn start
    method) and wait for all of them. Raises when one fails, ending the
    others, and TimeoutError when they outlast `timeout_s` (None: no
    limit; a lost rank still raises in its peers' next collective, after
    the group's timeout), ending all."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + (timeout_s if timeout_s is not None else 1e18)
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} worker(s) still running after {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        for proc in ctx.processes:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
