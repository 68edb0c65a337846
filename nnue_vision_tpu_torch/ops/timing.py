"""The probes' timing harness: best-of-N ms per call of a function that
runs many times with no host in between, and the card's published rates
for the bounds printed beside a time.

Port of `nnue_vision_tpu/ops/timing.py` `scalar_chained_best_ms`, with the
JAX protocol kept: one warm-up call, then `reps` calls that run with no
host in between, timed `n_timing` times, the best reported per call.
`chained_best_ms` times a function of no argument; `scalar_chained_best_ms`
keeps the JAX signature, `fwd_with_bump(data, bump)`.

On the card the `reps` calls are captured once in one CUDA graph
(`torch.cuda.graph`) and each timing replays it between two CUDA events,
so the host's launch cost is not in the time. The TPU harness threaded a
scalar "bump" from each rep's output into the next rep's input so that the
reps could not overlap or be merged; on the card that is not needed:
kernels launched on one stream run one after another, in order, each
reading its inputs anew. An input smaller than the card's 50 MB L2 can
stay there from one rep to the next, which the TPU's reps never saw; a
caller that wants it read from device memory cycles through several
buffers.

The function is called once before capture (the warm-up), so the kernels'
library is built and loaded and each kernel's one-time host set-up has
run; under capture it must not read a tensor back to the host. The launch
counts (`LAUNCHES` of each kernel module) count the warm-up and the
captured calls, which are host calls; replays add nothing.

On the CPU the calls run on the host clock: for the tests only, never a
device time.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Tuple

import torch

# The H100 SXM's published rates (NVIDIA's data sheet; dense, at the full
# 700 W power limit), for the bounds the probes print beside a time.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 off)
BF16_FLOPS_PER_S = 989e12  # bfloat16 on the tensor cores
INT8_OPS_PER_S = 1979e12  # int8 on the tensor cores


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bytes_bound_ms(*tensors) -> float:
    """The least ms the card could take to read or write `tensors` once
    each from device memory."""
    return nbytes(*tensors) / HBM_BYTES_PER_S * 1e3


def bound_ms(moved: int, *, int8_ops: float = 0.0, bf16_flops: float = 0.0,
             f32_flops: float = 0.0) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `moved` bytes (each input read once, each output written once) and
    do the operations, each kind at its published rate."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
             + f32_flops / F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _check_reps(reps: int, n_timing: int) -> None:
    if reps < 1 or n_timing < 1:
        raise ValueError(f"reps and n_timing must be >= 1; got {reps}, "
                         f"{n_timing}")


def _host_runs(fn: Callable, reps: int, n_timing: int, device) -> float:
    """Best-of-`n_timing` ms per call over `reps` calls in a row, host
    clock; a CUDA `device` is synchronized before each run and after it."""
    best = float("inf")
    for _ in range(n_timing):
        if device is not None:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if device is not None:
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def host_best_ms(fn: Callable, reps: int, n_timing: int = 3) -> float:
    """Best-of-`n_timing` ms per call of `fn()` over `reps` calls in a row
    on the host clock, after a warm-up call: each call's launches included.
    `fn` returns a tensor; on a card its device is synchronized before each
    run and after it."""
    _check_reps(reps, n_timing)
    out = fn()  # warm-up
    return _host_runs(fn, reps, n_timing, out.device if out.is_cuda else None)


def chained_best_ms(fn: Callable, reps: int, n_timing: int = 3) -> float:
    """Best-of-`n_timing` ms per call of `fn()` over `reps` calls in a row.

    `fn` takes no argument and returns a tensor, whose device decides the
    clock: CUDA events around a graph replay on a card, the host clock on
    the CPU.
    """
    _check_reps(reps, n_timing)
    out = fn()  # warm-up
    if not out.is_cuda:
        return _host_runs(fn, reps, n_timing, None)

    dev = out.device
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # warm replay
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(n_timing):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / reps


def scalar_chained_best_ms(fwd_with_bump: Callable, data: torch.Tensor,
                           reps: int, n_timing: int = 3) -> float:
    """Best-of-`n_timing` ms per rep of `fwd_with_bump(data, bump)`, the
    reps chained through a scalar (JAX `scalar_chained_best_ms`): each
    rep's `bump` is the previous rep's leading output element times 0, a
    0-dim float32 tensor on `data`'s device (0 before the first). The reps
    are `chained_best_ms`'s: one CUDA graph on a card."""
    bump = {"t": torch.zeros((), dtype=torch.float32, device=data.device)}

    def rep():
        out = fwd_with_bump(data, bump["t"])
        bump["t"] = out.reshape(-1)[0].to(torch.float32) * 0.0
        return out

    return chained_best_ms(rep, reps, n_timing)


def card(device) -> Optional[str]:
    """The card's `name, power.limit` as nvidia-smi gives them, or None for
    a CPU device."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
