"""The traced sub-window: `torch.profiler` (CPU and CUDA activities) around
a bounded stretch of steady state, with its events kept in memory and
reduced to what the per-layer readers take: each device kernel's total
time and count by name, the seconds in which any device operation ran
(the union of their intervals), the window's length, the device
operations that took most time and the longest idle gaps, each gap named
by the innermost host operation running at its middle.

The window is the harness's own `perfbench.window` range, which ends with
a synchronize, so the device's work of the window lies inside it.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "perfbench.window"
TOP = 10


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns() * 1e-9
        out.append((e.name(), device, start, start + e.duration_ns() * 1e-9))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[Tuple[str, bool, float, float]]) -> dict:
    """The reduction of one traced window's events (see the module's
    docstring); raises where the window's range is missing."""
    windows = [(a, b) for n, dev, a, b in events if n == WINDOW and not dev]
    if not windows:
        raise RuntimeError("the trace holds no perfbench.window range")
    w0, w1 = windows[0]
    kernels: Dict[str, List[float]] = {}
    intervals = []
    for name, dev, a, b in events:
        if not dev or name == WINDOW:  # the range's own device-side copy
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += b - a
        k[1] += 1
        intervals.append((a, b))
    busy = _union(intervals)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((a - edge, edge, a))
        edge = max(edge, b)
    gaps.sort(reverse=True)
    host = sorted((a, b, n) for n, dev, a, b in events
                  if not dev and n != WINDOW and a >= w0 and b <= w1)
    starts = [h[0] for h in host]

    def label(mid: float) -> str:
        best = None
        for a, b, n in host[:bisect.bisect_right(starts, mid)]:
            if a <= mid <= b and (best is None or b - a < best[0]):
                best = (b - a, n)
        return best[1] if best else "(no host operation)"

    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "kernels": {n: (s, c) for n, (s, c) in kernels.items()},
        "busy_s": sum(b - a for a, b in busy),
        "window_s": w1 - w0,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, (s, _) in top_ops],
            "idle_gaps": [[label((a + b) / 2)[:160], g]
                          for g, a, b in gaps[:TOP]],
        },
    }


def traced(body: Callable[[], None], device: torch.device) -> dict:
    """`body` under the profiler inside the window's range, synchronized at
    both ends; its `summarize`d events. On the CPU the profiler traces the
    host alone and no device operation is found."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            body()
            if cuda:
                torch.cuda.synchronize(device)
    return summarize(_events(prof))


def kernel_time(trace: dict, names) -> Tuple[float, int]:
    """(seconds, launches) of the device kernels whose names contain any of
    `names`, over the traced window."""
    s, c = 0.0, 0
    for n, (sec, cnt) in trace["kernels"].items():
        if any(k in n for k in names):
            s += sec
            c += cnt
    return s, c
