"""The port's spans and counters: where its host time goes, and how much
work each layer does, read by the benchmark's per-layer metrics and
written into the training loop's `profile_dir` trace.

A span (`span`) marks a stretch of host time at a layer boundary. While a
torch profiler is active (`torch.profiler.profile`, which the training
loop's `profile_dir` and the benchmark's traced window start), it appends
a record to an in-memory buffer: its name, the innermost span open on the
thread when it began, its start and end, and its counts. Both ends are
`time.time_ns()`, the Unix-epoch clock the profiler stamps its host events
with, so the spans and the profiler's events lie on one timeline. With no
profiler active a span reads one flag and records nothing. A span is not a
`record_function` range: such a range costs about 16 µs even with no
profiler, and under CUDA activity it also gets a device-side event, which
a reading of the device's busy time would count as an operation.

`spans()` returns the records of the newest profiled stretch: the buffer
starts anew with the first span recorded after a span found the profiler
off (two profiled stretches with no span call between them share it), or
after `clear()`. It holds at most `MAX_SPANS` records and counts those it
drops.

The counters are one registry (`COUNTERS`): each module that counts asks
`counters` for its group's dict and adds to it (the kernel modules'
`LAUNCHES`, the draws' `host_draw_calls`). `GAUGES` holds values that are
set, not added to: the newest chunk graph's nodes by phase (a copy of its
`ChunkGraph.phase_nodes`, for a reader that holds no graph).

Spans (see `PERF.md` for the metric each feeds): `chunk` (a train chunk
call; `steps`) with `chunk.draws` (`draw_calls`), `chunk.pack`,
`chunk.load`, `chunk.capture`, `chunk.replay` and `chunk.eager`
(`training/step.py`); `serve.kernels` (the int8 serving kernels' wrappers:
`nnue_engine_forward_mega` in `ops/nnue_kernels.py`, `etiny_forward_kernel`
in `ops/etiny_kernels.py`) and the EtinyNet's `serve.stem` and `serve.tail`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the innermost span open when this one began
    start_ns: int          # Unix-epoch ns, the profiler's host clock
    end_ns: int
    counts: Dict[str, float]


COUNTERS: Dict[str, Dict[str, int]] = {}
GAUGES: Dict[str, Dict[str, int]] = {}


def counters(group: str, *names: str) -> Dict[str, int]:
    """The registry's counters of `group`, each of `names` at 0 where new:
    the counting module keeps the dict and adds to it."""
    d = COUNTERS.setdefault(group, {})
    for name in names:
        d.setdefault(name, 0)
    return d


def snapshot() -> Dict[Tuple[str, str], int]:
    """Every counter's value, by (group, name)."""
    return {(g, n): v for g, d in COUNTERS.items() for n, v in d.items()}


def restore(values: Dict[Tuple[str, str], int]) -> None:
    """Set each counter of `values` (a `snapshot`) back to its value."""
    for (g, n), v in values.items():
        COUNTERS[g][n] = v


def add(deltas: Dict[Tuple[str, str], int]) -> None:
    """Add each delta to its (group, name) counter."""
    for (g, n), v in deltas.items():
        COUNTERS[g][n] += v


_STATS = counters("tracing", "spans_dropped")
_records: List[Span] = []
_stale = True  # the next span recorded starts the buffer anew
_local = threading.local()


class _Off:
    """The span of a call that found no profiler: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _On:
    """A span being recorded."""
    __slots__ = ("name", "counts", "parent", "start_ns", "_stack")

    def __init__(self, name: str, counts: Dict[str, float]):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._stack = stack
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._stack.pop()
        _record(Span(self.name, self.parent, self.start_ns, end, self.counts))
        return False

    def count(self, **counts) -> None:
        """Set counts known only inside the span."""
        self.counts.update(counts)


def _record(s: Span) -> None:
    global _stale
    if _stale:
        _records.clear()
        _stale = False
    if len(_records) >= MAX_SPANS:
        _STATS["spans_dropped"] += 1
    else:
        _records.append(s)


def span(name: str, **counts):
    """A context manager that records the stretch it encloses as `name`,
    with `counts`, while a torch profiler is active (see the module's
    docstring). `with span(...) as s: ... s.count(k=v)` sets a count inside."""
    global _stale
    if not _profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    return _On(name, counts)


def clear() -> None:
    """Empty the buffer: the next profiled stretch is read alone."""
    global _stale
    _records.clear()
    _stale = True


def spans() -> List[Span]:
    """The records of the newest profiled stretch, in the order they ended."""
    return list(_records)


def dropped() -> int:
    """Spans not recorded since the process started: the buffer was full."""
    return _STATS["spans_dropped"]
