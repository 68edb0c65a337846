"""The program's own spans, counters and gauges, as its tracing module
(`nnue_vision_tpu_torch/tracing.py`) holds them after the traced window:
the spans of the newest profiled stretch (the window's chunk or serving
calls) and the newest chunk graph's nodes by phase. A program without
that module gives nothing: every function here returns None there, as it
does where the window recorded no such span."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def _tracing():
    try:
        from nnue_vision_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def span_ns(names: Sequence[str]) -> Optional[int]:
    """The summed length of every span named in `names`, in ns; None where
    there is none."""
    tracing = _tracing()
    if tracing is None:
        return None
    found = [s.end_ns - s.start_ns for s in tracing.spans() if s.name in names]
    return sum(found) if found else None


def span_count(name: str, key: str) -> Optional[float]:
    """The count `key` summed over the spans named `name`; None where there
    is no such span."""
    tracing = _tracing()
    if tracing is None:
        return None
    found = [s.counts[key] for s in tracing.spans() if s.name == name]
    return sum(found) if found else None


def gauge(name: str) -> Optional[Dict[str, int]]:
    """The gauge `name`; None where the program set none."""
    tracing = _tracing()
    return None if tracing is None else tracing.GAUGES.get(name)
