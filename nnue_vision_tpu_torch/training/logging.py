"""Run logging: early-log capture and replay, and a local JSONL run tracker
(port of `nnue_vision_tpu/training/logging.py`).

A run records its config, scalar metrics with their steps and its log
lines under `<log_dir>/runs/<run_name>/`. The JAX package also reports to
Weights & Biases when `wandb` and an API key are present; the port tracks
locally only.

In a data-parallel run only rank 0 speaks: `set_rank` drops the early-log
lines of the other ranks, and their `Run` keeps its name and writes
nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

_EARLY_LOGS: List[str] = []
_ACTIVE_RUN: Optional["Run"] = None
_RANK = 0


def set_rank(rank: int) -> None:
    """This process's rank in a data-parallel run: ranks other than 0 log
    nothing."""
    global _RANK
    _RANK = int(rank)


def default_run_name() -> str:
    return f"run_{time.strftime('%Y%m%d_%H%M%S')}"


def early_log(message: str) -> None:
    """Print now, and keep the line for the run's log once it exists (on
    rank 0 only)."""
    if _RANK != 0:
        return
    print(message, flush=True)
    _EARLY_LOGS.append(f"{time.strftime('%H:%M:%S')} {message}")


def replay_early_logs() -> None:
    """Write the kept lines into the active run's log."""
    run = _ACTIVE_RUN
    if run is None:
        return
    for line in _EARLY_LOGS:
        run.log_text(line)
    _EARLY_LOGS.clear()


class Run:
    """A training run handle: config.json, metrics.jsonl and log.txt in
    `self.dir`; on a data-parallel rank other than 0 (`set_rank`) the same
    name and directory, and nothing written."""

    def __init__(self, project: str, config: Dict[str, Any],
                 run_id: Optional[str] = None, log_dir: str = "logs"):
        self.project = project
        self.config = config
        self._step = 0
        self.name = run_id or default_run_name()
        self.dir = Path(log_dir) / "runs" / self.name
        self.url = f"file://{self.dir}"
        self.write = _RANK == 0
        self._metrics_file = None
        if not self.write:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "config.json").write_text(
            json.dumps({k: repr(v) for k, v in config.items()}, indent=2)
        )
        self._metrics_file = open(self.dir / "metrics.jsonl", "a")

    def log(self, data: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"step": step if step is not None else self._step,
               "time": time.time(), **data}
        self._step = rec["step"] + 1
        if not self.write:
            return
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    def log_text(self, line: str) -> None:
        if not self.write:
            return
        with open(self.dir / "log.txt", "a") as f:
            f.write(line + "\n")

    def finish(self) -> None:
        global _ACTIVE_RUN
        if self._metrics_file is not None:
            self._metrics_file.close()
        _ACTIVE_RUN = None


def init_run(project: str, config: Dict[str, Any],
             run_id: Optional[str] = None, log_dir: str = "logs") -> Run:
    global _ACTIVE_RUN
    _ACTIVE_RUN = Run(project, config, run_id=run_id, log_dir=log_dir)
    return _ACTIVE_RUN
