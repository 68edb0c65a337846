"""Finding a cell's parts by name: `BENCHMARK.json` at the root of the
checkout names the cell's configuration (its file), its traffic mix
(`perfbench/traffic/<mix>.json`) and its metrics; each per-layer metric
is read by `perfbench/metrics/<name>.py`, each configuration family is
driven by `perfbench/families/<family>.py`, each kind of traffic by
`perfbench/kinds/<kind>.py`, and each cell's correctness limits live in
`perfbench/limits/<workload>.json`. Nothing here knows a name: a later
change adds a configuration, a mix, a cell or a metric as files and
entries only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with everything its run reads."""
    root: Path
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json; raises KeyError for a
    name it does not hold and FileNotFoundError for a missing file."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(root / configs[w["config"]]["file"]))
    config["name"] = w["config"]
    traffic = _json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    limits = _json(root / "perfbench" / "limits" / f"{workload}.json")
    return Cell(root, w, config, traffic, limits,
                [m for m in bench["end_to_end"] if _for_cell(m, workload)],
                [m for m in bench["per_layer"] if _for_cell(m, workload)])


def _module(kind: str, name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.{kind}.{name}")


def family(config: dict) -> ModuleType:
    """`perfbench/families/<family>.py` of a configuration."""
    return _module("families", config["family"])


def kind(traffic: dict) -> ModuleType:
    """`perfbench/kinds/<kind>.py` of a traffic mix."""
    return _module("kinds", traffic["kind"])


def metric_reader(root: Path, name: str) -> ModuleType:
    """`perfbench/metrics/<name>.py` under `root`, loaded by path (a metric's
    name may hold dots)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
