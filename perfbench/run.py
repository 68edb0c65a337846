"""The benchmark of `nnue_vision_tpu_torch` on one NVIDIA H100.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell `<name>` of `BENCHMARK.json`
names its configuration, traffic mix and metrics; `perfbench/spec.py`
finds their files. One run:

1. makes the weights and the data on the card from `--seed`;
2. builds the program's model and warms up the cell's own shapes through
   the entry the window calls (set-up ends here: `setup_s` is the time
   from the process's start);
3. measures for `--seconds` with tracing off; with `--trace 1` it then
   profiles a short stretch of the same steady state and reads the cell's
   per-layer metrics from it (`perfbench/metrics/<name>.py`);
4. reads the peak device memory, frees the program's state, and holds what
   the timed path produced to the plain reference (`perfbench/reference/`)
   against the cell's limits (`perfbench/limits/<workload>.json`);
5. prints the numbers compared, each beside its limit, as the last lines
   of standard error, and one JSON line as the last line of standard
   output: `correct`, `attempted`, `failed`, `metrics` (the end-to-end
   metrics, or with `--trace 1` the per-layer ones), `device`, with
   `--trace 1` `breakdown`, and last `compared`.

It exits non-zero, with no result line, where there is no CUDA card (or
fewer than the cell asks for), and where the JAX package or JAX itself has
been imported by the time the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import torch

from perfbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "nnue_vision_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device: torch.device, log=print) -> dict:
    """One run of `cell` on `device` (see the module docstring); returns the
    result line's object. On the CPU (the tests) every kernel takes the
    program's plain version and no device number is read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = spec.kind(cell.traffic)
    cuda = device.type == "cuda"
    s = kind.build(cell, seed, device)
    kind.warm(s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age()
    w = kind.window(s, seconds)
    tr = kind.traced_window(s, w) if traced else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if s.graph:
        log(f"set-up: {setup_s:.3f} s; chunk graph of {s.graph['nodes']} nodes "
            f"for {s.graph['steps']} steps, captured in {s.graph['capture_s']:.3f} s, "
            f"instantiated in {s.graph['instantiate_s']:.3f} s")
    else:
        log(f"set-up: {setup_s:.3f} s")
    kind.release(s)
    numbers = kind.compare(s)
    compared = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    attempted = w.get("steps", w.get("calls"))

    if traced:
        ctx = {"cell": cell, "config": cell.config, "traffic": cell.traffic,
               "family": s.fam, "window": w, "trace": tr, "graph": s.graph,
               "setup": s}
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(cell.root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = kind.end_to_end(s, w, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    line = {"correct": correct, "attempted": attempted, "failed": w["failed"],
            "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = tr["breakdown"]
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed is a non-negative integer")
    cell = spec.load_cell(Path.cwd(), args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell {cell.name} needs {chips} CUDA card(s); "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {_power_limit()}")
    line = execute(cell, args.seed, args.seconds, bool(args.trace), device, log)
    bad = forbidden_modules()
    if bad:
        log(f"perfbench: the run imported {bad}: JAX and the JAX package may "
            "not run here")
        return 3
    for name, c in line["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
