"""One-command real-data accuracy evaluation (the port's counterpart of
`scripts/real_data_eval.py`).

    python -m nnue_vision_tpu_torch.real_data_eval [--device cuda] \\
        [--log_dir logs/real_data]

When real CIFAR-10 is on disk (the standard pickle tarball under
NV_DATA_DIR or ./data/raw; the port never downloads), trains BOTH
flagship configs (config/train_nnue.py, config/train_etinynet.py) with
`python -m nnue_vision_tpu_torch.train ... --device DEVICE --log_dir
LOG_DIR` (the card unless the caller names another), harvests each run's
best float and compiled (int8 engine arithmetic) accuracies from
`LOG_DIR/runs/<run>/metrics.jsonl`, and writes
docs/REAL_DATA_RESULTS_TORCH.md comparing them against the reference
README's claims (NNUE 85-90%, EtinyNet 90-95% on CIFAR-10).
NV_EVAL_EPOCHS=N shortens both schedules.

It refuses to run on the synthetic fallback, and exits 2 as the JAX tool
does: publishing synthetic numbers as real-data evidence is exactly the
failure mode this guard exists to prevent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent.parent

CONFIGS = [
    ("nnue", "config/train_nnue.py", "85-90% (README.md:109)"),
    ("etinynet", "config/train_etinynet.py", "90-95% (README.md:115)"),
]


def real_data_available() -> bool:
    from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset

    ds = GenericVisionDataset(
        dataset_name="cifar10", split="test", synthetic_fallback=True,
        max_samples=8,
    )
    return not ds.is_synthetic


def run_one(model_type: str, config: str, epochs_override: Optional[str],
            device: str, log_dir: Path):
    runs_dir = log_dir / "runs"
    before = set(p.name for p in runs_dir.glob("run_*")) if runs_dir.exists() else set()
    cmd = [sys.executable, "-m", "nnue_vision_tpu_torch.train", model_type,
           "--config", config, "--device", device, "--log_dir", str(log_dir)]
    if epochs_override:
        cmd += ["--max_epochs", epochs_override]
    print(f"=== {' '.join(cmd)}", flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit(f"training failed for {config} (rc={r.returncode})")
    new = [
        p for p in runs_dir.glob("run_*") if p.name not in before
    ]
    new.sort(key=lambda p: p.name)
    if not new:
        raise SystemExit(f"no run directory produced by {config}")
    run = new[-1]
    rows = [
        json.loads(line) for line in (run / "metrics.jsonl").open()
    ]
    epochs = [row for row in rows if "val/accuracy" in row]
    best_val = max((row["val/accuracy"] for row in epochs), default=float("nan"))
    best_compiled = max(
        (row["compiled/accuracy"] for row in epochs if "compiled/accuracy" in row),
        default=float("nan"),
    )
    return {
        "run": run.name,
        "config": config,
        "epochs": len(epochs),
        "best_val_accuracy": best_val,
        "best_compiled_accuracy": best_compiled,
        "wall_minutes": (time.time() - t0) / 60.0,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runs train (default: the card)")
    ap.add_argument("--log_dir", type=Path, default=REPO / "logs" / "real_data",
                    help="the runs' log directory (runs under LOG_DIR/runs/)")
    args = ap.parse_args(argv)
    from nnue_vision_tpu_torch.ops.engine_sim import resolve_device

    resolve_device(args.device)  # a run asked of a missing card raises first
    if not real_data_available():
        print(
            "real CIFAR-10 is NOT available: no tarball at NV_DATA_DIR/"
            "./data/raw (the port never downloads).\n"
            "Mount the standard cifar-10-python.tar.gz anywhere and set "
            "NV_DATA_DIR=<that directory>, then re-run.",
            file=sys.stderr,
        )
        return 2

    epochs_override = os.environ.get("NV_EVAL_EPOCHS")
    results = [
        (model, claim, run_one(model, config, epochs_override, args.device,
                               args.log_dir))
        for model, config, claim in CONFIGS
    ]

    out = REPO / "docs" / "REAL_DATA_RESULTS_TORCH.md"
    lines = [
        "# Real-data (CIFAR-10) accuracy vs reference claims",
        "",
        "Generated by `python -m nnue_vision_tpu_torch.real_data_eval` on "
        f"{time.strftime('%Y-%m-%d %H:%M')} "
        + (f"(NV_EVAL_EPOCHS={epochs_override})" if epochs_override
           else "(full production schedules)"),
        "",
        "| Model | Reference claim | Best float val acc | Best compiled "
        "(int8 engine) acc | Epochs | Run |",
        "|---|---|---|---|---|---|",
    ]
    for model, claim, r in results:
        lines.append(
            f"| {model} | {claim} | {r['best_val_accuracy']:.4f} | "
            f"{r['best_compiled_accuracy']:.4f} | {r['epochs']} | "
            f"`{args.log_dir / 'runs' / r['run']}` |"
        )
    lines += [
        "",
        "Compiled accuracy is measured in the bit-exact int8 engine "
        "arithmetic (the port's ops/engine_sim.py and its kernels), the "
        "same numbers the C++ engine CLIs produce from the serialized "
        "`.nnue`/`.etiny` files.",
    ]
    out.write_text("\n".join(lines) + "\n")
    print(f"\nwrote {out}")
    for model, claim, r in results:
        print(
            f"{model}: float {r['best_val_accuracy']:.4f} / compiled "
            f"{r['best_compiled_accuracy']:.4f} (claim {claim})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
