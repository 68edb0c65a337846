"""A checkout root holding the benchmark's files with every cell cut to a
size the CPU runs in seconds: the same keys and the same code paths, the
widths and counts small. For the tests only. A configuration is cut by
its family's widths (`NNUE`, or `ETINY` for the EtinyNet families) and by
its recipe's line in `RECIPE`, or `DEFAULT_RECIPE` where that has none: a
new configuration needs no line here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

NNUE = {"l1_size": 64, "l2_size": 16, "l3_size": 8}
ETINY = {"variant": "micro", "calibration_images": 32}
RECIPE = {"nnue_hard": {"batch_size": 16, "steps_per_dispatch": 3},
          "etinynet_cifar10": {"batch_size": 16, "steps_per_dispatch": 2}}
DEFAULT_RECIPE = {"batch_size": 8, "steps_per_dispatch": 2}
TRAIN_IMAGES = 96
SERVE = {"batch": 32, "buffers": 2}


def make_root(tmp: Path, repo: Path = REPO) -> Path:
    """`tmp` as a checkout root: `repo`'s BENCHMARK.json, readers, mixes
    and limits as they are, its configurations cut to tiny sizes."""
    shutil.copy(repo / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("metrics", "limits", "traffic", "configs"):
        shutil.copytree(repo / "perfbench" / sub, tmp / "perfbench" / sub)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(NNUE if cfg["family"] == "nnue" else ETINY)
        cfg["recipe"].update(RECIPE.get(c["name"], DEFAULT_RECIPE))
        cfg["train_images"] = TRAIN_IMAGES
        path.write_text(json.dumps(cfg))
    for path in (tmp / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["kind"] == "serve":
            mix.update(SERVE)
            path.write_text(json.dumps(mix))
    return tmp
