"""Cross-framework accuracy anchor: the UNMODIFIED upstream trainer on the
exact synthetic-hard dataset the port trains on (the port's counterpart of
`scripts/reference_anchor.py`).

    python -m nnue_vision_tpu_torch.reference_anchor \\
        [--workdir logs/ref_anchor] [--epochs 60] [--test-size 2500] \\
        [--model nnue|etinynet] [--optimizer sgd|adam] [--prepare-only]

Runs the upstream `train.py` `train_model` on the port's
`_synthetic_hard_dataset` (`data/datasets.py`: class seed 5678, variant
A, draw seed 42), exported in the CIFAR-10 python-pickle batch layout the
upstream loader reads through `torchvision.datasets.CIFAR10`, at the
60-epoch / 20k-sample / batch-512 budget of the PARITY.md numbers. The
images are quantized to uint8 (1/255, against the task's σ=0.28 pixel
noise); the test batch is the first `--test-size` images of the 5000-image
seed-10042 test draw, so both frameworks score the same images. The port
builds its datasets with the JAX package's draws, so the exported bytes
are those of the JAX tool.

The reference checkout is the upstream one that `NV_REFERENCE_DIR` names
(there is no default: without it the tool exits 2); a scratch copy is staged under
`--workdir`, with stand-ins for the dependencies the trainer imports but
the host may lack (`wandb`, recording every log call to
`anchor_metrics.jsonl`; the `albumentations` transforms of the light tier
and the eval path; `torchvision.datasets.CIFAR10` over the pickle batches;
`nnue_runpod_service.stop_runpod`), and for the EtinyNet cell the one
upstream evaluation bug patched (see `patch_etiny_eval_bug`). The staging,
the stand-ins and the patch are framework-free and copied from the JAX
tool. Hyperparameters: the reference's production NNUE config values (SGD
lr 0.01, momentum 0.9, weight decay 2e-4, grad clip 1.0, batch 512, light
augmentation) with `max_epochs` at the anchor budget; its cosine flag is
inert upstream, so it trains at a constant lr, as it ships.

Outputs under --workdir: anchor.log (the trainer's stdout and stderr),
anchor_metrics.jsonl (every wandb.log payload), anchor_summary.json (final
and best float + compiled metrics).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent.parent
# the upstream checkout, where NV_REFERENCE_DIR names one; no default
REFERENCE = Path(os.environ["NV_REFERENCE_DIR"]) if os.environ.get(
    "NV_REFERENCE_DIR") else None


# --------------------------------------------------------------------- #
# 1. dataset export
# --------------------------------------------------------------------- #

def export_fake_cifar(data_root: Path, train_n: int, test_size: int,
                      seed: int) -> None:
    from nnue_vision_tpu_torch.data.datasets import _synthetic_hard_dataset

    out = data_root / "cifar-10-batches-py"
    out.mkdir(parents=True, exist_ok=True)

    def to_cifar_rows(images):
        # float32 NHWC [0,1] -> uint8 rows of 3072 in CIFAR's RRR..GGG..BBB
        u8 = (images * 255.0).round().clip(0, 255).astype("uint8")
        return u8.transpose(0, 3, 1, 2).reshape(len(u8), -1)

    tr_images, tr_labels = _synthetic_hard_dataset(10, (32, 32), train_n,
                                                   seed=seed)
    rows = to_cifar_rows(tr_images)
    per = (train_n + 4) // 5
    for b in range(5):
        sl = slice(b * per, min((b + 1) * per, train_n))
        with open(out / f"data_batch_{b + 1}", "wb") as f:
            pickle.dump({b"data": rows[sl],
                         b"labels": [int(x) for x in tr_labels[sl]]}, f)

    # our loaders draw the test split with seed+10_000 and n = train_n//4
    # (datasets.py:418-427); take the first test_size of that exact draw
    te_images, te_labels = _synthetic_hard_dataset(
        10, (32, 32), max(64, train_n // 4), seed=seed + 10_000)
    te_images, te_labels = te_images[:test_size], te_labels[:test_size]
    with open(out / "test_batch", "wb") as f:
        pickle.dump({b"data": to_cifar_rows(te_images),
                     b"labels": [int(x) for x in te_labels]}, f)
    with open(out / "batches.meta", "wb") as f:
        pickle.dump({b"label_names": [f"class_{i}".encode()
                                      for i in range(10)]}, f)
    print(f"exported fake CIFAR-10: train {train_n}, test {test_size} "
          f"-> {out}")


# --------------------------------------------------------------------- #
# 2. stage the reference tree
# --------------------------------------------------------------------- #

EXCLUDE = {".git", "lib", "logs", "wandb", "__pycache__",
           "build", "build_san"}


def stage_reference(workdir: Path) -> None:
    if workdir.exists():
        shutil.rmtree(workdir)

    def ignore(d, names):
        # `data/` is the reference's python package (datasets.py etc.);
        # only its `raw/` dataset cache is skippable.
        skip = set(EXCLUDE)
        if Path(d).name == "data":
            skip.add("raw")
        return [n for n in names
                if n in skip or n.endswith(".egg-info")]

    shutil.copytree(REFERENCE, workdir, ignore=ignore)
    print(f"staged reference -> {workdir}")


# The reference's EtinyNet compiled-eval path is broken AS SHIPPED: the
# target-collection loop in evaluate.py's etinynet branch is nested
# inside the per-image loop (reference evaluate.py:328-333), so a batch
# of N images appends N×N targets against N outputs and
# sklearn raises "inconsistent numbers of samples" — train.py's
# unconditional engine precompile probe (train.py:216-219, batch 2 ×
# 4 samples → 8 targets / 4 outputs) therefore crashes EVERY etinynet
# training run before the first step. (The NNUE branch had the same bug
# and was fixed upstream — evaluate.py:337-339's comment documents it —
# but the etinynet branch kept the nested copy.) The anchor dedents that
# one block by four spaces so the loop runs once per batch, exactly the
# NNUE branch's fixed semantics; everything else runs verbatim.
_ETINY_EVAL_BUG = """\
                    # Add targets for the samples we processed
                    for i in range(processed_samples):
                        target = labels[i]
                        if target.dim() == 0:
                            target = target.unsqueeze(0)
                        all_targets.append(target)
"""


def patch_etiny_eval_bug(workdir: Path) -> None:
    path = workdir / "evaluate.py"
    src = path.read_text()
    if _ETINY_EVAL_BUG not in src:
        raise RuntimeError(
            "upstream etinynet duplicate-target block not found — "
            "reference layout changed; re-derive the patch")
    fixed = "\n".join(
        line[4:] if line.strip() else line
        for line in _ETINY_EVAL_BUG.split("\n"))
    path.write_text(src.replace(_ETINY_EVAL_BUG, fixed))
    print("patched staged evaluate.py: dedented the etinynet "
          "duplicate-target block (upstream bug — see PARITY.md)")


# --------------------------------------------------------------------- #
# 3. dependency stand-ins
# --------------------------------------------------------------------- #

WANDB_STUB = '''\
"""wandb stand-in: records every log() to anchor_metrics.jsonl."""
import json, os

class _Run:
    url = "local://anchor"
    name = "reference-anchor"
    id = "reference-anchor"

run = None
_metrics_path = os.path.join(os.path.dirname(__file__),
                             "anchor_metrics.jsonl")

def init(**kwargs):
    global run
    run = _Run()
    return run

def log(data, step=None, **kwargs):
    rec = {"step": step}
    rec.update({k: (float(v) if isinstance(v, (int, float)) else v)
                for k, v in data.items()})
    with open(_metrics_path, "a") as f:
        f.write(json.dumps(rec) + "\\n")

def save(path, **kwargs):
    pass

def finish(**kwargs):
    pass
'''

# Faithful stand-ins for exactly the transforms the reference constructs
# on the light-augmentation and eval paths (data/datasets.py:181-197,
# 357-374). Semantics follow the albumentations 1.4 definitions:
#   Normalize:  (img - mean*255) / (std*255)
#   RandomBrightnessContrast(brightness_by_max=True):
#       img*(1+U(-c,c)) + U(-b,b)*255
#   CoarseDropout: fractional hole sizes are fractions of H/W, fill 0
ALBUMENTATIONS_STUB = '''\
"""albumentations stand-in for the reference's light tier + eval path."""
import numpy as np


class _T:
    def __init__(self, p=1.0):
        self.p = p

    def _fire(self):
        return np.random.random() < self.p


class HorizontalFlip(_T):
    def __init__(self, p=0.5):
        super().__init__(p)

    def __call__(self, img):
        return np.ascontiguousarray(img[:, ::-1]) if self._fire() else img


class RandomBrightnessContrast(_T):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5,
                 brightness_by_max=True):
        super().__init__(p)
        self.b, self.c = brightness_limit, contrast_limit

    def __call__(self, img):
        if not self._fire():
            return img
        alpha = 1.0 + np.random.uniform(-self.c, self.c)
        beta = np.random.uniform(-self.b, self.b)
        out = img.astype(np.float32) * alpha + beta * 255.0
        return np.clip(out, 0, 255).astype(img.dtype)


class CoarseDropout(_T):
    def __init__(self, num_holes_range=(1, 1), hole_height_range=(8, 8),
                 hole_width_range=(8, 8), p=0.5, fill_value=0):
        super().__init__(p)
        self.n_range = num_holes_range
        self.h_range = hole_height_range
        self.w_range = hole_width_range
        self.fill = fill_value

    @staticmethod
    def _px(rng, dim):
        lo, hi = rng
        if isinstance(lo, float) and lo <= 1.0:
            lo, hi = int(lo * dim), int(hi * dim)
        return int(np.random.randint(lo, hi + 1)) if hi >= lo else int(lo)

    def __call__(self, img):
        if not self._fire():
            return img
        img = img.copy()
        h, w = img.shape[:2]
        n = int(np.random.randint(self.n_range[0], self.n_range[1] + 1))
        for _ in range(n):
            hh = max(1, self._px(self.h_range, h))
            ww = max(1, self._px(self.w_range, w))
            y = np.random.randint(0, max(1, h - hh + 1))
            x = np.random.randint(0, max(1, w - ww + 1))
            img[y:y + hh, x:x + ww] = self.fill
        return img


class Resize(_T):
    def __init__(self, height, width, p=1.0):
        super().__init__(p)
        self.hw = (height, width)

    def __call__(self, img):
        if img.shape[:2] == self.hw:
            return img
        # bilinear resize (identity at the reference's 32x32 CIFAR path;
        # general case kept correct for safety)
        h, w = img.shape[:2]
        th, tw = self.hw
        ys = (np.arange(th) + 0.5) * h / th - 0.5
        xs = (np.arange(tw) + 0.5) * w / tw - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
        out = top * (1 - wy) + bot * wy
        return out.astype(img.dtype)


class Normalize(_T):
    def __init__(self, mean, std, max_pixel_value=255.0, p=1.0):
        super().__init__(p)
        self.mean = np.asarray(mean, np.float32) * max_pixel_value
        self.std = np.asarray(std, np.float32) * max_pixel_value

    def __call__(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class Compose:
    def __init__(self, transforms, **kwargs):
        self.transforms = transforms

    def __call__(self, image=None, **kwargs):
        for t in self.transforms:
            image = t(image)
        return {"image": image}
'''

ALBUMENTATIONS_PYTORCH_STUB = '''\
import numpy as np
import torch


class ToTensorV2:
    def __init__(self, p=1.0):
        pass

    def __call__(self, img):
        if img.ndim == 3:
            img = img.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(img))
'''

TORCHVISION_INIT_STUB = '''\
"""torchvision stand-in (this host has no torchvision wheel)."""
from . import datasets  # noqa: F401
'''

TORCHVISION_DATASETS_STUB = '''\
"""torchvision.datasets stand-in: CIFAR reader over pickle batches.

Faithful to the real torchvision for the reference's consumption:
the reference only touches __len__/__getitem__ and converts PIL ->
np.array immediately (reference data/datasets.py:410-411,445-447),
so yielding the ndarray directly is byte-identical.
"""
import os
import pickle

import numpy as np


class CIFAR10:
    base_folder = "cifar-10-batches-py"
    train_files = [f"data_batch_{i}" for i in range(1, 6)]
    test_files = ["test_batch"]

    def __init__(self, root, train=True, download=False, transform=None):
        folder = os.path.join(str(root), self.base_folder)
        files = self.train_files if train else self.test_files
        data, targets = [], []
        for fn in files:
            with open(os.path.join(folder, fn), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data.append(np.asarray(batch[b"data"], dtype=np.uint8))
            targets.extend(batch.get(b"labels") or batch[b"fine_labels"])
        self.data = (np.concatenate(data)
                     .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self.targets = [int(t) for t in targets]
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, target = self.data[idx], self.targets[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class CIFAR100(CIFAR10):
    def __init__(self, *a, **k):
        raise NotImplementedError("anchor exports CIFAR-10 batches only")


class ImageNet:
    def __init__(self, *a, **k):
        raise NotImplementedError("anchor exports CIFAR-10 batches only")
'''

RUNPOD_STUB = '''\
"""RunPod stand-in: no cloud here; train.py imports stop_runpod."""

def stop_runpod(*args, **kwargs):
    print("anchor: stop_runpod no-op")


def start_cloud_training(*args, **kwargs):
    raise RuntimeError("anchor runs locally")
'''

RUNNER = '''\
#!/usr/bin/env python3
"""Anchor runner: launches the unmodified reference train_model."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.chdir(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("WANDB_API_KEY", "anchor-local")

import torch

torch.manual_seed({seed})

from config import load_config
import train as ref_train

cfg = load_config("config/train_anchor.py")
rc = ref_train.train_model(cfg, "{model}")
print(f"anchor train_model rc={{rc}}")

# summarize: best/final epochs from the metrics stream
best = {{"val/f1": -1.0}}
final = None
with open("anchor_metrics.jsonl") as f:
    for line in f:
        rec = json.loads(line)
        if "val/f1" in rec:
            final = rec
            if rec["val/f1"] > best["val/f1"]:
                best = rec
with open("anchor_summary.json", "w") as f:
    json.dump({{"final": final, "best": best}}, f, indent=2)
print("ANCHOR_FINAL:", json.dumps(final))
print("ANCHOR_BEST:", json.dumps(best))
sys.exit(rc)
'''

ANCHOR_CONFIG = '''\
"""Anchor config: reference production NNUE values
(config/train_nnue.py:16-49 upstream) at the 60-epoch variant-A budget.
Dataset is the exported synthetic-hard-as-CIFAR batches."""

name = "nnue_anchor"

dataset_name = "cifar10"  # the exported synthetic-hard batches
batch_size = 512
num_workers = 0
num_classes = 10
subset = 1.0

l1_size = 1024
l2_size = 128
l3_size = 32
input_size = 32
grid_size = 10
num_features_per_square = 8

learning_rate = {lr}
weight_decay = 2e-4
momentum = 0.9
optimizer_type = "{optimizer}"
max_epochs = {epochs}
max_grad_norm = 1.0
use_cosine_scheduler = True  # inert upstream (get_lr never called)

decay_lr = True
use_cyclical_lr = False
cyclical_lr_period = 1000
cyclical_lr_amplitude = 0.1

use_augmentation = True
augmentation_strength = "light"

deterministic = False
seed = {seed}
keep_alive = True
log_dir = "logs"
project_name = "nnue_anchor"
'''


ETINY_ANCHOR_CONFIG = '''\
"""Anchor config: the reference's own EtinyNet at small scale (VERDICT r4
item 2 — a cell where the reference demonstrably learns, validating the
albumentations/torchvision stand-ins in the succeeding direction).
Model/optimizer values from upstream config/train_etinynet.py with the
batch size and lr scaled to the anchor budget; light augmentation because
that is the tier the stand-ins implement (and both frameworks use it)."""

name = "etinynet_anchor"

dataset_name = "cifar10"  # the exported synthetic-hard batches
batch_size = {batch}
num_workers = 0
num_classes = 10
subset = 1.0

etinynet_variant = "{variant}"
use_asq = False
asq_bits = 4
input_size = 32

learning_rate = {lr}
weight_decay = 2e-4
momentum = 0.9
optimizer_type = "{optimizer}"
max_epochs = {epochs}
max_grad_norm = 1.0
use_cosine_scheduler = True  # inert upstream (get_lr never called)

decay_lr = True
use_cyclical_lr = False
cyclical_lr_period = 1000
cyclical_lr_amplitude = 0.1

use_augmentation = True
augmentation_strength = "light"

deterministic = False
seed = {seed}
keep_alive = True
log_dir = "logs"
project_name = "etinynet_anchor"
'''


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=str(REPO / "logs" / "ref_anchor"))
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--train-size", type=int, default=20000)
    ap.add_argument("--test-size", type=int, default=2500,
                    help="val==test split size; per-epoch compiled eval "
                         "spawns one engine subprocess per sample, so "
                         "this bounds anchor wall-clock")
    ap.add_argument("--seed", type=int, default=42)
    # VERDICT r4 item 2: a cell where the reference demonstrably LEARNS.
    # Its production SGD lr 0.01 flatlines at chance on this task; the
    # trainer's own Adam path (reference train.py:457-471 create_optimizer,
    # anything != "sgd" -> torch.optim.Adam) is the suggested regime.
    ap.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: 0.01 for sgd — the "
                         "reference production value — 1e-3 for adam; "
                         "0.1 for the etinynet cell)")
    # The third suggested learning regime: the reference's own EtinyNet
    # (a standard BN convnet, far more trainable than the STE-quantized
    # NNUE) at small scale. Model values from upstream
    # config/train_etinynet.py; runs train_model(cfg, "etinynet")
    # verbatim, including its per-epoch compiled .etiny engine eval.
    ap.add_argument("--model", choices=["nnue", "etinynet"], default="nnue")
    ap.add_argument("--variant", default="0.75",
                    help="etinynet variant for --model etinynet")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default: 512 (nnue production) / 256 (etinynet "
                         "anchor scale)")
    ap.add_argument("--prepare-only", action="store_true")
    args = ap.parse_args(argv)

    if REFERENCE is None or not REFERENCE.is_dir():
        print(f"no upstream checkout at {REFERENCE}: set NV_REFERENCE_DIR to "
              "the reference checkout", file=sys.stderr)
        return 2
    workdir = Path(args.workdir)
    stage_reference(workdir)
    if args.model == "etinynet":
        patch_etiny_eval_bug(workdir)
    export_fake_cifar(workdir / "data" / "raw", args.train_size,
                      args.test_size, args.seed)

    (workdir / "wandb.py").write_text(WANDB_STUB)
    alb = workdir / "albumentations"
    alb.mkdir()
    (alb / "__init__.py").write_text(ALBUMENTATIONS_STUB)
    (alb / "pytorch.py").write_text(ALBUMENTATIONS_PYTORCH_STUB)
    tv = workdir / "torchvision"
    tv.mkdir()
    (tv / "__init__.py").write_text(TORCHVISION_INIT_STUB)
    (tv / "datasets.py").write_text(TORCHVISION_DATASETS_STUB)
    (workdir / "nnue_runpod_service.py").write_text(RUNPOD_STUB)
    if args.model == "etinynet":
        lr = args.lr if args.lr is not None else 0.1
        batch = args.batch_size or 256
        cfg_text = ETINY_ANCHOR_CONFIG.format(
            epochs=args.epochs, seed=args.seed, lr=lr,
            optimizer=args.optimizer, variant=args.variant, batch=batch)
    else:
        lr = args.lr if args.lr is not None else (
            0.01 if args.optimizer == "sgd" else 1e-3)
        batch = args.batch_size or 512
        cfg_text = ANCHOR_CONFIG.format(
            epochs=args.epochs, seed=args.seed, lr=lr,
            optimizer=args.optimizer).replace(
                "batch_size = 512", f"batch_size = {batch}")
    (workdir / "config" / "train_anchor.py").write_text(cfg_text)
    (workdir / "run_anchor_train.py").write_text(
        RUNNER.format(seed=args.seed, model=args.model))
    print("staged stubs + config + runner")

    if args.prepare_only:
        print(f"prepared; run:  cd {workdir} && python run_anchor_train.py")
        return 0

    log = open(workdir / "anchor.log", "w")
    print(f"launching anchor training (log: {workdir}/anchor.log) ...")
    rc = subprocess.run(
        [sys.executable, str(workdir / "run_anchor_train.py")],
        cwd=workdir, stdout=log, stderr=subprocess.STDOUT,
    ).returncode
    log.close()
    print(f"anchor run rc={rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
