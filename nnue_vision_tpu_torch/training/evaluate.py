"""Evaluation of an NNUE or an EtinyNet: the float path, bit-exact int8
and the C++ engine (port of `nnue_vision_tpu/training/evaluate.py:45-394`).

`evaluate_model` runs the float model over a loader (an EtinyNet in eval
mode, on its running statistics): mean CE loss per batch and the metrics.
`evaluate_int8_sim` quantizes the float model exactly as serialization
does and computes the C++ engine's logits for every batch, so its
accuracy/F1 equal the engine subprocess path's. For an NNUE three backends
give the same bits: `use_pallas=False` the plain torch sim, `True` the
exact conv + head kernel (`nnue_engine_forward_fused`), `"mega"` the
single kernel (`nnue_engine_forward_mega`); on a CPU device all three run
their plain versions. An EtinyNet runs the engine sim
(`etiny_engine_forward`), as in the JAX package, whatever `use_pallas`
says; its `latent_density` is 0.

`evaluate_compiled_model` quantizes the model the same way, writes its
`.nnue`/`.etiny` file with the port's `formats.py` and runs the engine's
inference tool (`engine_executable`: `training/engine_build.py`'s build
unless `NNUE_ENGINE_EXEC` / `ETINY_ENGINE_EXEC` name another) once per
batch on the normalized images; a failing run leaves the model, the
images and a repro script under `logs/compiled_eval_failures/`.

All take a loader of raw (images [0, 1], labels) numpy batches, or a
`ResidentEvalLoader`, whose split sits normalized on the device.

Under a data-parallel mesh (`mesh=`), `evaluate_model` and
`evaluate_int8_sim` split each batch over the data axis: each rank runs
its rows through the float model or the int8 backend (K1, K2 or the sim;
K6 is `ops/etiny_kernels.py`'s), and the logits and active counts are
gathered (`parallel/mesh.py` `shard_map`), so every rank computes the
metrics of the whole split, the int8 ones bit-equal to one process.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nnue_vision_tpu_torch.data.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)
from nnue_vision_tpu_torch.formats import write_etiny, write_nnue
from nnue_vision_tpu_torch.models.etinynet import EtinyNet, etinynet_quantize
from nnue_vision_tpu_torch.models.nnue import nnue_quantize
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.ops.nnue_kernels import (
    mega_head_params,
    nnue_engine_forward_fused,
    nnue_engine_forward_mega,
    pallas_head_params,
)
from nnue_vision_tpu_torch.parallel.mesh import Mesh, shard_map
from nnue_vision_tpu_torch.training.engine_build import BUILD_DIR, tool_name
from nnue_vision_tpu_torch.training.metrics import compute_metrics
from nnue_vision_tpu_torch.training.step import eval_step


class ResidentEvalLoader:
    """A normalized eval split uploaded to `device` once and sliced there
    every epoch. Yields (device images normalized, host labels)."""

    device_resident = True

    def __init__(self, loader, device, batch_size=None):
        self.dataset = loader.dataset
        self.batch_size = int(batch_size or loader.batch_size)
        self.drop_last = bool(getattr(loader, "drop_last", False))
        self._images = torch.from_numpy(
            normalize_host(loader.dataset.images)).to(device)
        self._labels = np.asarray(loader.dataset.labels)

    def __len__(self) -> int:
        n = len(self._labels)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self._labels)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            end = min(start + self.batch_size, n)
            yield self._images[start:end], self._labels[start:end]


def normalize_host(images) -> np.ndarray:
    """(images - mean) / std in numpy float32: the normalized images the
    device paths and the engine see."""
    imgs = np.asarray(images, np.float32)
    return (imgs - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
        IMAGENET_STD, np.float32)


def maybe_resident(loader, max_bytes, device, batch_size=None):
    """`loader` as a ResidentEvalLoader iff its own split fits `max_bytes`."""
    if loader.dataset.images.nbytes <= max_bytes:
        return ResidentEvalLoader(loader, device, batch_size=batch_size)
    return loader


def _batches(loader, device):
    """(normalized images on `device`, labels) of each batch."""
    resident = getattr(loader, "device_resident", False)
    for images, labels in loader:
        if not resident:
            images = normalize_images(
                torch.as_tensor(np.asarray(images, np.float32), device=device))
        yield images.contiguous(), labels


def evaluate_model(model: nn.Module, loader, *, device=None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[float, Dict[str, float]]:
    """Float-path evaluation: (mean per-sample CE loss averaged over
    batches, metrics); under a mesh, each batch split over its data axis."""
    if device is None:
        device = next(model.parameters()).device
    total_loss, n_batches = 0.0, 0
    outs, targets = [], []
    for x, labels in _batches(loader, device):
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device)
        loss, logits = eval_step(model, x, y, mesh)
        total_loss += float(loss) / len(labels)
        n_batches += 1
        outs.append(logits.cpu().numpy())
        targets.append(np.asarray(labels))
    if not outs:
        raise ValueError(
            f"evaluation loader produced 0 batches (dataset of "
            f"{len(loader.dataset.labels)} samples, batch_size "
            f"{loader.batch_size}, drop_last={loader.drop_last}) — "
            "reduce batch_size or raise max_samples/subset"
        )
    metrics = compute_metrics(np.concatenate(outs), np.concatenate(targets))
    return total_loss / max(1, n_batches), metrics


def _nnue_forward(sim_params, cfg, use_pallas):
    """(x, h, w) → (logits, density, count) on the chosen NNUE backend."""
    if use_pallas == "mega":
        heads = {}

        def fwd(x, h, w):
            if (h, w) not in heads:
                heads[(h, w)] = mega_head_params(sim_params, cfg, h, w)
            return nnue_engine_forward_mega(
                heads[(h, w)], x.reshape(x.shape[0], -1), cfg=cfg, image_h=h,
                image_w=w,
            )
    elif use_pallas:
        head = pallas_head_params(sim_params)

        def fwd(x, h, w):
            return nnue_engine_forward_fused(
                sim_params, head, x, cfg=cfg, image_h=h, image_w=w
            )
    else:
        def fwd(x, h, w):
            return nnue_engine_forward(
                sim_params, x, cfg=cfg, image_h=h, image_w=w
            )
    return fwd


def evaluate_int8_sim(
    model: nn.Module, loader: Iterable[Tuple[np.ndarray, np.ndarray]], *,
    use_pallas=False, device=None, mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Metrics of the deployed int8 model over `loader`.

    `loader` yields (images (B, H, W, 3) float in [0, 1], labels (B,)),
    normalized here on `device` (default: the model's), or is a
    `ResidentEvalLoader`. Under a mesh each batch is split over its data
    axis and the outputs gathered.
    Returns acc/f1/precision/recall, `ms_per_sample` (host clock over the
    whole loop, which ends in a device-to-host copy of each batch's logits)
    and `latent_density`.
    """
    if use_pallas not in (False, True, "mega"):
        raise ValueError(f"use_pallas must be False, True or 'mega': {use_pallas!r}")
    if device is None:
        device = next(model.parameters()).device
    if isinstance(model, EtinyNet):
        sim_params, cfg = etiny_sim_params(etinynet_quantize(model),
                                           device=device)

        def fwd(x, h, w):
            return etiny_engine_forward(sim_params, x, cfg=cfg, image_h=h,
                                        image_w=w), None, None
    else:
        q = nnue_quantize(model)
        sim_params, cfg = nnue_sim_params(q, device=device)
        fwd = _nnue_forward(sim_params, cfg, use_pallas)
    if mesh is not None:
        whole = fwd

        def fwd(x, h, w):
            return shard_map(lambda rows: whole(rows, h, w), mesh)(x)

    outs, targets, densities = [], [], []
    n = 0
    t0 = time.perf_counter()
    for x, labels in _batches(loader, device):
        logits, _, count = fwd(x, x.shape[1], x.shape[2])
        outs.append(logits.cpu().numpy())
        targets.append(np.asarray(labels))
        if count is not None:
            densities.append(count.cpu().numpy().astype(np.float32)
                             / np.float32(q.num_features))
        n += len(labels)
    elapsed = time.perf_counter() - t0
    if not outs:
        raise ValueError("evaluation loader produced 0 batches")

    metrics = compute_metrics(np.concatenate(outs), np.concatenate(targets))
    metrics["ms_per_sample"] = (elapsed / max(1, n)) * 1000.0
    metrics["latent_density"] = (float(np.concatenate(densities).mean())
                                 if densities else 0.0)
    return metrics


def engine_executable(model_type: str) -> Path:
    """The engine's inference tool for `model_type`: `NNUE_ENGINE_EXEC` /
    `ETINY_ENGINE_EXEC` when set, else the port's build of it."""
    tool = tool_name(model_type)
    override = os.environ.get(
        "NNUE_ENGINE_EXEC" if model_type == "nnue" else "ETINY_ENGINE_EXEC")
    return Path(override) if override else BUILD_DIR / tool


def _persist_failure(model_path: Path, image_path: Path, cmd) -> Path:
    """Copy the model and the images of a failed engine run, with a repro
    script, under logs/compiled_eval_failures/<time>/; returns the folder."""
    root = Path("logs/compiled_eval_failures") / datetime.now().strftime(
        "%Y%m%d_%H%M%S_%f")
    root.mkdir(parents=True, exist_ok=True)
    saved_model = root / Path(model_path).name
    saved_image = root / Path(image_path).name
    saved_model.write_bytes(Path(model_path).read_bytes())
    saved_image.write_bytes(Path(image_path).read_bytes())
    repro = root / "repro.sh"
    repro.write_text(
        "#!/usr/bin/env bash\nset -euo pipefail\n"
        + " ".join(str(c) for c in cmd).replace(str(model_path), str(saved_model))
        .replace(str(image_path), str(saved_image)) + "\n")
    os.chmod(repro, 0o755)
    return root


def as_engine_prints(logits: np.ndarray) -> np.ndarray:
    """float32 `logits` as the engine's tools print them (`%.10f`) and
    `engine_logits` parses them back: equal to the value except where
    |logit| < 2^-10, whose float32 spacing is finer than the ten decimals
    (a logit of 1/4096 comes back 1 ulp off)."""
    x = np.asarray(logits, np.float32)
    return np.array([float(f"{v:.10f}") for v in x.ravel().tolist()],
                    np.float32).reshape(x.shape)


def _parse_engine(stdout: str, is_nnue: bool):
    """([logits per image], [density per image]) of one engine run: NNUE
    prints `logit,...,logit,density` per image; EtinyNet one
    `RESULT_<c>: <logit>` line per class, images separated by `IMAGE` lines."""
    outs, densities = [], []
    if is_nnue:
        for line in stdout.strip().splitlines():
            parts = line.split(",")
            outs.append([float(v) for v in parts[:-1]])
            densities.append(float(parts[-1]))
        return outs, densities
    current: list = []
    for line in stdout.splitlines():
        if line.startswith("IMAGE") and current:
            outs.append(current)
            current = []
        elif line.startswith("RESULT_"):
            current.append(float(line.split(":", 1)[1]))
    if current:
        outs.append(current)
    return outs, densities


def engine_logits(model: nn.Module, loader):
    """(logits (N, classes) float32, labels (N,), densities, engine seconds)
    of the C++ engine over `loader`: the model quantized as serialization
    does and written to a `.nnue`/`.etiny` file, one engine run per batch."""
    is_nnue = not isinstance(model, EtinyNet)
    model_type = "nnue" if is_nnue else "etinynet"
    exe = engine_executable(model_type)
    if not exe.exists():
        raise RuntimeError(
            f"C++ engine not found: {exe}. Build it with "
            "nnue_vision_tpu_torch.training.engine_build.compile_cpp_engine.")
    outs, targets, densities = [], [], []
    seconds = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        model_path = Path(tmp) / ("model.nnue" if is_nnue else "model.etiny")
        if is_nnue:
            write_nnue(nnue_quantize(model), model_path)
        else:
            write_etiny(etinynet_quantize(model), model_path)
        image_path = Path(tmp) / "images.bin"
        for images, labels in loader:
            x = normalize_host(images)
            n, h, w = x.shape[:3]
            x.tofile(image_path)
            cmd = [str(exe), str(model_path), str(image_path), str(h), str(w),
                   str(n)]
            t0 = time.perf_counter()
            result = subprocess.run(cmd, capture_output=True, text=True,
                                    timeout=600)
            seconds += time.perf_counter() - t0
            if result.returncode != 0:
                where = _persist_failure(model_path, image_path, cmd)
                raise RuntimeError(
                    f"engine failed (rc={result.returncode}): {result.stderr}\n"
                    f"repro persisted to {where}")
            got, dens = _parse_engine(result.stdout, is_nnue)
            if len(got) != n:
                raise RuntimeError(
                    f"engine printed {len(got)} results for {n} images")
            outs.extend(got)
            densities.extend(dens)
            targets.append(np.asarray(labels))
    if not outs:
        raise RuntimeError("no engine outputs produced")
    return (np.asarray(outs, np.float32), np.concatenate(targets), densities,
            seconds)


def evaluate_compiled_model(model: nn.Module, loader) -> Dict[str, float]:
    """Metrics of the deployed model as the C++ engine computes them:
    acc/f1/precision/recall, `ms_per_sample` (the engine runs' wall clock
    per image) and `latent_density` (the mean of the NNUE engine's printed
    densities; 0 for an EtinyNet)."""
    logits, labels, densities, seconds = engine_logits(model, loader)
    metrics = compute_metrics(logits, labels)
    metrics["ms_per_sample"] = seconds / len(labels) * 1000.0
    metrics["latent_density"] = float(np.mean(densities)) if densities else 0.0
    return metrics


def evaluate_model_comprehensive(model: nn.Module, loader) -> Dict[str, dict]:
    """{"float": {"loss", "metrics"}, "compiled": {"metrics"}}: the float
    evaluation and the engine's."""
    loss, metrics = evaluate_model(model, loader)
    return {"float": {"loss": loss, "metrics": metrics},
            "compiled": {"metrics": evaluate_compiled_model(model, loader)}}
