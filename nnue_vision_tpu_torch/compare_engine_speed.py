"""Compare NNUE vs EtinyNet C++ engine speed, and the int8 serving path on
the card (the port's counterpart of `scripts/compare_engine_speed.py`).

    python -m nnue_vision_tpu_torch.compare_engine_speed [--samples 64] \\
        [--iters 200] [--skip-gpu] [--device cuda]

Builds the engine with `training/engine_build.py` (`nnue_inference`,
`etinynet_inference` and `benchmark_engine` into `build/torch_engine/`),
writes an untrained ~1M-parameter NNUE (the production shape: 10×10×8
grid, L1 1024, L2 128, L3 32, 10 classes) and an EtinyNet-micro as
`.nnue` / `.etiny` files, and times per-image inference of `--samples`
random 32×32 images through each engine tool (one process, wall clock),
then prints the `DENSITY_RESULT`, `RESULT_AVG_MS` and `INCREMENTAL_SPEEDUP`
lines of `benchmark_engine` at `--iters`.

Then, unless `--skip-gpu`, it times the int8 serving path on `--device`
(the card unless the caller names another; without CUDA that raises) on
the same images: the NNUE through K1 (`ops/nnue_kernels.py`
`nnue_engine_forward_mega`) and the EtinyNet through K6
(`ops/etiny_kernels.py` `etiny_forward_kernel`), each beside its plain
sim (`ops/engine_sim.py`), as the JAX tool timed its XLA sim. On the card
`ops/timing.chained_best_ms` captures `REPS` calls in one CUDA graph and
times its replay between CUDA events (best of 3), so launch cost is not in
the time; the batch (786 KB) stays in L2 between calls, as the engine's
images stay in its cache. Each line gives ms per image, the ratio to the
C++ engine and the card's name and power limit. On the CPU the same lines
come from the host clock and say so: the plain versions, never a device
time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nnue_vision_tpu_torch.formats import write_etiny, write_nnue
from nnue_vision_tpu_torch.models.api import NNUE, EtinyNet
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    nnue_engine_forward,
    nnue_sim_params,
    resolve_device,
)
from nnue_vision_tpu_torch.ops.timing import card, chained_best_ms
from nnue_vision_tpu_torch.training.engine_build import (
    BENCHMARK_TOOL,
    TOOLS,
    compile_benchmark_engine,
)

H = W = 32
REPS = 50  # calls per CUDA graph in the device timing
ENGINE_LINES = ("DENSITY_RESULT:", "RESULT_AVG_MS:", "INCREMENTAL_SPEEDUP:")


def make_models(device="cuda") -> Tuple[NNUE, EtinyNet]:
    """The untrained production-shape NNUE and EtinyNet-micro on `device`."""
    nnue = NNUE(feature_set=GridFeatureSet(10, 8), l1_size=1024, l2_size=128,
                l3_size=32, num_classes=10, input_size=H, device=device)
    etiny = EtinyNet(variant="micro", num_classes=10, input_size=H,
                     device=device)
    return nnue, etiny


def write_models(nnue: NNUE, etiny: EtinyNet, folder: Path) -> Tuple[Path, Path]:
    """Both models quantized and written as the engine reads them."""
    nnue_path, etiny_path = folder / "model.nnue", folder / "model.etiny"
    write_nnue(nnue.quantize(), nnue_path)
    write_etiny(etiny.quantize(), etiny_path)
    return nnue_path, etiny_path


def engine_ms(exe: Path, model: Path, images: Path, samples: int) -> float:
    """Wall ms per image of one engine process over `samples` images."""
    t0 = time.perf_counter()
    r = subprocess.run([str(exe), str(model), str(images), str(H), str(W),
                        str(samples)], capture_output=True, text=True,
                       timeout=600)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{exe.name} failed (rc={r.returncode}): {r.stderr}")
    return dt / samples * 1000


def engine_benchmark_lines(build: Path, nnue_path: Path, iters: int) -> List[str]:
    """The machine lines of `benchmark_engine` on the model."""
    r = subprocess.run([str(build / BENCHMARK_TOOL), str(nnue_path), str(iters)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{BENCHMARK_TOOL} failed (rc={r.returncode}): "
                           f"{r.stderr}")
    return [line for line in r.stdout.splitlines()
            if line.startswith(ENGINE_LINES)]


def serving_paths(nnue: NNUE, etiny: EtinyNet, images: np.ndarray,
                  device) -> Dict[str, Callable]:
    """{name: no-argument call} of K1, the NNUE sim, K6 and the EtinyNet sim
    on `images` on `device`; each returns the path's outputs (K1 and the
    NNUE sim: logits, density, count; K6 and its sim: logits)."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    flat = x.reshape(len(x), -1)
    kw = dict(image_h=H, image_w=W)
    sim, cfg = nnue_sim_params(nnue.quantize(), device=device)
    head = nk.mega_head_params(sim, cfg, H, W)
    esim, ecfg = etiny_sim_params(etiny.quantize(), device=device)
    kparams = ek.etiny_kernel_params(esim, ecfg)
    return {
        "K1": lambda: nk.nnue_engine_forward_mega(head, flat, cfg=cfg, **kw),
        "nnue sim": lambda: nnue_engine_forward(sim, x, cfg=cfg, **kw),
        "K6": lambda: ek.etiny_forward_kernel(kparams, x, cfg=ecfg, **kw),
        "etinynet sim": lambda: etiny_engine_forward(esim, x, cfg=ecfg, **kw),
    }


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def device_ms(paths: Dict[str, Callable], samples: int) -> Dict[str, float]:
    """Best-of-3 ms per image of each path, `REPS` calls in a row."""
    return {name: chained_best_ms(lambda f=fn: _first(f()), REPS) / samples
            for name, fn in paths.items()}


def run(samples: int = 64, iters: int = 200, skip_gpu: bool = False,
        device="cuda") -> dict:
    """The whole comparison; prints its lines and returns
    {"engine_ms": {model: ms}, "engine_lines": [...], "device_ms": {path: ms}
    (absent with skip_gpu), "outputs": {path: outputs on the images}}."""
    device = resolve_device(device)
    build = compile_benchmark_engine()  # all three tools, up to date
    nnue, etiny = make_models(device)
    print(f"NNUE params: {nnue.count_parameters():,}; "
          f"EtinyNet-micro params: {etiny.count_parameters():,}")
    rng = np.random.default_rng(0)
    images = rng.random((samples, H, W, 3), dtype=np.float32)
    result: dict = {"engine_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        nnue_path, etiny_path = write_models(nnue, etiny, Path(tmp))
        img_path = Path(tmp) / "images.bin"
        images.tofile(img_path)
        for name, model in (("nnue", nnue_path), ("etinynet", etiny_path)):
            ms = engine_ms(build / TOOLS[name], model, img_path, samples)
            result["engine_ms"][name] = ms
            print(f"C++ {name}: {ms:.4f} ms/image (batch of {samples}, "
                  "one process)")
        result["engine_lines"] = engine_benchmark_lines(build, nnue_path, iters)
        for line in result["engine_lines"]:
            print(line)
    if skip_gpu:
        return result

    paths = serving_paths(nnue, etiny, images, device)
    result["outputs"] = {name: fn() for name, fn in paths.items()}
    result["device_ms"] = device_ms(paths, samples)
    where = card(device) or "the CPU (host clock; the plain versions)"
    for name, model in (("K1", "nnue"), ("nnue sim", "nnue"),
                        ("K6", "etinynet"), ("etinynet sim", "etinynet")):
        ms = result["device_ms"][name]
        print(f"{name} int8: {ms:.5f} ms/image at batch {samples} "
              f"({result['engine_ms'][model] / ms:.0f}x the C++ engine) "
              f"on {where}")
    return result


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--samples", type=int, default=64)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--skip-gpu", action="store_true",
                        help="time the C++ engine only")
    parser.add_argument("--device", default="cuda",
                        help="where the models and the int8 paths run "
                             "(default: the card)")
    args = parser.parse_args(argv)
    run(args.samples, args.iters, args.skip_gpu, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
