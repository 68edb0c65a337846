"""Build the C++ engine's inference tools and smoke-test them (port of
`nnue_vision_tpu/training/engine_build.py:24-108`).

`compile_cpp_engine` builds `nnue_inference` and `etinynet_inference` from
`engine/` with `engine/CMakeLists.txt` (cmake, then ninja, on every call;
Release: `-O3 -march=native -funroll-loops`) into `build/torch_engine/`
under the repository root, which `.gitignore` lists, and checks that the
model's binary runs. `compile_benchmark_engine` builds the same two tools
and the engine's density and incremental-update benchmark
`benchmark_engine` (which `compare_engine_speed.py` runs) there, under the
same lock. `build_sanitizer_engine` builds the same tools with ASan and
UBSan (`-DNV_SANITIZE=ON`) into `build/torch_engine_san/`, and
`smoke_test_sanitizer_engine` runs one image through the sanitized binary
on a small random model. The port never builds into `engine/build`, the
JAX package's directory. A build holds an exclusive `fcntl.flock` on a
lock file beside its directory, so two processes never build one
directory at once; ninja rebuilds only what changed.

The random models are the port's copies of the JAX package's test
generators, written with the port's `formats.py`.
"""

from __future__ import annotations

import fcntl
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from nnue_vision_tpu_torch.formats import (
    QConv,
    QFeatureTransformer,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
    QuantizedNNUE,
    write_etiny,
    write_nnue,
)
from nnue_vision_tpu_torch.training.logging import early_log

REPO_ROOT = Path(__file__).resolve().parents[2]
ENGINE_DIR = REPO_ROOT / "engine"
BUILD_DIR = REPO_ROOT / "build" / "torch_engine"
SANITIZER_BUILD_DIR = REPO_ROOT / "build" / "torch_engine_san"
TOOLS = {"nnue": "nnue_inference", "etinynet": "etinynet_inference"}
BENCHMARK_TOOL = "benchmark_engine"


def tool_name(model_type: str) -> str:
    if model_type not in TOOLS:
        raise ValueError(f"unknown model type: {model_type}")
    return TOOLS[model_type]


def _cmake_build(build_dir: Path, extra_flags=(),
                 targets=tuple(TOOLS.values())) -> None:
    """Configure and build `targets` (by default the two inference tools,
    with the engine's static library, `libnv_engine.a`) in `build_dir`,
    under an exclusive lock on `<build_dir>.lock`. cmake runs on every call,
    so a cache made for another source tree fails loudly here."""
    build_dir.parent.mkdir(parents=True, exist_ok=True)
    with open(build_dir.with_name(build_dir.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cfg = subprocess.run(
            ["cmake", "-S", str(ENGINE_DIR), "-B", str(build_dir),
             "-DCMAKE_BUILD_TYPE=Release", "-G", "Ninja", *extra_flags],
            capture_output=True, text=True, timeout=120,
        )
        if cfg.returncode != 0:
            raise RuntimeError(f"cmake failed:\n{cfg.stdout}\n{cfg.stderr}")
        bld = subprocess.run(
            ["ninja", "-C", str(build_dir), *targets],
            capture_output=True, text=True, timeout=600,
        )
        if bld.returncode != 0:
            raise RuntimeError(f"build failed:\n{bld.stdout}\n{bld.stderr}")


def compile_cpp_engine(model_type: str) -> Path:
    """Build the engine's tools and check that the model's binary runs;
    returns its path."""
    early_log(f"Compiling C++ engine for {model_type}...")
    exe = BUILD_DIR / tool_name(model_type)
    _cmake_build(BUILD_DIR)
    if not exe.is_file():
        raise RuntimeError(f"expected executable missing: {exe}")
    probe = subprocess.run([str(exe)], capture_output=True, text=True, timeout=10)
    if probe.returncode not in (0, 1):  # usage exits 1
        raise RuntimeError(f"engine binary not runnable (rc={probe.returncode})")
    early_log(f"C++ engine ready: {exe}")
    return exe


def compile_benchmark_engine() -> Path:
    """The two inference tools and `BENCHMARK_TOOL`, built in `BUILD_DIR`;
    returns the directory."""
    early_log("Compiling C++ engine and its benchmark...")
    _cmake_build(BUILD_DIR, targets=(*TOOLS.values(), BENCHMARK_TOOL))
    return BUILD_DIR


def build_sanitizer_engine() -> Path:
    """The tools built with ASan and UBSan; returns the directory."""
    early_log("Building sanitizer engine (ASan+UBSan)...")
    _cmake_build(SANITIZER_BUILD_DIR, extra_flags=["-DNV_SANITIZE=ON"])
    early_log("Sanitizer engine built")
    return SANITIZER_BUILD_DIR


def random_quantized_nnue(rng: np.random.Generator, grid=4, ch=6, l1=16, l2=8,
                          l3=4, num_classes=3, visual_threshold=0.07
                          ) -> QuantizedNNUE:
    """A random but valid QuantizedNNUE (the JAX package's test generator)."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    def i32(*s, lo=-2000, hi=2000):
        return rng.integers(lo, hi, s).astype(np.int32)

    f = grid * grid * ch
    return QuantizedNNUE(
        grid_size=grid, num_features_per_square=ch, l1=l1, l2=l2, l3=l3,
        nnue2score=600.0, visual_threshold=visual_threshold,
        conv=QConv(weight=i8(ch, 3, 3, 3), bias=i32(ch, lo=-500, hi=500)),
        ft=QFeatureTransformer(weight=i8(f, l1).astype(np.int16), bias=i32(l1)),
        fc1=QLinear(weight=i8(l2, l1), bias=i32(l2)),
        fc2=QLinear(weight=i8(l3, l2), bias=i32(l3)),
        out=QLinear(weight=i8(num_classes, l3), bias=i32(num_classes)),
    ).validate()


def random_quantized_etiny(rng: np.random.Generator, num_classes=10,
                           input_size=32) -> QuantizedEtinyNet:
    """A random micro-scale QuantizedEtinyNet with a stride-2 dense block
    (the JAX package's test generator)."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    blocks = [
        QLBBlock(pw_expand=i8(16, 8), dw=i8(16, 3, 3), pw_project=i8(16, 16),
                 stride=2),
        QLBBlock(pw_expand=i8(24, 16), dw=i8(24, 3, 3), pw_project=i8(24, 24),
                 stride=2, is_dense=True),
        QLBBlock(pw_expand=i8(24, 24), dw=i8(24, 3, 3), pw_project=i8(24, 24),
                 stride=1, is_dense=True),
    ]
    return QuantizedEtinyNet(
        variant="micro", num_classes=num_classes, input_size=input_size,
        conv_channels=8, final_channels=24,
        stem=QConv(weight=i8(8, 3, 3, 3),
                   bias=rng.integers(-500, 500, 8).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=i8(num_classes, 24),
                           bias=rng.integers(-2000, 2000, num_classes
                                             ).astype(np.int32)),
    ).validate()


def smoke_test_sanitizer_engine(model_type: str) -> None:
    """One 32×32 image through the sanitized binary on a small random
    model; raises with its output if it fails."""
    early_log("Running sanitizer smoke test...")
    exe = SANITIZER_BUILD_DIR / tool_name(model_type)
    if not exe.is_file():
        raise RuntimeError(f"sanitizer executable not found: {exe}")
    rng = np.random.default_rng(0)
    h = 32
    with tempfile.TemporaryDirectory() as tmp:
        if model_type == "nnue":
            model_path = Path(tmp) / "model.nnue"
            write_nnue(random_quantized_nnue(rng, grid=8, ch=4, l1=64, l2=4,
                                             l3=8, num_classes=10), model_path)
        else:
            model_path = Path(tmp) / "model.etiny"
            write_etiny(random_quantized_etiny(rng), model_path)
        img_path = Path(tmp) / "image.bin"
        rng.random((h, h, 3), dtype=np.float32).tofile(img_path)
        res = subprocess.run(
            [str(exe), str(model_path), str(img_path), str(h), str(h)],
            capture_output=True, text=True, timeout=60,
        )
    if res.returncode != 0:
        raise RuntimeError(
            f"sanitizer smoke failed (rc={res.returncode})\n"
            f"stdout: {res.stdout}\nstderr: {res.stderr}"
        )
    early_log("Sanitizer smoke test passed")
