"""The port stands alone: it imports no jax, optax or ml_dtypes and no
module of the JAX package `nnue_vision_tpu`, a request for CUDA on a host
without it raises instead of falling back, and `chip_smoke.py` fails
without a card or without the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
MODULES = [
    "nnue_vision_tpu_torch",
    "nnue_vision_tpu_torch.bridge",
    "nnue_vision_tpu_torch.data.augment",
    "nnue_vision_tpu_torch.data.dataset_inspector",
    "nnue_vision_tpu_torch.data.datasets",
    "nnue_vision_tpu_torch.data.loaders",
    "nnue_vision_tpu_torch.formats",
    "nnue_vision_tpu_torch.models.etinynet",
    "nnue_vision_tpu_torch.models.nnue",
    "nnue_vision_tpu_torch.ops._build",
    "nnue_vision_tpu_torch.ops.engine_sim",
    "nnue_vision_tpu_torch.ops.etiny_kernels",
    "nnue_vision_tpu_torch.ops.input_pipeline",
    "nnue_vision_tpu_torch.ops.nnue_kernels",
    "nnue_vision_tpu_torch.ops.photometric_kernel",
    "nnue_vision_tpu_torch.ops.timing",
    "nnue_vision_tpu_torch.ops.warp_kernel",
    "nnue_vision_tpu_torch.parallel",
    "nnue_vision_tpu_torch.parallel.distributed",
    "nnue_vision_tpu_torch.parallel.mesh",
    "nnue_vision_tpu_torch.profile_mega_bisect",
    "nnue_vision_tpu_torch.profile_train_step",
    "nnue_vision_tpu_torch.profile_warp_split",
    "nnue_vision_tpu_torch.quantize",
    "nnue_vision_tpu_torch.training.checkpoint",
    "nnue_vision_tpu_torch.training.engine_build",
    "nnue_vision_tpu_torch.training.evaluate",
    "nnue_vision_tpu_torch.training.logging",
    "nnue_vision_tpu_torch.training.loop",
    "nnue_vision_tpu_torch.training.metrics",
    "nnue_vision_tpu_torch.training.optim",
    "nnue_vision_tpu_torch.training.step",
    "nnue_vision_tpu_torch.training.utils",
    "nnue_vision_tpu_torch.train",
    "chip_smoke",
]


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}: __import__(m)\n"
        "bad = [m for m in ('jax', 'optax', 'ml_dtypes') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "ref = [m for m in sys.modules if m == 'nnue_vision_tpu'\n"
        "       or m.startswith('nnue_vision_tpu.')]\n"
        "assert not ref, ref\n"
        "import nnue_vision_tpu_torch as p; assert p.read_nnue and p.write_nnue\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import numpy as np

    from nnue_vision_tpu_torch.ops.engine_sim import nnue_sim_params
    from tests.conftest import random_quantized_nnue

    q = random_quantized_nnue(np.random.default_rng(51))
    with pytest.raises((RuntimeError, AssertionError)):
        nnue_sim_params(q, device="cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from nnue_vision_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.environ.get("CUDA_HOME"):
        pytest.skip("this host has a CUDA toolkit")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()
    assert not (tmp_path / "build").exists()
    _build.load_library.cache_clear()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cli_help_runs_without_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['train', '--help']\n"
        "try:\n"
        "    runpy.run_module('nnue_vision_tpu_torch.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in ('jax', 'optax', 'ml_dtypes') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NV_SKIP_ENGINE=1" in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
