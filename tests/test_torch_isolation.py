"""The port stands alone: it imports no jax, optax or ml_dtypes, no
module of the JAX package `nnue_vision_tpu`, and none of the repository's
root `benchmarks` package or root CLIs (`bench.py`, `serialize.py`,
`evaluate.py`, `train.py`), a request for CUDA on a host
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
    "nnue_vision_tpu_torch.bench",
    "nnue_vision_tpu_torch.benchmarks",
    "nnue_vision_tpu_torch.benchmarks.mcu_simulation",
    "nnue_vision_tpu_torch.benchmarks.tinyml_benchmarks",
    "nnue_vision_tpu_torch.bridge",
    "nnue_vision_tpu_torch.cloud",
    "nnue_vision_tpu_torch.cloud.launcher",
    "nnue_vision_tpu_torch.compare_engine_speed",
    "nnue_vision_tpu_torch.data.augment",
    "nnue_vision_tpu_torch.data.dataset_inspector",
    "nnue_vision_tpu_torch.data.datasets",
    "nnue_vision_tpu_torch.data.loaders",
    "nnue_vision_tpu_torch.deploy_etiny",
    "nnue_vision_tpu_torch.engine_speed_parity",
    "nnue_vision_tpu_torch.evaluate",
    "nnue_vision_tpu_torch.formats",
    "nnue_vision_tpu_torch.models.api",
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
    "nnue_vision_tpu_torch.profile_augment",
    "nnue_vision_tpu_torch.profile_batched_draws",
    "nnue_vision_tpu_torch.profile_etiny_pallas",
    "nnue_vision_tpu_torch.profile_etiny_roofline",
    "nnue_vision_tpu_torch.profile_etiny_train",
    "nnue_vision_tpu_torch.profile_heavy_aug",
    "nnue_vision_tpu_torch.profile_mega_bisect",
    "nnue_vision_tpu_torch.profile_nnue_split",
    "nnue_vision_tpu_torch.profile_photometric_rng",
    "nnue_vision_tpu_torch.profile_scaled_train",
    "nnue_vision_tpu_torch.profile_train_roofline",
    "nnue_vision_tpu_torch.profile_train_step",
    "nnue_vision_tpu_torch.profile_train_sweep",
    "nnue_vision_tpu_torch.profile_warp_split",
    "nnue_vision_tpu_torch.quantize",
    "nnue_vision_tpu_torch.real_data_eval",
    "nnue_vision_tpu_torch.reference_anchor",
    "nnue_vision_tpu_torch.run_example_benchmark",
    "nnue_vision_tpu_torch.run_mcu_benchmarks",
    "nnue_vision_tpu_torch.serialize",
    "nnue_vision_tpu_torch.stream_inference_demo",
    "nnue_vision_tpu_torch.torch_import",
    "nnue_vision_tpu_torch.tracing",
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
    "nnue_vision_tpu_torch.upstream_e2e_check",
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
        "root = [m for m in ('bench', 'benchmarks', 'serialize', 'evaluate', 'train')\n"
        "        if m in sys.modules or any(k.startswith(m + '.') for k in sys.modules)]\n"
        "assert not root, root\n"
        "import nnue_vision_tpu_torch as p; assert p.read_nnue and p.write_nnue\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_raises_without_cuda(tmp_path):
    """The serving params and every deployment entry point (the
    serialize, evaluate and stream CLIs, the facades, the upstream import,
    the MCU/TinyML CLIs, the engine-speed comparisons, the interchange check
    and the real-data evaluation) run on the card by default and raise here,
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import numpy as np

    from nnue_vision_tpu_torch import (
        compare_engine_speed,
        engine_speed_parity,
        evaluate,
        real_data_eval,
        run_example_benchmark,
        run_mcu_benchmarks,
        serialize,
        stream_inference_demo,
        upstream_e2e_check,
    )
    from nnue_vision_tpu_torch import torch_import
    from nnue_vision_tpu_torch.models import api
    from nnue_vision_tpu_torch.models.nnue import GridFeatureSet, NNUEConfig, nnue_init
    from nnue_vision_tpu_torch.ops.engine_sim import nnue_sim_params
    from nnue_vision_tpu_torch.training.checkpoint import save_checkpoint
    from tests.conftest import random_quantized_nnue
    from tests.test_torch_upstream_import import upstream_nnue_state_dict

    q = random_quantized_nnue(np.random.default_rng(51))
    with pytest.raises((RuntimeError, AssertionError)):
        nnue_sim_params(q, device="cuda")

    cfg = NNUEConfig(feature_set=GridFeatureSet(4, 4), l1_size=16, l2_size=8,
                     l3_size=4, num_classes=10)
    model = nnue_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt = tmp_path / "best_model.ckpt"
    save_checkpoint(ckpt, model_type="nnue", model_config=cfg, model=model,
                    epoch=0, metrics={})
    upstream = tmp_path / "upstream.pt"
    torch.save(upstream_nnue_state_dict(), upstream)
    fake_build = tmp_path / "build"
    fake_build.mkdir()
    (fake_build / "nnue_inference").write_text("")
    (tmp_path / "ref" / "include").mkdir(parents=True)
    calls = {
        "serialize": lambda: serialize.main([str(ckpt), str(tmp_path / "m.nnue")]),
        "run_mcu_benchmarks": lambda: run_mcu_benchmarks.main(
            ["--checkpoint", str(ckpt), "--output-dir", str(tmp_path / "mcu")]),
        "run_example_benchmark": lambda: run_example_benchmark.main([]),
        "compare_engine_speed": lambda: compare_engine_speed.main(["--skip-gpu"]),
        "upstream_e2e_check": lambda: upstream_e2e_check.main(
            ["--ckpt", str(ckpt), "--ref-build", str(fake_build)]),
        "engine_speed_parity": lambda: engine_speed_parity.main(
            ["--ref-src", str(tmp_path / "ref")]),
        "real_data_eval": lambda: real_data_eval.main(
            ["--log_dir", str(tmp_path / "runs")]),
        "evaluate": lambda: evaluate.main([str(ckpt), "--dataset", "synthetic-hard",
                                           "--synthetic_size", "16"]),
        "stream_inference_demo": lambda: stream_inference_demo.main(
            ["--frames", "2", "--batch", "2"]),
        "api.NNUE": lambda: api.NNUE(l1_size=16, l2_size=8, l3_size=4),
        "api.EtinyNet": lambda: api.EtinyNet(variant="micro", num_classes=10,
                                             input_size=32),
        "torch_import": lambda: torch_import.load_torch_checkpoint_auto(upstream),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "m.nnue").exists()
    assert not (tmp_path / "mcu").exists() and not (tmp_path / "runs").exists()
    assert torch_import.load_torch_checkpoint_auto(upstream, device="cpu")[0] == "nnue"


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
