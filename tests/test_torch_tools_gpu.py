"""The port's user tools on a card: `compare_engine_speed` with K1 and K6
equal to the sims on its images, `upstream_e2e_check` with the C++ engine
equal to K1 and the sim as printed, and the MCU/TinyML CLIs.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it (the package's
`tests/conftest.py` imports jax, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_tools_gpu.py
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch import (
    compare_engine_speed,
    run_example_benchmark,
    run_mcu_benchmarks,
    upstream_e2e_check,
)
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from nnue_vision_tpu_torch.training.engine_build import BUILD_DIR, compile_cpp_engine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("NV_DATA_DIR", str(tmp_path / "no_data"))
    compile_cpp_engine("nnue")
    return torch.device("cuda")


def _nnue_ckpt(path):
    cfg = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(10, 8), l1_size=64,
                           l2_size=16, l3_size=8, num_classes=10, input_size=32)
    rng = np.random.default_rng(3)

    def u(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)

    params = {"conv_w": u(8, 3, 3, 3), "visual_threshold": np.full(8, 0.05, np.float32),
              "ft_w": u(800, 64), "ft_b": u(64), "fc1_w": u(16, 64), "fc1_b": u(16),
              "fc2_w": u(8, 16), "fc2_b": u(8), "out_w": u(10, 8), "out_b": u(10),
              "nnue2score": np.float32(600.0)}
    model = nnue_from_jax_params(params, cfg, device="cpu")
    tckpt.save_checkpoint(path, model_type="nnue", model_config=cfg, model=model,
                          epoch=0, metrics={})
    return path


def test_compare_engine_speed_kernels_equal_sims(cuda):
    nk.reset_launch_counts()
    ek.reset_launch_counts()
    result = compare_engine_speed.run(samples=64, iters=3, device=cuda)
    out = result["outputs"]
    for a, b in zip(out["K1"], out["nnue sim"]):
        assert torch.equal(a, b)
    assert torch.equal(out["K6"], out["etinynet sim"])
    assert nk.LAUNCHES["nnue_mega_kernel"] > compare_engine_speed.REPS
    assert ek.LAUNCHES["etiny_block_kernel"] > compare_engine_speed.REPS
    assert all(ms > 0 for ms in result["device_ms"].values())


def test_upstream_e2e_bit_exact_against_k1(cuda, tmp_path):
    ckpt = _nnue_ckpt(tmp_path / "best_model.ckpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = upstream_e2e_check.main(["--ckpt", str(ckpt), "--ref-build",
                                      str(BUILD_DIR), "--n", "16",
                                      "--synthetic-size", "256"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0, out
    assert out["bit_exact_vs_k1"] == out["bit_exact_vs_our_sim"] == out["n"] == 16


def test_mcu_clis_on_the_card(cuda, tmp_path):
    ckpt = _nnue_ckpt(tmp_path / "best_model.ckpt")
    assert run_mcu_benchmarks.main(["--checkpoint", str(ckpt), "--max-samples", "32",
                                    "--output-dir", str(tmp_path / "out")]) == 0
    report = json.loads((tmp_path / "out" / "tinyml_report.json").read_text())
    assert report["model_info"]["name"] == "NNUE-Vision"
    assert (tmp_path / "out" / "mcu_benchmark.json").is_file()
    assert run_example_benchmark.main([]) == 0
