"""The profiling path's host side on the CPU: the timing harness
(`ops/timing.py`), the training loop's `profile_dir` trace, and the
defaults that send every entry point to the card unless the CPU is asked
for."""

import inspect
import json
from pathlib import Path

import pytest
import torch

from config import load_config
from nnue_vision_tpu_torch import profile_mega_bisect, profile_warp_split
from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.ops import timing
from nnue_vision_tpu_torch.training import loop as tloop

REPO = Path(__file__).resolve().parent.parent
TEST_CONFIG = str(REPO / "config" / "train_nnue_test.py")


def test_chained_best_ms_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3)

    ms = timing.chained_best_ms(fn, reps=4, n_timing=2)
    assert ms > 0
    assert len(calls) == 1 + 4 * 2  # warm-up, then n_timing runs of reps
    assert timing.card("cpu") is None


@pytest.mark.parametrize("reps,n_timing", [(0, 3), (2, 0)])
def test_chained_best_ms_needs_a_rep(reps, n_timing):
    with pytest.raises(ValueError, match="reps"):
        timing.chained_best_ms(lambda: torch.ones(1), reps=reps,
                               n_timing=n_timing)


@pytest.mark.parametrize("fused", [False, True], ids=["as-is", "fused-light"])
def test_train_model_writes_a_trace(tmp_path, monkeypatch, capsys, fused):
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config(TEST_CONFIG)
    cfg.log_dir = str(tmp_path / "logs")
    cfg.profile_dir = str(tmp_path / "trace")
    cfg.use_augmentation = fused  # the light tier: the fused K3 path
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    path = tmp_path / "trace" / "train_epoch0.trace.json"
    out = capsys.readouterr().out
    assert f"profiler trace written to {path}" in out
    assert ("fused input pipeline active" in out) == fused
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)  # the steps' host ops


def test_train_defaults_to_the_card():
    args = tcli.setup_argument_parser().parse_args(["nnue"])
    assert args.device == "cuda"
    assert inspect.signature(tloop.train_model).parameters["device"].default == "cuda"
    for probe in (profile_mega_bisect, profile_warp_split):
        assert inspect.signature(probe.run).parameters["device"].default == "cuda"


def test_cli_without_device_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["nnue", "--config", TEST_CONFIG, "--log_dir",
                   str(tmp_path / "logs")])
    assert not list((tmp_path / "logs").rglob("*.ckpt"))  # nothing trained


@pytest.mark.parametrize("probe", [profile_mega_bisect, profile_warp_split])
def test_probes_without_device_raise_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["--batch", "2"])
