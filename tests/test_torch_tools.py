"""The port's user tools held to the JAX package's on the CPU:
`run_mcu_benchmarks`, `run_example_benchmark`, `compare_engine_speed`,
`upstream_e2e_check`, `engine_speed_parity`, `real_data_eval` and
`reference_anchor` (`python -m nnue_vision_tpu_torch.<tool>`), and the
engine build's `benchmark_engine` target. The root scripts are loaded from
their files; the ones that print a result run as subprocesses. The cases
that need the card are in tests/test_torch_tools_gpu.py; the reference
half of `engine_speed_parity` runs only where the upstream checkout is."""

import dataclasses
import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nnue_vision_tpu import formats as jformats
from nnue_vision_tpu.models import api as japi
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models.nnue import GridFeatureSet as JGrid
from nnue_vision_tpu.training import checkpoint as jckpt
from nnue_vision_tpu_torch import (
    compare_engine_speed,
    engine_speed_parity,
    real_data_eval,
    reference_anchor,
    run_example_benchmark,
    run_mcu_benchmarks,
    upstream_e2e_check,
)
from nnue_vision_tpu_torch.bridge import _flatten, etinynet_to_numpy, nnue_to_numpy
from nnue_vision_tpu_torch.models import api as tapi
from nnue_vision_tpu_torch.training import engine_build as eb
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from tests.test_torch_benchmarks import HOST_TIMED, assert_close
from tests.test_torch_serialize import NNUE_CFG, _nnue_params, _port_etiny_ckpt

# the serialize tests' NNUE at the datasets' 32×32 (its input_size 12 would
# give a conv output past its grid on these images)
NNUE_32 = dataclasses.replace(NNUE_CFG, input_size=32)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_data(monkeypatch, tmp_path):
    monkeypatch.setenv("NV_NO_DOWNLOAD", "1")
    monkeypatch.setenv("NV_DATA_DIR", str(tmp_path / "no_data"))


def _script(name):
    """A root tool (`scripts/<name>.py` or `<name>.py`) loaded from its file."""
    path = REPO / "scripts" / f"{name}.py"
    if not path.exists():
        path = REPO / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_root_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(REPO))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO))
    return module


def _run_script(name, *args):
    """(exit code, stdout, stderr) of `python scripts/<name>.py ARGS` on the
    CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / f"{name}.py"),
                           *map(str, args)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def engine():
    return eb.compile_benchmark_engine()


# -- run_mcu_benchmarks, run_example_benchmark ------------------------------


def test_engine_build_makes_benchmark_engine(engine):
    assert engine == eb.BUILD_DIR
    # the inference build returns what it did before
    assert eb.compile_cpp_engine("nnue") == eb.BUILD_DIR / "nnue_inference"
    for target in (*eb.TOOLS.values(), eb.BENCHMARK_TOOL, "libnv_engine.a"):
        assert (engine / target).is_file(), target
    usage = subprocess.run([str(engine / eb.BENCHMARK_TOOL), "-", "2"],
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and "RESULT_AVG_MS:" in usage.stdout


def test_mcu_parse_arguments_defaults_equal_jax():
    ours = vars(run_mcu_benchmarks.parse_arguments([]))
    theirs = vars(_script("run_mcu_benchmarks").parse_arguments([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    flags = ["--visual-wake-words", "--max-samples", "7", "--l1-size", "64"]
    ours = vars(run_mcu_benchmarks.parse_arguments(flags))
    ours.pop("device")
    assert ours == vars(_script("run_mcu_benchmarks").parse_arguments(flags))


def _port_nnue_ckpt(path, seed):
    model = nnue_from_jax_params(_nnue_params(seed), NNUE_32, device="cpu")
    tckpt.save_checkpoint(path, model_type="nnue", model_config=NNUE_32,
                          model=model, epoch=3, metrics={"val_f1": 0.5})
    return path


def test_nnue_forward_refuses_images_past_its_grid():
    """A float NNUE given images larger than its input size: JAX's forward
    raises, and so does the port's (it used to crop the features)."""
    model = nnue_from_jax_params(_nnue_params(0), NNUE_CFG, device="cpu")
    with pytest.raises(ValueError, match="exceeds the feature grid"):
        model(torch.zeros((1, 32, 32, 3)))
    jmodel = japi.NNUE(feature_set=JGrid(4, 6), l1_size=16, l2_size=8, l3_size=4,
                       num_classes=3, input_size=12)
    with pytest.raises(ValueError):
        jmodel(np.zeros((1, 32, 32, 3), np.float32))
    assert model(torch.zeros((1, 12, 12, 3))).shape == (1, 3)


def _jax_ckpt(path, family):
    if family == "nnue":
        from nnue_vision_tpu.models import nnue as jnnue

        cfg = jnnue.NNUEConfig(feature_set=JGrid(4, 6), l1_size=16, l2_size=8,
                               l3_size=4, num_classes=3, input_size=32)
        jckpt.save_checkpoint(path, model_type="nnue", model_config=cfg, epoch=0,
                              metrics={}, params=jax.device_get(
                                  jnnue.nnue_init(jax.random.PRNGKey(3), cfg)))
    else:
        cfg = jetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=32)
        params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(4),
                                                            cfg))
        jckpt.save_checkpoint(path, model_type="etinynet", model_config=cfg,
                              epoch=0, metrics={}, params=params,
                              batch_stats=stats)
    return path


@pytest.mark.parametrize("family", ["nnue", "etinynet"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_load_model_equals_jax(tmp_path, family, source):
    ckpt = tmp_path / "best_model.ckpt"
    if source == "jax":
        _jax_ckpt(ckpt, family)
    elif family == "nnue":
        _port_nnue_ckpt(ckpt, seed=5)
    else:
        _port_etiny_ckpt(ckpt, engine_friendly=False, seed=6)
    args = run_mcu_benchmarks.parse_arguments(["--checkpoint", str(ckpt),
                                               "--device", "cpu"])
    ours = run_mcu_benchmarks.load_model(args)
    theirs = _script("run_mcu_benchmarks").load_model(args)
    assert type(ours).__name__ == type(theirs).__name__
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(theirs.cfg)
    assert ours.count_parameters() == theirs.count_parameters()
    if family == "nnue":
        got, want = nnue_to_numpy(ours.module), theirs.params
    else:
        p, stats = etinynet_to_numpy(ours.module)
        got, want = {"p": p, "s": stats}, {"p": theirs.params, "s": theirs.batch_stats}
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32), k)


def _mcu_main_both(tmp_path, monkeypatch, args):
    """(port's JSON files, JAX's) of the two CLIs on the same arguments."""
    assert run_mcu_benchmarks.main([*args, "--output-dir", str(tmp_path / "t"),
                                    "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["run_mcu_benchmarks.py", *args,
                                      "--output-dir", str(tmp_path / "j")])
    assert _script("run_mcu_benchmarks").main() == 0
    return [{name: json.loads((tmp_path / side / name).read_text())
             for name in ("mcu_benchmark.json", "tinyml_report.json")}
            for side in ("t", "j")]


@pytest.mark.parametrize("family", ["nnue", "etinynet"])
def test_mcu_cli_on_a_checkpoint_matches_jax(tmp_path, monkeypatch, capsys, family):
    ckpt = tmp_path / "best_model.ckpt"
    if family == "nnue":
        _port_nnue_ckpt(ckpt, seed=7)
    else:
        _port_etiny_ckpt(ckpt, engine_friendly=False, seed=8)
    ours, theirs = _mcu_main_both(
        tmp_path, monkeypatch, ["--checkpoint", str(ckpt), "--max-samples", "40",
                                "--batch-size", "8"])
    assert ours["mcu_benchmark.json"] == theirs["mcu_benchmark.json"]
    report, their_report = ours["tinyml_report.json"], theirs["tinyml_report.json"]
    assert_close(report, their_report, skip=HOST_TIMED | {"key_advantages"})
    assert "parameters" in capsys.readouterr().out


def test_mcu_cli_fresh_vww_model_matches_jax(tmp_path, monkeypatch):
    """A fresh model from the architecture flags, Visual-Wake-Words remap:
    the MCU analysis depends on shapes alone, so it is equal although the
    two frameworks draw different weights."""
    ours, theirs = _mcu_main_both(
        tmp_path, monkeypatch, ["--visual-wake-words", "--grid-size", "4",
                                "--l1-size", "32", "--l2-size", "8",
                                "--l3-size", "4", "--max-samples", "16",
                                "--batch-size", "8"])
    assert ours["mcu_benchmark.json"] == theirs["mcu_benchmark.json"]
    for report in (ours, theirs):
        assert report["tinyml_report.json"]["model_info"]["dataset"] == \
            "visual_wake_words"


def test_example_model_and_cli(capsys):
    ours = run_example_benchmark.create_example_model(device="cpu")
    theirs = _script("run_example_benchmark").create_example_model()
    assert ours.count_parameters() == theirs.count_parameters()
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(theirs.cfg)
    assert run_example_benchmark.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"Example model: {ours.count_parameters():,} parameters" in out
    assert "Best platform: ARM Cortex-M4" in out


# -- compare_engine_speed ---------------------------------------------------


def test_engine_files_equal_jax_writer(tmp_path):
    """The tool's models as the JAX tool builds them, bridged: the `.nnue`
    and `.etiny` bytes the port writes equal the JAX writer's."""
    jn = japi.NNUE(feature_set=JGrid(10, 8), l1_size=1024, l2_size=128,
                   l3_size=32, num_classes=10, input_size=32)
    je = japi.EtinyNet(variant="micro", num_classes=10, input_size=32)
    tn = tapi.NNUE(feature_set=compare_engine_speed.GridFeatureSet(10, 8),
                   l1_size=1024, l2_size=128, l3_size=32, num_classes=10,
                   input_size=32, params=jn.params, device="cpu")
    te = tapi.EtinyNet(variant="micro", num_classes=10, input_size=32,
                       params=je.params, batch_stats=je.batch_stats, device="cpu")
    ours = compare_engine_speed.write_models(tn, te, tmp_path)
    jformats.write_nnue(jn.quantize(), tmp_path / "j.nnue")
    jformats.write_etiny(je.quantize(), tmp_path / "j.etiny")
    assert ours[0].read_bytes() == (tmp_path / "j.nnue").read_bytes()
    assert ours[1].read_bytes() == (tmp_path / "j.etiny").read_bytes()
    fresh = compare_engine_speed.make_models("cpu")
    assert fresh[0].count_parameters() == jn.count_parameters()
    assert fresh[1].count_parameters() == je.count_parameters()


def test_engine_benchmark_lines_parse(engine, tmp_path):
    nnue, etiny = compare_engine_speed.make_models("cpu")
    nnue_path, _ = compare_engine_speed.write_models(nnue, etiny, tmp_path)
    lines = compare_engine_speed.engine_benchmark_lines(engine, nnue_path, 3)
    tags = [line.split(":", 1)[0] for line in lines]
    assert tags.count("DENSITY_RESULT") == 5
    assert tags[-2:] == ["RESULT_AVG_MS", "INCREMENTAL_SPEEDUP"]
    for line in lines:
        assert float(line.rsplit(":", 1)[1]) > 0, line


def test_compare_engine_speed_cpu_run(capsys):
    """The whole tool on the CPU at a tiny size: the plain versions of K1
    and K6 equal to the sims on the tool's images, every line printed."""
    result = compare_engine_speed.run(samples=4, iters=2, device="cpu")
    out = result["outputs"]
    for a, b in zip(out["K1"], out["nnue sim"]):
        assert torch.equal(a, b)
    assert torch.equal(out["K6"], out["etinynet sim"])
    assert out["K1"][0].shape == (4, 10) and out["K6"].shape == (4, 10)
    assert set(result["device_ms"]) == {"K1", "nnue sim", "K6", "etinynet sim"}
    assert all(ms > 0 for ms in result["device_ms"].values())
    text = capsys.readouterr().out
    assert "C++ nnue:" in text and "RESULT_AVG_MS:" in text
    assert text.count("host clock") == 4
    skipped = compare_engine_speed.run(samples=2, iters=2, skip_gpu=True,
                                       device="cpu")
    assert "device_ms" not in skipped and skipped["engine_ms"]["etinynet"] > 0


# -- upstream_e2e_check -----------------------------------------------------


def test_upstream_e2e_json_equals_jax(engine, tmp_path, capsys):
    ckpt = _port_nnue_ckpt(tmp_path / "best_model.ckpt", seed=9)
    args = ["--ckpt", str(ckpt), "--ref-build", str(engine), "--n", "8",
            "--synthetic-size", "64"]
    assert upstream_e2e_check.main([*args, "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc, out, err = _run_script("upstream_e2e_check", *args)
    assert rc == 0, err
    assert ours == json.loads(out.strip().splitlines()[-1])
    assert ours["bit_exact_vs_our_sim"] == ours["n"] == 8
    assert "bit_exact_vs_k1" not in ours


def test_upstream_e2e_missing_binary_exits_2(tmp_path):
    args = ["--ckpt", str(tmp_path / "none.ckpt"), "--ref-build",
            str(tmp_path / "no_build")]
    assert upstream_e2e_check.main([*args, "--device", "cpu"]) == 2
    assert _run_script("upstream_e2e_check", *args)[0] == 2


# -- engine_speed_parity ----------------------------------------------------


def test_speed_parity_harnesses_and_parse_ms_equal_jax():
    theirs = _script("engine_speed_parity")
    assert engine_speed_parity.OUR_HARNESS == theirs.OUR_HARNESS
    assert engine_speed_parity.REF_HARNESS == theirs.REF_HARNESS
    text = "NNUE_MS_PER_IMAGE:0.012500\nETINY_MS_PER_IMAGE:0.5\nnoise: x\nA:B:7"
    assert engine_speed_parity.parse_ms(text) == theirs.parse_ms(text) == {
        "NNUE_MS_PER_IMAGE": 0.0125, "ETINY_MS_PER_IMAGE": 0.5, "A:B": 7.0}
    # the upstream checkout comes only from NV_REFERENCE_DIR, never a default
    env = os.environ.get("NV_REFERENCE_DIR")
    expected = Path(env) if env else None
    assert engine_speed_parity.REFERENCE == reference_anchor.REFERENCE == expected


def test_own_engine_harness_compiles_and_runs(engine, tmp_path):
    exe = engine_speed_parity.compile_harness(
        engine_speed_parity.OUR_HARNESS, "ours", REPO / "engine" / "include",
        engine_speed_parity.build_our_engine() / "libnv_engine.a", tmp_path)
    rng = np.random.default_rng(0)
    eb.write_nnue(eb.random_quantized_nnue(rng), tmp_path / "m.nnue")
    eb.write_etiny(eb.random_quantized_etiny(rng), tmp_path / "m.etiny")
    rng.random((2, 32, 32, 3), dtype=np.float32).tofile(tmp_path / "i.bin")
    out = engine_speed_parity.sh([str(exe), str(tmp_path / "m.nnue"),
                                  str(tmp_path / "m.etiny"),
                                  str(tmp_path / "i.bin"), "32", "32", "2", "1"])
    ms = engine_speed_parity.parse_ms(out.stdout)
    assert set(ms) == {"NNUE_MS_PER_IMAGE", "ETINY_MS_PER_IMAGE"}
    assert all(v > 0 for v in ms.values())


def test_speed_parity_without_reference_exits_2(tmp_path, capsys, monkeypatch):
    assert engine_speed_parity.main(["--ref-src", str(tmp_path / "none"),
                                     "--device", "cpu"]) == 2
    assert "reference engine sources not found" in capsys.readouterr().err
    monkeypatch.setattr(engine_speed_parity, "REFERENCE", None)
    assert engine_speed_parity.main(["--device", "cpu"]) == 2
    assert "no reference engine sources" in capsys.readouterr().err


def test_speed_parity_against_the_reference(tmp_path):
    if engine_speed_parity.REFERENCE is None:
        pytest.skip("NV_REFERENCE_DIR names no upstream checkout")
    rc = engine_speed_parity.main(["--images", "4", "--iters", "2", "--device",
                                   "cpu", "--out", str(tmp_path / "parity.md")])
    assert rc in (0, 2)
    assert "| NNUE (10×10×8, L1=1024) |" in (tmp_path / "parity.md").read_text()


# -- real_data_eval, reference_anchor --------------------------------------


def test_real_data_eval_refuses_synthetic_fallback(tmp_path, capsys):
    assert real_data_eval.main(["--device", "cpu", "--log_dir",
                                str(tmp_path / "logs")]) == 2
    assert "NOT available" in capsys.readouterr().err
    assert not (tmp_path / "logs").exists()
    rc, _, err = _run_script("real_data_eval")
    assert rc == 2 and "NOT available" in err


def test_export_fake_cifar_bytes_equal_jax(tmp_path):
    reference_anchor.export_fake_cifar(tmp_path / "t", 96, 40, seed=42)
    _script("reference_anchor").export_fake_cifar(tmp_path / "j", 96, 40, seed=42)
    names = sorted(p.name for p in (tmp_path / "j" / "cifar-10-batches-py").iterdir())
    assert names == sorted(
        p.name for p in (tmp_path / "t" / "cifar-10-batches-py").iterdir())
    assert len(names) == 7
    for name in names:
        assert (tmp_path / "t" / "cifar-10-batches-py" / name).read_bytes() == \
            (tmp_path / "j" / "cifar-10-batches-py" / name).read_bytes(), name
    with open(tmp_path / "t" / "cifar-10-batches-py" / "test_batch", "rb") as f:
        assert pickle.load(f)[b"data"].shape == (40, 3072)


def _fake_reference(root: Path) -> Path:
    (root / "config").mkdir(parents=True)
    (root / "train.py").write_text("# upstream trainer\n")
    (root / "evaluate.py").write_text(
        "def evaluate():\n" + reference_anchor._ETINY_EVAL_BUG + "    return 0\n")
    (root / "data" / "raw").mkdir(parents=True)
    (root / "data" / "raw" / "big.bin").write_bytes(b"x")
    (root / ".git").mkdir()
    return root


def test_patch_etiny_eval_bug_on_a_fake_tree(tmp_path):
    theirs = _script("reference_anchor")
    assert reference_anchor._ETINY_EVAL_BUG == theirs._ETINY_EVAL_BUG
    for module, side in ((reference_anchor, "t"), (theirs, "j")):
        module.patch_etiny_eval_bug(_fake_reference(tmp_path / side))
    patched = (tmp_path / "t" / "evaluate.py").read_text()
    assert patched == (tmp_path / "j" / "evaluate.py").read_text()
    assert reference_anchor._ETINY_EVAL_BUG not in patched
    with pytest.raises(RuntimeError, match="layout changed"):
        reference_anchor.patch_etiny_eval_bug(tmp_path / "t")


def test_reference_anchor_without_checkout_exits_2(tmp_path, monkeypatch, capsys):
    for missing in (None, tmp_path / "none"):
        monkeypatch.setattr(reference_anchor, "REFERENCE", missing)
        assert reference_anchor.main(["--workdir", str(tmp_path / "work"),
                                      "--prepare-only"]) == 2
        assert "set NV_REFERENCE_DIR" in capsys.readouterr().err
    assert not (tmp_path / "work").exists()


@pytest.mark.parametrize("model", ["nnue", "etinynet"])
def test_reference_anchor_prepares_a_fake_checkout(tmp_path, monkeypatch, capsys,
                                                   model):
    theirs = _script("reference_anchor")
    for name in ("WANDB_STUB", "ALBUMENTATIONS_STUB", "ALBUMENTATIONS_PYTORCH_STUB",
                 "TORCHVISION_INIT_STUB", "TORCHVISION_DATASETS_STUB",
                 "RUNPOD_STUB", "RUNNER", "ANCHOR_CONFIG", "ETINY_ANCHOR_CONFIG",
                 "EXCLUDE"):
        assert getattr(reference_anchor, name) == getattr(theirs, name), name
    ref = _fake_reference(tmp_path / "reference")
    monkeypatch.setattr(reference_anchor, "REFERENCE", ref)
    work = tmp_path / "work"
    assert reference_anchor.main(["--workdir", str(work), "--prepare-only",
                                  "--train-size", "64", "--test-size", "16",
                                  "--model", model]) == 0
    for dep in ("wandb.py", "albumentations/__init__.py", "albumentations/pytorch.py",
                "torchvision/datasets.py", "nnue_runpod_service.py",
                "run_anchor_train.py", "config/train_anchor.py", "train.py"):
        assert (work / dep).exists(), dep
    assert not (work / ".git").exists() and not (work / "data" / "raw" / "big.bin").exists()
    assert f'train_model(cfg, "{model}")' in (work / "run_anchor_train.py").read_text()
    patched = reference_anchor._ETINY_EVAL_BUG not in (work / "evaluate.py").read_text()
    assert patched == (model == "etinynet")
    assert "prepared; run:" in capsys.readouterr().out
