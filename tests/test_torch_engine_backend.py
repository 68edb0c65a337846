"""The C++ engine in the port's loop: the engine build, `engine_executable`
and its overrides, `evaluate_compiled_model` (a missing engine, a failing
one and its persisted repro, its metrics equal to the int8 sim's and to the
JAX package's function on the same model and binary), the engine's logits
equal to the port sim's for an NNUE, a 0.98M EtinyNet and an
engine_friendly `.etiny`, the start-up probe inside `train_model` (and a
broken binary stopping the run before any step), the sanitizer build, and
`compiled_backend="engine"` against "sim".

The engine is built by `training/engine_build.py` into `build/torch_engine/`
under a file lock; nothing here builds into `engine/build`. Logits are
compared exactly (the engine prints them with enough digits to round-trip
a float32 of magnitude 2^-10 or more; a smaller one moves by up to an
ulp, so the sim's logits are compared as the engine prints them,
`as_engine_prints`), densities to 1e-7 (the engine prints them rounded).
"""

import json
import math
import stat
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from config import load_config
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import evaluate as jevaluate
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.training import engine_build as eb
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training.evaluate import (
    as_engine_prints,
    engine_executable,
    engine_logits,
    evaluate_compiled_model,
    evaluate_int8_sim,
    evaluate_model_comprehensive,
)
from tests.test_torch_ef_etinynet import _cfgs as ef_cfgs
from tests.test_torch_ef_etinynet import _model as ef_model

REPO = Path(__file__).resolve().parent.parent
TCFG = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 4), l1_size=16,
                        l2_size=8, l3_size=4, num_classes=3, input_size=16)
JCFG = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(4, 4), l1_size=16,
                        l2_size=8, l3_size=4, num_classes=3, input_size=16)
KEYS = ("acc", "f1", "precision", "recall")


@pytest.fixture(scope="module")
def engine():
    """The port's engine build (both tools)."""
    return {t: eb.compile_cpp_engine(t) for t in ("nnue", "etinynet")}


@pytest.fixture(scope="module")
def model_and_data():
    params = jax.device_get(jnnue.nnue_init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    images = rng.random((8, 16, 16, 3), dtype=np.float32)
    labels = rng.integers(0, 3, 8).astype(np.int64)
    model = bridge.nnue_from_jax_params(params, TCFG, device="cpu")
    return params, model, [(images, labels)]


def test_build_goes_to_the_port_directory(engine):
    for tool, exe in engine.items():
        assert exe == eb.BUILD_DIR / eb.TOOLS[tool] and exe.is_file()
    assert eb.BUILD_DIR == REPO / "build" / "torch_engine"
    assert (REPO / "build" / "torch_engine.lock").is_file()
    with pytest.raises(ValueError):
        eb.tool_name("resnet")


def test_engine_executable_env_override(monkeypatch, tmp_path):
    fake = tmp_path / "my_engine"
    fake.write_text("")
    monkeypatch.setenv("NNUE_ENGINE_EXEC", str(fake))
    assert engine_executable("nnue") == fake
    monkeypatch.setenv("ETINY_ENGINE_EXEC", str(fake))
    assert engine_executable("etinynet") == fake
    monkeypatch.delenv("NNUE_ENGINE_EXEC")
    assert engine_executable("nnue") == eb.BUILD_DIR / "nnue_inference"
    with pytest.raises(ValueError):
        engine_executable("resnet")


def test_missing_engine_raises(model_and_data, monkeypatch, tmp_path):
    _, model, loader = model_and_data
    monkeypatch.setenv("NNUE_ENGINE_EXEC", str(tmp_path / "nope"))
    with pytest.raises(RuntimeError, match="engine not found"):
        evaluate_compiled_model(model, loader)


def test_engine_failure_persists_repro(model_and_data, monkeypatch, tmp_path):
    """A failing engine leaves the model, the images and repro.sh behind."""
    _, model, loader = model_and_data
    crasher = tmp_path / "crasher.sh"
    crasher.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    crasher.chmod(crasher.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("NNUE_ENGINE_EXEC", str(crasher))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="rc=3"):
        evaluate_compiled_model(model, loader)
    failures = list(Path("logs/compiled_eval_failures").iterdir())
    assert failures, "no repro directory persisted"
    contents = {p.name for p in failures[0].iterdir()}
    assert "repro.sh" in contents
    assert any(n.endswith(".nnue") for n in contents)
    assert any(n.endswith(".bin") for n in contents)
    assert str(crasher) in (failures[0] / "repro.sh").read_text()


def test_sim_and_engine_agree(model_and_data, engine):
    """The int8 sim's metrics and the engine's are equal (same logits)."""
    _, model, loader = model_and_data
    sim = evaluate_int8_sim(model, loader)
    compiled = evaluate_compiled_model(model, loader)
    for key in KEYS:
        assert sim[key] == compiled[key]
    assert sim["latent_density"] == pytest.approx(compiled["latent_density"],
                                                  abs=1e-7)
    assert compiled["ms_per_sample"] > 0
    both = evaluate_model_comprehensive(model, loader)
    assert both["compiled"]["metrics"]["f1"] == compiled["f1"]
    assert math.isfinite(both["float"]["loss"])


def test_compiled_metrics_equal_jax(model_and_data, engine):
    """The port's evaluate_compiled_model and the JAX package's, on the
    same params, images and engine binary, give the same metrics."""
    params, model, loader = model_and_data
    want = jevaluate.evaluate_compiled_model(
        params, None, loader, model_type="nnue", model_cfg=JCFG,
        executable=engine["nnue"])
    got = evaluate_compiled_model(model, loader)
    for key in KEYS + ("latent_density",):
        assert got[key] == want[key], key


def _logits_vs_sim(model, images, is_nnue):
    """(engine logits, sim logits as the engine prints them) on raw images
    [0, 1]."""
    labels = np.zeros(len(images), np.int64)
    got, _, densities, _ = engine_logits(model, [(images[:5], labels[:5]),
                                                 (images[5:], labels[5:])])
    x = normalize_images(torch.from_numpy(images))
    h = images.shape[1]
    if is_nnue:
        sim, cfg = tsim.nnue_sim_params(tnnue.nnue_quantize(model), device="cpu")
        want, _, count = tsim.nnue_engine_forward(sim, x, cfg=cfg, image_h=h,
                                                  image_w=h)
        np.testing.assert_allclose(densities, count.numpy() / cfg.num_features,
                                   atol=1e-7)
    else:
        sim, cfg = tsim.etiny_sim_params(tetiny.etinynet_quantize(model),
                                         device="cpu")
        want = tsim.etiny_engine_forward(sim, x, cfg=cfg, image_h=h, image_w=h)
        assert densities == []
    return got, as_engine_prints(want.numpy())


def test_engine_logits_equal_sim_nnue(engine):
    rng = np.random.default_rng(61)
    q = eb.random_quantized_nnue(rng, grid=8, ch=4, l1=64, l2=8, l3=8,
                                 num_classes=10, visual_threshold=2.0)
    model = tnnue.nnue_from_quantized(q, device="cpu")
    got, want = _logits_vs_sim(model, rng.random((9, 32, 32, 3), dtype=np.float32),
                               True)
    assert got.shape == (9, 10)
    np.testing.assert_array_equal(got, want)


def _etiny_0_98m(rng):
    """A 0.98M EtinyNet with random weights, norm affines and statistics."""
    model = tetiny.EtinyNet(tetiny.EtinyNetConfig(variant="0.98M", num_classes=10,
                                                  input_size=32), device="cpu")
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, t.shape)
        elif leaf in ("bias", "mean"):
            value = rng.uniform(-0.3, 0.3, t.shape)
        else:
            value = rng.uniform(-0.3, 0.3, t.shape)
        state[name] = torch.from_numpy(value.astype(np.float32))
    model.load_state_dict(state)
    return model.eval()


def test_engine_logits_equal_sim_etinynet_0_98m(engine):
    rng = np.random.default_rng(62)
    model = _etiny_0_98m(rng)
    got, want = _logits_vs_sim(model, rng.random((9, 32, 32, 3), dtype=np.float32),
                               False)
    assert got.shape == (9, 10) and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, want)


def test_engine_logits_equal_sim_engine_friendly(engine):
    _, tcfg = ef_cfgs()
    params, stats = ef_model(seed=12)
    model = bridge.etinynet_from_jax(params, stats, tcfg, device="cpu").eval()
    rng = np.random.default_rng(63)
    got, want = _logits_vs_sim(model, rng.random((9, 32, 32, 3), dtype=np.float32),
                               False)
    assert got.shape == (9, 10)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.delenv("NV_SKIP_ENGINE", raising=False)
    monkeypatch.delenv("NNUE_ENGINE_EXEC", raising=False)
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(REPO / "config" / "train_nnue_test.py"))
    cfg.log_dir = str(tmp_path / "logs")
    return cfg, tmp_path


def test_probe_runs_in_train_model(env, capsys):
    cfg, _ = env
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    out = capsys.readouterr().out
    assert "C++ engine ready" in out and "Engine OK" in out
    assert out.index("Engine OK") < out.index("Epoch 1/1")


def test_broken_engine_stops_the_run_before_any_step(env, monkeypatch):
    cfg, tmp_path = env
    monkeypatch.setenv("NNUE_ENGINE_EXEC", "/bin/false")
    steps = []
    monkeypatch.setattr(tloop, "gathered_train_step",
                        lambda *a, **k: steps.append(1))
    monkeypatch.setattr(tloop, "scanned_train_steps",
                        lambda *a, **k: steps.append(1))
    with pytest.raises(RuntimeError, match="engine failed"):
        tloop.train_model(cfg, "nnue", device="cpu")
    assert steps == []
    assert not (tmp_path / "logs" / "checkpoints").exists()


def test_sanitizer_build_and_smoke(env, monkeypatch, capsys):
    """NNUE_SANITIZER_SMOKE=1: the ASan+UBSan build (build/torch_engine_san/)
    and one image through it, for both tools, before the first step."""
    cfg, _ = env
    monkeypatch.setenv("NNUE_SANITIZER_SMOKE", "1")
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    eb.smoke_test_sanitizer_engine("etinynet")
    out = capsys.readouterr().out
    assert out.count("Sanitizer smoke test passed") == 2
    assert (eb.SANITIZER_BUILD_DIR / "etinynet_inference").is_file()
    assert eb.SANITIZER_BUILD_DIR.parent == eb.BUILD_DIR.parent


def _epoch_metrics(tmp_path):
    metrics = next((tmp_path / "runs").rglob("metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    return [r for r in records if "compiled/f1" in r]


def test_engine_backend_epoch_equals_sim_epoch(env, monkeypatch):
    """Two epochs with compiled_backend "engine" and two with "sim", same
    seed: the engine's compiled metrics equal the sim's each epoch; under
    NV_SKIP_ENGINE=1 "engine" runs the sim."""
    cfg, tmp_path = env
    cfg.max_epochs = 2
    out = {}
    for backend in ("engine", "sim"):
        cfg.compiled_backend = backend
        cfg.log_dir = str(tmp_path / backend)
        assert tloop.train_model(cfg, "nnue", device="cpu") == 0
        out[backend] = _epoch_metrics(tmp_path / backend)
    for got, want in zip(out["engine"], out["sim"], strict=True):
        for key in ("compiled/f1", "compiled/accuracy", "val/f1", "train/epoch_loss"):
            assert got[key] == want[key], key
        assert got["compiled/latent_density"] == pytest.approx(
            want["compiled/latent_density"], abs=1e-7)

    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.setattr(tloop, "evaluate_compiled_model", None)  # never called
    cfg.compiled_backend = "engine"
    cfg.log_dir = str(tmp_path / "skipped")
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    skipped = _epoch_metrics(tmp_path / "skipped")
    assert [r["compiled/f1"] for r in skipped] == [r["compiled/f1"] for r in out["sim"]]


def test_as_engine_prints_matches_the_tools_format():
    """`%.10f` and back: values of 2^-10 and more come back unchanged; 1/4096
    comes back 1 ulp off, as the engine's output parses."""
    x = np.array([1.25, -3.0009765625, 2.0 ** -10, 1 / 4096, 0.0], np.float32)
    got = as_engine_prints(x)
    np.testing.assert_array_equal(got[[0, 1, 2, 4]], x[[0, 1, 2, 4]])
    assert got[3] != x[3] and abs(got[3] - x[3]) <= np.spacing(x[3])
    assert got[3] == np.float32(float("%.10f" % (1 / 4096)))
