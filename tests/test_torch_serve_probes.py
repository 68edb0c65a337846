"""The serve-side probes ported from `scripts/` held to the JAX package on the
CPU: `profile_nnue_split` (its conv stages against `_int_conv3x3`, exact and
with bf16 feeds, and the flag `bf16_conv_exact`; `head_pallas` against
`_fused_head_call`; the fused, mega and plain paths against
`nnue_engine_forward_fused`, `nnue_engine_forward_mega` and
`nnue_engine_forward`, f32 and bf16 conv), and `profile_etiny_pallas` (the
K6 path and the sim against `etiny_engine_forward`); and both CLIs with
`--device cpu`. The stage builders run on CPU tensors, so each kernel
wrapper takes its plain version; the kernels themselves are held to these
on a card by tests/test_torch_probes_gpu.py.

Setup: `GridFeatureSet(5, 8)`, L1 128, 16×16 images (stride 4, FR 128 of
200 features), batch 16 in JAX tiles of 8, Pallas in interpret mode; a
micro-width random int EtinyNet (stride-2 LB, stride-1 LB, stride-1
dense) at 32×32. The weights cross over as the
JAX package's record → `.nnue`/`.etiny` bytes → the port's reader.
Tolerance: none.
"""

import functools
import importlib
import importlib.util
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu import formats as jformats
from nnue_vision_tpu.data.augment import normalize_images as jnormalize
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops import pallas_kernels as jpk
from nnue_vision_tpu_torch import formats as tformats
from nnue_vision_tpu_torch import profile_etiny_pallas, profile_nnue_split
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops import timing
from tests.conftest import random_quantized_nnue
from tests.test_torch_etiny_sim import _random_etiny

REPO = Path(__file__).resolve().parent.parent
HW = 16
B = 16


@pytest.fixture(autouse=True)
def _one_thread():
    """Run torch on one thread: the probes' CPU ops are tiny, and with the
    other test processes on the cores a thread pool only waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """`scripts/<name>.py` loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nnue(tmp_path, thresh=0.07, seed=31, scale=1.0):
    """(port sim, port cfg, JAX sim, JAX cfg, normalized images × scale as
    numpy (B, HW, HW, 3))."""
    rng = np.random.default_rng(seed)
    q = random_quantized_nnue(rng, grid=5, ch=8, l1=128, l2=16, l3=8,
                              num_classes=4, visual_threshold=thresh)
    jformats.write_nnue(q, tmp_path / "m.nnue")
    tp, tcfg = tsim.nnue_sim_params(tformats.read_nnue(tmp_path / "m.nnue"),
                                    device="cpu")
    jp, jcfg = jsim.nnue_sim_params(q)
    raw = rng.random((B, HW, HW, 3), dtype=np.float32)
    x = np.array(jnormalize(jnp.asarray(raw))) * np.float32(scale)
    return tp, tcfg, jp, jcfg, x


def _jax_conv(jp, jcfg, x, bf16=False):
    stride = jsim.engine_conv_stride(HW, jcfg.grid_size)
    qin = jsim._quantize_input(jnp.asarray(x), jcfg.conv_scale)
    return np.asarray(jsim._int_conv3x3(qin, jp["conv_w"], jp["conv_b"], stride,
                                        bf16=bf16))


def test_conv_f32_equals_jax(tmp_path):
    tp, tcfg, jp, jcfg, x = _nnue(tmp_path)
    got = profile_nnue_split.conv_f32(tp, torch.from_numpy(x), tcfg)
    want = _jax_conv(jp, jcfg, x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("scale,exact", [(1.0, True), (4.0, False)],
                         ids=["in-window", "past-256"])
def test_bf16_conv_exact_equals_jax(tmp_path, scale, exact):
    """The flag as both probes compute it (the bf16-fed conv equal to the
    exact one) agrees on the same data, and so do the bf16 sums."""
    tp, tcfg, jp, jcfg, x = _nnue(tmp_path, scale=scale)
    xt = torch.from_numpy(x)
    got16 = profile_nnue_split.conv_bf16(tp, xt, tcfg)
    port_flag = torch.equal(profile_nnue_split.conv_f32(tp, xt, tcfg), got16)
    want16 = _jax_conv(jp, jcfg, x, bf16=True)
    jax_flag = bool(np.array_equal(_jax_conv(jp, jcfg, x), want16))
    assert port_flag == jax_flag == exact
    np.testing.assert_array_equal(got16.numpy(), want16.astype(np.float32))


@pytest.mark.parametrize("thresh", [0.07, -0.25], ids=["positive", "negative"])
def test_head_pallas_equals_jax_fused_head_call(tmp_path, thresh):
    tp, tcfg, jp, jcfg, x = _nnue(tmp_path, thresh)
    acc = profile_nnue_split._acc_i32(
        profile_nnue_split.conv_f32(tp, torch.from_numpy(x), tcfg))
    fr = acc.shape[1]
    head = nk.pallas_head_params(tp)
    logits, count = nk.fused_head_call(head, acc, cfg=tcfg,
                                       n_pad=tcfg.num_features - fr,
                                       conv_scale=tcfg.conv_scale)
    jl, jc = jpk._fused_head_call(
        jpk.pallas_head_params(jp), jnp.asarray(acc.numpy(), jnp.float32),
        cfg=jcfg, fr=fr, n_pad=tcfg.num_features - fr,
        conv_scale=jcfg.conv_scale, tile_b=8, interpret=True)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    assert torch.equal(profile_nnue_split.head_on(head, acc, tcfg), logits)
    assert nk.fused_head_call(head, acc, cfg=tcfg, n_pad=tcfg.num_features - fr,
                              conv_scale=tcfg.conv_scale, with_count=False)[1] is None


@pytest.mark.parametrize("thresh", [0.07, -0.25], ids=["positive", "negative"])
def test_serve_stages_equal_jax(tmp_path, thresh):
    """Each stage that ends in logits equals the JAX path it ports."""
    tp, tcfg, jp, jcfg, x = _nnue(tmp_path, thresh)
    jhead, jmega = jpk.pallas_head_params(jp), jpk.mega_head_params(jp, jcfg, HW, HW)
    xj = jnp.asarray(x)
    kw = dict(cfg=jcfg, image_h=HW, image_w=HW)
    want = {
        "xla_full": jsim.nnue_engine_forward(jp, xj, **kw)[0],
        "xla_full_bf16conv": jsim.nnue_engine_forward(jp, xj, conv_mode="bf16",
                                                      **kw)[0],
        "pallas_full": jpk.nnue_engine_forward_fused(jp, jhead, xj, tile_b=8,
                                                     interpret=True, **kw)[0],
        "pallas_full_bf16conv": jpk.nnue_engine_forward_fused(
            jp, jhead, xj, tile_b=8, interpret=True, conv_mode="bf16", **kw)[0],
        "pallas_serve_bf16conv": jpk.nnue_engine_forward_fused(
            jp, jhead, xj, tile_b=8, interpret=True, conv_mode="bf16",
            with_count=False, **kw)[0],
        "mega_full": jpk.nnue_engine_forward_mega(
            jmega, xj.reshape(B, -1), tile_b=8, interpret=True, **kw)[0],
        "mega_serve": jpk.nnue_engine_forward_mega(
            jmega, xj.reshape(B, -1), tile_b=8, interpret=True,
            with_count=False, **kw)[0],
    }
    data = torch.from_numpy(x)[None]
    stages = profile_nnue_split.stages(tp, tcfg, nk.pallas_head_params(tp),
                                       nk.mega_head_params(tp, tcfg, HW, HW), data)
    assert set(stages) == set(profile_nnue_split.STAGES)
    for name, ref in want.items():
        got = stages[name]()
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)
    assert len(torch.unique(stages["mega_full"]())) > 2


def test_stage_bounds_count_each_stage(tmp_path, monkeypatch):
    tp, tcfg, _, _, x = _nnue(tmp_path)
    bounds = profile_nnue_split.stage_bounds(tp, tcfg, torch.from_numpy(x), 50.0)
    assert set(bounds) == set(profile_nnue_split.STAGES)
    assert all(ms > 0 and by in ("bytes", "operations")
               for ms, by in bounds.values())
    # the serve rows write no counts; the head alone reads no image
    assert bounds["mega_serve"][0] <= bounds["mega_full"][0]
    assert bounds["head_pallas"][0] < bounds["xla_full"][0]
    # with the bytes free, the bf16 conv's products count at the bf16 rate
    monkeypatch.setattr(timing, "HBM_BYTES_PER_S", math.inf)
    ops = profile_nnue_split.stage_bounds(tp, tcfg, torch.from_numpy(x), 50.0)
    assert ops["conv_bf16"][1] == ops["conv_f32"][1] == "operations"
    assert ops["conv_bf16"][0] == pytest.approx(
        ops["conv_f32"][0] * timing.INT8_OPS_PER_S / timing.BF16_FLOPS_PER_S)


def test_nnue_split_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_nnue_split, "run",
                        functools.partial(profile_nnue_split.run, reps=1))
    assert profile_nnue_split.main(["4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 4 and out["card"] is None and out["mega_tile"] is None
    assert out["mega_exact"] is True and out["bf16_conv_exact"] is True
    assert 0 < out["active_features_per_image"] <= 800
    for name in profile_nnue_split.STAGES:
        for key in ("_ms", "_images_per_sec", "_bound_ms"):
            assert np.isfinite(out[name + key]) and out[name + key] > 0, name + key
    # the JAX probe's tile sweeps have no counterpart, and say so
    assert not any("tile" in k and k.endswith("_ms") for k in out)
    assert {"mega_serve_tile", "pallas_tile"} <= set(out["notes"])


def _etiny(tmp_path, seed=5):
    rng = np.random.default_rng(seed)
    q = _random_etiny(rng)
    jformats.write_etiny(q, tmp_path / "m.etiny")
    sim, cfg = tsim.etiny_sim_params(tformats.read_etiny(tmp_path / "m.etiny"),
                                     device="cpu")
    jp, jcfg = jsim.etiny_sim_params(q)
    return ek.etiny_kernel_params(sim, cfg), cfg, jp, jcfg, rng


def test_etiny_paths_equal_jax(tmp_path):
    kp, cfg, jp, jcfg, rng = _etiny(tmp_path)
    x = rng.standard_normal((2, 6, 32, 32, 3)).astype(np.float32)
    paths = profile_etiny_pallas.paths(kp, cfg, torch.from_numpy(x))
    for buf in x:  # the calls cycle through the buffers
        want = np.asarray(jsim.etiny_engine_forward(
            jp, jnp.asarray(buf), cfg=jcfg, image_h=32, image_w=32))
        np.testing.assert_array_equal(paths["pallas"]().numpy(), want)
        np.testing.assert_array_equal(paths["xla"]().numpy(), want)
    shapes = profile_etiny_pallas.block_shapes(kp, cfg, torch.from_numpy(x[0]))
    assert [s[0] for s in shapes] == [6] * len(cfg.blocks)
    assert profile_etiny_pallas.k6_bound(kp, shapes)[0] > 0


def test_etiny_pallas_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_etiny_pallas, "run",
                        functools.partial(profile_etiny_pallas.run, reps=1))
    assert profile_etiny_pallas.main(["4", "micro", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["variant"] == "micro" and out["batch"] == 4
    assert out["bit_exact"] is True and out["card"] is None
    assert out["k6_tiles"] is None and "rows_target" in out["note"]
    for key in ("xla_images_per_sec", "xla_ms_per_batch", "pallas_images_per_sec",
                "pallas_ms_per_batch", "k6_blocks_bound_ms"):
        assert np.isfinite(out[key]) and out[key] > 0, key


def test_nnue_split_script_stages_are_ported():
    """Every stage key of the JAX probe has a port row or a note."""
    src = (REPO / "scripts" / "profile_nnue_split.py").read_text()
    for name in profile_nnue_split.STAGES:
        assert f'"{name}"' in src, name
    _script("profile_nnue_split")  # the JAX probe still imports


@pytest.mark.parametrize("name", [
    "profile_nnue_split", "profile_etiny_pallas", "profile_train_roofline",
    "profile_train_sweep", "profile_scaled_train", "profile_etiny_roofline",
    "profile_etiny_train", "profile_heavy_aug", "profile_photometric_rng",
    "profile_batched_draws"])
def test_probe_runs_on_the_card_by_default(name):
    """With no --device a probe asks for the card, and raises where there
    is none: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    module = importlib.import_module(f"nnue_vision_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
