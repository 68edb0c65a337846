"""The cut mega kernel's plain version (`nnue_mega_stage_reference`, the
oracle of K7) held exactly equal to the JAX probe's Pallas kernel
(`scripts/profile_mega_bisect.py` `make_stage_call`) run in interpret mode,
at every level, with a positive and a negative threshold; and the probe's
CLI on the CPU. The kernel itself runs only on a card:
`tests/test_torch_probes_gpu.py` holds it to this plain version.

Setup: `GridFeatureSet(5, 8)`, L1 128, 16×16 images (stride 4, FR 128 of
200 features: 72 padding features), batch 16 in JAX tiles of 8, normalized
inputs (so |trunc(x·64)| ≤ 256, where the JAX probe's bf16 cast is exact).
The weights cross over as the JAX package's record → `.nnue` bytes → the
port's `read_nnue` → `nnue_sim_params`. Tolerance: none.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nnue_vision_tpu import formats as jformats
from nnue_vision_tpu.data.augment import normalize_images as jnormalize
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops import pallas_kernels as jpk
from nnue_vision_tpu_torch import formats as tformats
from nnue_vision_tpu_torch import profile_mega_bisect
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from tests.conftest import random_quantized_nnue

REPO = Path(__file__).resolve().parent.parent
HW = 16
B = 16


@pytest.fixture
def jax_probe(monkeypatch):
    """scripts/profile_mega_bisect.py, with every pallas_call interpreted."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_profile_mega_bisect", REPO / "scripts" / "profile_mega_bisect.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(tmp_path, thresh, seed=31):
    rng = np.random.default_rng(seed)
    q = random_quantized_nnue(rng, grid=5, ch=8, l1=128, l2=16, l3=8,
                              num_classes=4, visual_threshold=thresh)
    jformats.write_nnue(q, tmp_path / "m.nnue")
    tp, tcfg = tsim.nnue_sim_params(tformats.read_nnue(tmp_path / "m.nnue"),
                                    device="cpu")
    jp, jcfg = jsim.nnue_sim_params(q)
    raw = rng.random((B, HW, HW, 3), dtype=np.float32)
    flat = np.array(jnormalize(jnp.asarray(raw))).reshape(B, -1)
    return (jpk.mega_head_params(jp, jcfg, HW, HW), jcfg,
            nk.mega_head_params(tp, tcfg, HW, HW), tcfg, flat)


@pytest.mark.parametrize("thresh", [0.07, -0.25], ids=["positive", "negative"])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_stage_plain_equals_jax_probe(tmp_path, jax_probe, level, thresh):
    jhead, jcfg, thead, tcfg, flat = _setup(tmp_path, thresh)
    kw = dict(cfg=tcfg, image_h=HW, image_w=HW)
    x = torch.from_numpy(flat)
    if level < 4:
        ref = jax_probe.make_stage_call(jhead, jcfg, level, tile_b=8)(
            jnp.asarray(flat), jnp.float32(0.0))
        got = nk.nnue_mega_stage_reference(thead, x, level=level, **kw)
        # the wrapper takes the plain version for a CPU tensor
        assert torch.equal(nk.nnue_mega_stage(thead, x, level=level, **kw), got)
    else:  # the probe's level 4: the shipped kernel, logits only
        ref = jpk.nnue_engine_forward_mega(
            jhead, jnp.asarray(flat), cfg=jcfg, image_h=HW, image_w=HW,
            tile_b=8, interpret=True, with_count=False)[0]
        got = nk.nnue_engine_forward_mega_reference(thead, x, with_count=False,
                                                    **kw)[0]
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(torch.unique(got)) > 2  # not a constant or a 0/1 pattern


def test_stage_wrapper_refuses_small_shapes():
    q = random_quantized_nnue(np.random.default_rng(5), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    head = nk.mega_head_params(tp, tcfg, 12, 12)  # FR 96, L1 16
    x = torch.zeros((2, 12 * 12 * 3))
    with pytest.raises(ValueError, match="FR"):
        nk.nnue_mega_stage(head, x, cfg=tcfg, image_h=12, image_w=12, level=0)
    with pytest.raises(ValueError, match="L1"):
        nk.nnue_mega_stage_reference(head, x, cfg=tcfg, image_h=12,
                                     image_w=12, level=2)


def test_stage_wrapper_refuses_a_bad_level(tmp_path):
    _, _, thead, tcfg, flat = _setup(tmp_path, 0.07)
    for level in (-1, 4):
        with pytest.raises(ValueError, match="level"):
            nk.nnue_mega_stage(thead, torch.from_numpy(flat), cfg=tcfg,
                               image_h=HW, image_w=HW, level=level)


def test_stage_wrapper_raises_off_cuda(tmp_path):
    """A tensor neither on the CPU nor on a card reaches the kernel wrapper
    and raises: nothing falls back to the plain version."""
    _, _, thead, tcfg, _ = _setup(tmp_path, 0.07)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nk.nnue_mega_stage(thead, torch.zeros((2, HW * HW * 3), device="meta"),
                           cfg=tcfg, image_h=HW, image_w=HW, level=1)


def test_probe_cli_on_cpu(capsys):
    assert profile_mega_bisect.main(
        ["--device", "cpu", "--batch", "2", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 2 and out["card"] is None and out["reps"] == 1
    assert 0 < out["active_features_per_image"] <= 800
    for name in profile_mega_bisect.VARIANTS:
        for key in (name + "_ms", name + "_images_per_sec", name + "_bound_ms"):
            assert np.isfinite(out[key]) and out[key] > 0, key
    assert "v4_full_buffergather_ms" not in out
    # at this batch the weights outweigh the images: each level's bound
    # grows with the weights it reads
    bounds = [out[name + "_bound_ms"] for name in profile_mega_bisect.VARIANTS]
    assert bounds[1] == bounds[0] and bounds[2] < bounds[3] < bounds[4]


def test_probe_inputs_are_in_the_bf16_window():
    data = profile_mega_bisect.input_buffers(3, "cpu")
    assert data.shape == (profile_mega_bisect.N_BUF, 3, 32 * 32 * 3)
    assert float(torch.trunc(data * 64).abs().max()) <= 256
