"""The port's incremental NNUE accumulator (`ops/engine_sim.py`
`nnue_feature_mask`, `nnue_accumulator_refresh`, `nnue_accumulator_update`,
`nnue_head_from_accumulator`) held exactly equal to the JAX package's on
the same params and masks (the JAX side as `tests/test_incremental.py`
runs it, on the CPU), and its composition to the port's full forward;
and the port's stream demo run end to end."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from tests.conftest import random_quantized_nnue

REPO = Path(__file__).resolve().parent.parent
# grid 4, 6 channels, L1 16: H 12 leaves 42 padding features, which a
# negative threshold activates; H 13 fills the grid exactly
CASES = [
    pytest.param(12, 0.07, id="n_pad42"),
    pytest.param(12, -0.25, id="n_pad42-negative-threshold"),
    pytest.param(13, 0.07, id="n_pad0"),
]


def _params(seed, **kw):
    q = random_quantized_nnue(np.random.default_rng(seed), grid=4, ch=6, l1=16,
                              l2=8, l3=4, num_classes=3, **kw)
    jp, jcfg = jsim.nnue_sim_params(q)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    return q, (jp, jcfg), (tp, tcfg)


def _images(rng, b, h):
    return (rng.random((b, h, h, 3), dtype=np.float32) * 2 - 0.5).astype(np.float32)


def _masks(rng, b, f, p=0.3):
    return (rng.random((b, f)) < p).astype(np.float32)


def test_refresh_equals_jax():
    q, (jp, _), (tp, _) = _params(1)
    m = _masks(np.random.default_rng(2), 5, q.num_features)
    got = tsim.nnue_accumulator_refresh(tp, torch.from_numpy(m))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsim.nnue_accumulator_refresh(jp, jnp.asarray(m))))


@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bool])
def test_update_chain_equals_jax_and_refresh(mask_dtype):
    """A stream of frames with random feature flips: every step's port
    accumulator equals JAX's, and the chain ends equal to a refresh."""
    rng = np.random.default_rng(3)
    q, (jp, _), (tp, _) = _params(3)
    masks = _masks(rng, 3, q.num_features)
    j_acc = jsim.nnue_accumulator_refresh(jp, jnp.asarray(masks))
    t_acc = tsim.nnue_accumulator_refresh(tp, torch.from_numpy(masks).to(mask_dtype))
    for _ in range(6):
        flips = rng.random(masks.shape) < 0.05
        new = np.where(flips, 1.0 - masks, masks).astype(np.float32)
        j_acc = jsim.nnue_accumulator_update(jp, j_acc, jnp.asarray(new),
                                             jnp.asarray(masks))
        t_acc = tsim.nnue_accumulator_update(
            tp, t_acc, torch.from_numpy(new).to(mask_dtype),
            torch.from_numpy(masks).to(mask_dtype))
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
        masks = new
    np.testing.assert_array_equal(
        t_acc.numpy(),
        tsim.nnue_accumulator_refresh(tp, torch.from_numpy(masks)).numpy())


def test_update_carries_the_value_before_the_wrap():
    """With FT rows past int16's range the accumulator leaves [-32768,
    32767]: the update must not wrap, or a chain stops equalling a refresh
    whose head wraps once."""
    rng = np.random.default_rng(4)
    q, _, (tp, tcfg) = _params(4)
    tp = dict(tp, ft_w=torch.from_numpy(
        rng.integers(-30000, 30000, (q.num_features, q.l1)).astype(np.int16)))
    masks = _masks(rng, 4, q.num_features, p=0.5)
    acc = tsim.nnue_accumulator_refresh(tp, torch.from_numpy(masks))
    assert int(acc.abs().max()) > 32767
    new = np.where(rng.random(masks.shape) < 0.2, 1.0 - masks, masks)
    new = new.astype(np.float32)
    acc = tsim.nnue_accumulator_update(tp, acc, torch.from_numpy(new),
                                       torch.from_numpy(masks))
    ref = tsim.nnue_accumulator_refresh(tp, torch.from_numpy(new))
    np.testing.assert_array_equal(acc.numpy(), ref.numpy())
    assert torch.equal(tsim.nnue_head_from_accumulator(tp, acc, cfg=tcfg),
                       tsim.nnue_head_from_accumulator(tp, ref, cfg=tcfg))


@pytest.mark.parametrize("spread", [2000, 70000], ids=["in-range", "wrapping"])
def test_head_equals_jax(spread):
    q, (jp, jcfg), (tp, tcfg) = _params(5)
    acc = np.random.default_rng(6).integers(-spread, spread, (9, q.l1)
                                            ).astype(np.int32)
    got = tsim.nnue_head_from_accumulator(tp, torch.from_numpy(acc), cfg=tcfg)
    ref = jsim.nnue_head_from_accumulator(jp, jnp.asarray(acc), cfg=jcfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h,thresh", CASES)
def test_feature_mask_equals_jax_and_counts(h, thresh):
    q, (jp, jcfg), (tp, tcfg) = _params(7, visual_threshold=thresh)
    imgs = _images(np.random.default_rng(8), 6, h)
    got = tsim.nnue_feature_mask(tp, torch.from_numpy(imgs), cfg=tcfg,
                                 image_h=h, image_w=h)
    ref = jsim.nnue_feature_mask(jp, jnp.asarray(imgs), cfg=jcfg, image_h=h,
                                 image_w=h)
    assert got.shape == (6, q.num_features) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, _, count = tsim.nnue_engine_forward(tp, torch.from_numpy(imgs), cfg=tcfg,
                                           image_h=h, image_w=h)
    np.testing.assert_array_equal(got.sum(1).to(torch.int32).numpy(),
                                  count.numpy())


@pytest.mark.parametrize("h,thresh", CASES)
def test_mask_head_composition_equals_forward(h, thresh):
    """mask → refresh → head == the port's full engine forward, and the
    JAX package's composition on the same images."""
    _, (jp, jcfg), (tp, tcfg) = _params(9, visual_threshold=thresh)
    imgs = _images(np.random.default_rng(10), 5, h)
    x = torch.from_numpy(imgs)
    mask = tsim.nnue_feature_mask(tp, x, cfg=tcfg, image_h=h, image_w=h)
    acc = tsim.nnue_accumulator_refresh(tp, mask)
    logits = tsim.nnue_head_from_accumulator(tp, acc, cfg=tcfg)
    ref, _, _ = tsim.nnue_engine_forward(tp, x, cfg=tcfg, image_h=h, image_w=h)
    assert torch.equal(logits, ref)
    jm = jsim.nnue_feature_mask(jp, jnp.asarray(imgs), cfg=jcfg, image_h=h,
                                image_w=h)
    jl = jsim.nnue_head_from_accumulator(
        jp, jsim.nnue_accumulator_refresh(jp, jm), cfg=jcfg)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))


def test_stream_demo_exits_zero():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "nnue_vision_tpu_torch.stream_inference_demo",
         "--frames", "4", "--batch", "8", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "3 frames × 8 streams, 0 mismatches" in proc.stdout
    assert "incremental" in proc.stdout


def test_stream_demo_pan_matches_the_jax_script():
    """The port's frames are the JAX script's: default_rng(0) scenes, the
    8×8 patch at (3t mod 24, t mod 24)."""
    from nnue_vision_tpu_torch.stream_inference_demo import pan_frames

    frames = pan_frames(5, 3)
    scenes = np.random.default_rng(0).random((3, 32, 32, 3), dtype=np.float32) * 0.4
    for t in range(5):
        f = scenes.copy()
        f[:, (t * 3) % 24:(t * 3) % 24 + 8, t % 24:t % 24 + 8, :] += 0.6
        np.testing.assert_array_equal(frames[t], np.clip(f, 0.0, 1.0))
