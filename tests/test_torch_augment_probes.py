"""The timing harness's scalar chain and the augmentation probes ported from
`scripts/` held to the JAX package on the CPU: `ops/timing.py`
`scalar_chained_best_ms` (the JAX harness's contract: each rep fed the
previous rep's leading element times 0, so a NaN carries on); the stages
of `profile_heavy_aug` (the composed and identity warps against JAX
`_warp` on the same maps; the hsv, cutout and shadow steps against JAX's
`_apply_*` helpers; the medium block, plain and K5's wrapper, against JAX
`photometric_block` in interpret mode, on the same draws and noise);
`profile_photometric_rng`'s tiers (plain chain and K5's wrapper equal on
the same draws and normals) and its warp against JAX `_warp`; and
`profile_batched_draws`' variants; and the three CLIs with `--device cpu`.
On a card, tests/test_torch_probes_gpu.py holds the kernels (K4, K5) in
these stages to the plain versions.

Tolerance: atol 2e-6 for the photometric steps and 1e-5 for fractional
warps (the JAX package's own bounds, as in tests/test_torch_photometric.py
and tests/test_torch_warp.py); exact where both sides run the port.
"""

import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as A
from nnue_vision_tpu.ops import photometric_kernel as jpk
from nnue_vision_tpu.ops import timing as jtiming
from nnue_vision_tpu_torch import (
    profile_batched_draws,
    profile_heavy_aug,
    profile_photometric_rng,
)
from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.ops.timing import scalar_chained_best_ms

PHOTO_TOL = dict(rtol=0, atol=2e-6)
WARP_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Run torch on one thread: the probes' CPU ops are tiny, and with the
    other test processes on the cores a thread pool only waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- probe 0: the scalar-chained harness -------------------------------------


def test_scalar_chain_feeds_each_rep_the_previous_lead_times_zero():
    data = torch.arange(6, dtype=torch.float32)
    bumps = []

    def fwd(d, bump):
        bumps.append(bump)
        return d * 2 + bump

    ms = scalar_chained_best_ms(fwd, data, reps=3, n_timing=2)
    assert ms > 0 and math.isfinite(ms)
    assert len(bumps) == 1 + 2 * 3  # a warm-up, then 2 timings of 3 reps
    assert all(b.shape == () and b.dtype == torch.float32 and float(b) == 0
               for b in bumps)
    # a NaN in the lead carries to the next rep's input, as in JAX
    seen = []

    def nan_once(d, bump):
        seen.append(float(bump))
        return d + (float("nan") if len(seen) == 1 else 0.0) + bump

    scalar_chained_best_ms(nan_once, data, reps=1, n_timing=1)
    assert math.isnan(seen[1])


def test_scalar_chain_times_what_the_jax_harness_times():
    """Both harnesses take the same fwd(data, bump) and give a finite ms per
    rep on the CPU (a host time: for the tests only)."""
    x = np.random.default_rng(0).random((64, 32), dtype=np.float32)
    jms = jtiming.scalar_chained_best_ms(lambda d, b: d * 2.0 + b,
                                         jnp.asarray(x), reps=4)
    tms = scalar_chained_best_ms(lambda d, b: d * 2.0 + b, torch.from_numpy(x),
                                 reps=4)
    assert jms > 0 and tms > 0


# -- probe 8: profile_heavy_aug ----------------------------------------------


@pytest.fixture
def heavy_setup():
    x = profile_heavy_aug.images(12, 32, 32, "cpu")
    d = profile_heavy_aug.draws(x, torch.Generator().manual_seed(3))
    return x, d, profile_heavy_aug.stages(x, d)


def test_heavy_aug_warps_equal_jax(heavy_setup):
    x, d, stages = heavy_setup
    m, v = d["mv"]
    want = A._warp(jnp.asarray(x.numpy()), (jnp.asarray(m.numpy()),
                                            jnp.asarray(v.numpy())))
    np.testing.assert_allclose(stages["composed_warp"]().numpy(), np.asarray(want),
                               **WARP_TOL)
    ident = A._warp(jnp.asarray(x.numpy()), A._mv_identity(12))
    np.testing.assert_allclose(stages["warp_identity"]().numpy(), np.asarray(ident),
                               **WARP_TOL)
    np.testing.assert_allclose(stages["warp_identity"]().numpy(), x.numpy(),
                               **WARP_TOL)


def test_heavy_aug_photometric_steps_equal_jax(heavy_setup):
    x, d, stages = heavy_setup
    fp, ip = d["photo"]
    theta = np.random.default_rng(4).uniform(0, 2 * np.pi, 12).astype(np.float32)
    fp[:, 16] = torch.from_numpy(np.asarray(jnp.cos(jnp.asarray(theta))))
    fp[:, 17] = torch.from_numpy(np.asarray(jnp.sin(jnp.asarray(theta))))
    fp[:, [3, 10, 15]] = 1.0  # hsv, cutout and shadow on for every image
    f, i, xj = fp.numpy(), ip.numpy(), jnp.asarray(x.numpy())

    def col(c):
        return jnp.asarray(f[:, c].reshape(-1, 1, 1, 1))

    on = jnp.ones((12, 1, 1, 1), bool)
    want = {
        "hsv_shift": A._apply_hsv(xj, on, col(4), col(5), col(6)),
        "cutout": A._apply_cutout(xj, on, *(jnp.asarray(i[:, k]) for k in range(4))),
        "shadow": A._apply_shadow(xj, on, jnp.asarray(theta.reshape(-1, 1, 1)),
                                  col(18)[:, :, :, 0], col(19)),
    }
    for name, ref in want.items():
        got = stages[name]().numpy()
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=name, **PHOTO_TOL)
        assert not np.array_equal(got, x.numpy()), name
    block = np.asarray(jpk.photometric_block(
        xj, jnp.asarray(d["noise"].numpy()), jnp.asarray(f), jnp.asarray(i),
        variant="medium", interpret=True))
    for name in ("medium_photometric_chain", "medium_photometric_k5"):
        np.testing.assert_allclose(stages[name]().numpy(), block, err_msg=name,
                                   **PHOTO_TOL)


def test_heavy_aug_tiers_equal_the_augment_path(heavy_setup):
    x, d, stages = heavy_setup
    torch.manual_seed(9)
    got = stages["full_heavy_tier"]()
    torch.manual_seed(9)
    assert torch.equal(got, aug.apply_draws(x, d["tier"]["heavy"], None))
    assert torch.equal(stages["noop"](), x)


def test_heavy_aug_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_heavy_aug, "run",
                        functools.partial(profile_heavy_aug.run, batch=8, reps=1))
    assert profile_heavy_aug.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 8 and out["card"] is None
    jax_stages = ("noop", "full_light_tier", "full_medium_tier", "full_heavy_tier",
                  "composed_warp", "warp_identity", "brightness_contrast",
                  "hsv_shift", "blur", "gauss_noise", "cutout", "shadow", "fog",
                  "posterize", "equalize_approx", "medium_photometric_chain",
                  "normal_draw")
    for name in jax_stages + ("medium_photometric_k5",):
        assert out[name + "_ms"] > 0 and out[name + "_images_per_sec"] > 0, name
    assert out["elementwise_bound_ms"] > 0


# -- probe 9: profile_photometric_rng ----------------------------------------


def _rng_draws(b=8):
    gen = torch.Generator().manual_seed(1)
    return {s: aug.draw_tier(gen, s, b, 32, 32, "cpu") for s in ("medium", "heavy")}


@pytest.mark.parametrize("strength", ["medium", "heavy"])
def test_photometric_rng_tier_variants_agree(strength):
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    fns = profile_photometric_rng.tier_fns(_rng_draws())
    bump = torch.zeros(())
    torch.manual_seed(5)
    got = fns[f"tier_{strength}_pallas"](x, bump)
    torch.manual_seed(5)
    assert torch.equal(got, fns[f"tier_{strength}_xla"](x, bump))
    torch.manual_seed(5)
    assert torch.equal(got, aug.apply_tier(x, _rng_draws()[strength], None))


def test_photometric_rng_warp_equals_jax():
    gen = torch.Generator().manual_seed(6)
    mv = aug.draw_medium_geometry(gen, 8, 32, 32)
    x = torch.rand((8, 32, 32, 3), generator=gen)
    fns = profile_photometric_rng.split_fns(_rng_draws(),
                                            aug._warp_params(mv, 32, 32))
    want = A._warp(jnp.asarray(x.numpy()), tuple(jnp.asarray(t.numpy()) for t in mv))
    np.testing.assert_allclose(fns["one_warp"](x, torch.zeros(())).numpy(),
                               np.asarray(want), **WARP_TOL)


def test_photometric_rng_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_photometric_rng, "run",
                        functools.partial(profile_photometric_rng.run, batch=8, reps=1))
    assert profile_photometric_rng.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    for key in ("tier_medium_xla_ms", "tier_medium_pallas_ms", "tier_heavy_xla_ms",
                "tier_heavy_pallas_ms", "full_size_normals_ms", "one_warp_ms",
                "medium_block_plain_ms", "medium_block_k5_ms", "host_draws_ms",
                "device_normals_ms"):
        assert out[key] > 0, key
    assert out["card"] is None


# -- probe 10: profile_batched_draws -----------------------------------------


def test_batched_draw_variants():
    gen = torch.Generator().manual_seed(0)
    noise_gen = aug.device_generator(gen, "cpu")
    v = profile_batched_draws.variants(8, 32, 32, gen, noise_gen, "cpu")
    assert list(v) == ["current", "batched_smalls", "fully_batched",
                       "bf16_normals", "no_normals"]
    heavy = v["current"][0]()
    assert heavy.dtype == torch.int32
    assert heavy.numel() == aug.packed_size(aug.draw_specs("heavy", 8))
    assert v["batched_smalls"][0]().shape == (profile_batched_draws.SMALL_DRAWS, 8)
    assert v["current"][1]().shape == (8, 32, 32, 3)
    assert v["fully_batched"][1]().shape == (2, 8, 32, 32, 3)
    assert v["bf16_normals"][1]().dtype == torch.bfloat16
    assert v["no_normals"][1] is None


def test_batched_draws_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_batched_draws, "run",
                        functools.partial(profile_batched_draws.run, batch=8, reps=1))
    assert profile_batched_draws.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    for name in ("current", "batched_smalls", "fully_batched", "bf16_normals",
                 "no_normals"):
        assert out[name + "_ms"] > 0 and out[name + "_host_ms"] > 0, name
    assert out["no_normals_device_ms"] is None and out["current_device_ms"] > 0
    assert out["augment_batch_heavy_ms"] > 0 and out["card"] is None
