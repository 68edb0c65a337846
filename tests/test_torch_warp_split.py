"""The single warp passes and the warp-split probe on the CPU: the no-gather
pass's plain version (`nogather_pass_reference`, the oracle of K8) against
the JAX probe's Pallas kernel (`scripts/profile_warp_split.py`
`_nogather_pass`) run in interpret mode; the probe's five-stage composition
against `warp_bilinear`; and the probe's CLI. The kernels run only on a
card: `tests/test_torch_probes_gpu.py` holds them to these plain versions.

Tolerance: atol 1e-5 against JAX, K4's (the probe's kernel is jitted, and
XLA may contract k_row·r + k_lane·x + k_c into multiply-adds); exact
between the port's own plain versions.
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

from nnue_vision_tpu_torch import profile_warp_split
from nnue_vision_tpu_torch.data.augment import draw_heavy_geometry
from nnue_vision_tpu_torch.ops import warp_kernel as wk

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_probe(monkeypatch):
    """scripts/profile_warp_split.py, with every pallas_call interpreted."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_profile_warp_split", REPO / "scripts" / "profile_warp_split.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, b=64, rows=8, n=8, c=3):
    """Packed rows and coefficients whose positions fall in and out of
    [0, n): rows and lanes scaled and shifted past both ends."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, rows, n * c), dtype=np.float32)
    coef = np.stack([rng.uniform(-0.6, 0.6, b), rng.uniform(-1.4, 1.4, b),
                     rng.uniform(-6.0, 12.0, b)], 1).astype(np.float32)
    return x, coef


@pytest.mark.parametrize("seed", [0, 1])
def test_nogather_plain_matches_jax_probe(jax_probe, seed):
    x, coef = _inputs(seed)
    ref = np.asarray(jax_probe._nogather_pass(jnp.asarray(x), jnp.asarray(coef),
                                              n=8, c=3))
    got = wk.nogather_pass_reference(torch.from_numpy(x), torch.from_numpy(coef),
                                     n=8, c=3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # some outputs are zero-filled (both taps out of frame), some are not
    assert (ref == 0).any() and (ref != 0).any()
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(wk.nogather_pass(torch.from_numpy(x),
                                        torch.from_numpy(coef), n=8, c=3), got)


def test_nogather_at_integer_positions_is_the_input():
    """With positions on the grid (fr = 0) and in frame, the control reads
    back its own value, as the gathering pass reads back the identity."""
    x, _ = _inputs(3, b=4)
    coef = torch.tensor([[0.0, 1.0, 0.0]]).repeat(4, 1)
    t = torch.from_numpy(x)
    assert torch.equal(wk.nogather_pass(t, coef, n=8, c=3), t)
    assert torch.equal(wk.lerp_pass(t, coef, n=8, c=3), t)


def test_pass_wrappers_check_shapes_and_raise_off_cuda():
    x = torch.zeros((2, 4, 12))
    with pytest.raises(ValueError, match="x must be"):
        wk.lerp_pass(x, torch.zeros((2, 3)), n=5, c=3)
    with pytest.raises(ValueError, match="coef must be"):
        wk.nogather_pass(x, torch.zeros((3, 3)), n=4, c=3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wk.lerp_pass(x.to("meta"), torch.zeros((2, 3), device="meta"), n=4, c=3)


def test_five_stage_composition_equals_warp_bilinear():
    b, h = 16, 32
    x = torch.from_numpy(np.random.default_rng(4).random((b, h, h, 3),
                                                          dtype=np.float32))
    m, v = draw_heavy_geometry(torch.Generator().manual_seed(2), b, h, h)
    swap, coef1, coef2 = wk.warp_coefficients(m, v, h, h)
    assert swap.any()  # the swap blend is exercised
    params = wk.pack_warp_params(swap, coef1, coef2)
    assert torch.equal(profile_warp_split.five_stage_warp(x, swap, coef1, coef2),
                       wk.warp_bilinear(x, params))


def test_probe_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("WARP_SPLIT_REPS", "1")
    assert profile_warp_split.main(["--device", "cpu", "--batch", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 4 and out["card"] is None and out["reps"] == 1
    assert set(out["ms"]) == {"transpose", "swap_blend", "lerp_pass", "nogather",
                              "two_passes", "five_stages", "warp_kernel"}
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert np.isfinite(out["gather_ms"])
    assert out["bound_ms"] == pytest.approx(
        (2 * 4 * 32 * 32 * 3 + 2 * 4 * 3) * 4 / 3.35e12 * 1e3)


def test_probe_only_filter(monkeypatch):
    monkeypatch.setenv("WARP_SPLIT_REPS", "1")
    monkeypatch.setenv("WARP_SPLIT_ONLY", "pass")
    out = profile_warp_split.run(4, "cpu")
    assert set(out["ms"]) == {"lerp_pass", "two_passes"}
    assert out["gather_ms"] is None
