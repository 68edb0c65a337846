"""The training probes ported from `scripts/` held to the JAX scripts and the
JAX package on the CPU: `profile_train_roofline` (its analytic counts, equal
to the JAX script's own expressions, run from its source; the forward,
grad and full slices' loss and gradients against `nnue_apply` + optax's
cross-entropy), `profile_scaled_train` (`fwd_flops_per_image` and the
parameter count), `profile_etiny_roofline` (the activation-traffic count),
`profile_train_sweep` and `profile_etiny_train`; and each CLI with
`--device cpu`, printing one JSON line with the JAX script's stage keys.
The probes' CUDA graphs are captured on a card by
tests/test_torch_probes_gpu.py.

Setup: `GridFeatureSet(4, 6)`, L1 16, 12×12 images (the slices), numpy
params carried to the port by `bridge.nnue_from_jax_params`, augmentation
off (light draws with every gate off), images whose every conv output lies
1e-3 or more from the threshold after normalizing (so summation order can
not flip a feature). Tolerance: the analytic counts exact; loss and
gradients rtol 1e-5, atol 1e-6.
"""

import ast
import copy
import dataclasses
import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnue_vision_tpu.data.augment import normalize_images as jnormalize
from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu_torch import (
    bridge,
    profile_etiny_roofline,
    profile_etiny_train,
    profile_scaled_train,
    profile_train_roofline,
    profile_train_sweep,
)
from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training.optim import create_optimizer
from tests.test_torch_model import _cfgs, _conv_margins, _params

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
# the CLIs' models, cut in width (the 0.98M EtinyNet's CPU convs crawl
# when other processes hold the cores)
NNUE_SMALL = dataclasses.replace(_cfgs()[1], num_classes=10)
ETINY_SMALL = tetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=16)


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
    sys.path.insert(0, str(REPO))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO))
    return module


def _main_body(name):
    """The statements of `main` in `scripts/<name>.py`."""
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _run_statements(stmts, namespace):
    exec(compile(ast.Module(body=list(stmts), type_ignores=[]), "<jax probe>",
                 "exec"), namespace)
    return namespace


def _assigned(stmt):
    return {ast.unparse(t) for t in getattr(stmt, "targets", [])}


def _jax_roofline_stage_names():
    body = _main_body("profile_train_roofline")
    stages = next(s for s in body if _assigned(s) == {"stages"})
    return [e.elts[0].value for e in stages.value.elts]


@pytest.mark.parametrize("batch", [512, 37])
def test_roofline_analytic_equals_the_jax_script(batch):
    """The JAX script's analytic block, run from its source with its rates
    set to 1 and its rounding off, gives the numerators; the port's counts
    equal them."""
    body = _main_body("profile_train_roofline")
    start = next(i for i, s in enumerate(body) if _assigned(s) == {"oh", "ow"})
    stop = next(i for i, s in enumerate(body) if "out['analytic']" in _assigned(s))
    keep = [s for s in body[start:stop + 1]
            if not _assigned(s) & {"peak", "hbm"}]
    cfg = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(10, 8), l1_size=1024,
                           l2_size=128, l3_size=32, num_classes=10, input_size=32)
    ns = _run_statements(keep, {"cfg": cfg, "batch": batch, "out": {}, "peak": 1.0,
                                "hbm": 1.0, "round": lambda v, n=None: v})
    want = ns["out"]["analytic"]
    got = profile_train_roofline.analytic(profile_train_roofline.FLAGSHIP, batch)
    assert got["fwd_flops_per_image"] == want["fwd_flops_per_image"]
    assert got["train_flops_per_image"] == want["train_flops_per_image"]
    assert batch * got["fwd_flops_per_image"] * 1e3 == want["mxu_bound_ms_fwd"]
    assert batch * got["train_flops_per_image"] * 1e3 == want["mxu_bound_ms_train"]
    assert got["gather_bytes"] * 1e3 == want["hbm_bound_ms_gather"]
    assert got["augment_pass_bytes"] * 1e3 == want["hbm_bound_ms_augment_pass"]
    # the bounds at the card's rates
    assert got["mxu_bound_ms_train"] == pytest.approx(
        batch * got["train_flops_per_image"] / 67e12 * 1e3)
    assert got["hbm_bound_ms_gather"] == pytest.approx(
        got["gather_bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("widths", [
    dict(grid=10, ch=8, l1=1024, hw=32), dict(grid=20, ch=8, l1=4096, hw=77),
    dict(grid=4, ch=6, l1=16, hw=12)], ids=["flagship", "scaled", "small"])
def test_fwd_flops_per_image_equals_the_jax_script(widths):
    jax_probe = _script("profile_scaled_train")
    kw = dict(l1_size=widths["l1"], l2_size=128, l3_size=32, num_classes=10,
              input_size=widths["hw"])
    jcfg = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(widths["grid"],
                                                             widths["ch"]), **kw)
    tcfg = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(widths["grid"],
                                                             widths["ch"]), **kw)
    assert (profile_train_roofline.fwd_flops_per_image(tcfg)
            == jax_probe.fwd_flops_per_image(jcfg))
    assert profile_scaled_train.fwd_flops_per_image is \
        profile_train_roofline.fwd_flops_per_image


def test_etiny_activation_bytes_equal_the_jax_script():
    body = _main_body("profile_etiny_roofline")
    keep = [s for s in body if _assigned(s) & {"shapes", "fwd_bytes"}]
    for batch in (1024, 16):
        ns = _run_statements(keep, {"B": batch})
        assert profile_etiny_roofline.SHAPES == ns["shapes"]
        assert profile_etiny_roofline.activation_bytes(batch) == ns["fwd_bytes"]


# -- the roofline slices against nnue_apply + optax ---------------------------


def _identity_draws(steps, batch, device):
    """Light draws with every gate off: the tier is the identity."""
    buf = torch.zeros(aug.packed_size(aug.draw_specs("light", batch)),
                      dtype=torch.int32, device=device)
    return [aug.batch_draws(buf, "light", batch)] * steps


def _clear_data(p, tcfg, n=24, seed=3):
    """n raw images whose normalized conv outputs all clear the threshold
    by 1e-3, and labels."""
    rng = np.random.default_rng(seed)
    raw = rng.random((8 * n, 12, 12, 3), dtype=np.float32)
    normed = np.asarray(jnormalize(jnp.asarray(raw)))
    keep = raw[_conv_margins(p, normed, tcfg) > 1e-3][:n]
    assert len(keep) == n
    return keep, rng.integers(0, 3, n).astype(np.int64)


def _jax_loss(p, x, y, jcfg):
    logits = jnnue.nnue_apply(p, x, jcfg)
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


@pytest.mark.parametrize("kw", [dict(qat=False), dict(qat=True)],
                         ids=["float", "qat"])
def test_roofline_slices_equal_nnue_apply(kw):
    rng = np.random.default_rng(11)
    p = _params(rng)
    jcfg, tcfg = _cfgs(**kw)
    images, labels = _clear_data(p, tcfg)
    idx = np.array([[0, 5, 9, 13], [2, 3, 17, 20]])
    model = bridge.nnue_from_jax_params(p, tcfg, device="cpu")
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    draws = _identity_draws(2, 4, "cpu")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for k in range(2):
        i = torch.from_numpy(idx[k])
        x, y = profile_train_roofline.batch_input(ti, tl, i, draws[k])
        xj = jnormalize(jnp.asarray(images[idx[k]]))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
        loss, grads = profile_train_roofline.loss_and_grads(model, x, y)
        jloss, jgrads = jax.value_and_grad(_jax_loss)(jp, xj, jnp.asarray(labels[idx[k]]),
                                                      jcfg)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                       err_msg=name, **TOL)
    # the slices themselves: the first step of forward, grad and full
    opt = create_optimizer(profile_train_roofline.OPT,
                           profile_train_roofline.STEPS_PER_EPOCH)
    slices = profile_train_roofline.slices(
        lambda: bridge.nnue_from_jax_params(p, tcfg, device="cpu"), opt, ti, tl,
        torch.from_numpy(idx), draws)
    jloss0 = float(_jax_loss(jp, jnormalize(jnp.asarray(images[idx[0]])),
                             jnp.asarray(labels[idx[0]]), jcfg))
    for name in ("forward", "grad", "full"):
        np.testing.assert_allclose(float(slices[name]()), jloss0, err_msg=name,
                                   **TOL)
    gathered = float(ti[idx[0]].sum() + tl[idx[0]].sum())
    assert float(slices["gather"]()) == pytest.approx(gathered, rel=1e-6)
    assert float(slices["empty"]()) == idx[0, 0]
    assert float(slices["augment"]()) == pytest.approx(
        float(profile_train_roofline.batch_input(ti, tl, torch.from_numpy(idx[0]),
                                                 draws[0])[0].sum()), rel=1e-6)


def test_contiguous_slices_walk_one_permutation():
    """gather_contig: a chunk's steps take disjoint batches of one
    permutation of the dataset, made again at the chunk's first step."""
    _, tcfg = _cfgs()
    images = torch.zeros((40, 12, 12, 3))
    labels = torch.arange(40)
    draws = _identity_draws(3, 8, "cpu")
    opt = create_optimizer(profile_train_roofline.OPT, 1)
    fn = profile_train_roofline.slices(
        lambda: tnnue.nnue_init(tcfg, torch.Generator().manual_seed(0), "cpu"),
        opt, images, labels, torch.zeros((3, 8), dtype=torch.int64),
        draws)["gather_contig"]
    sums = [float(fn()) for _ in range(4)]
    steps = np.diff([0.0] + sums)
    assert len(set(steps[:3])) == 3 and steps[3] == steps[0]
    assert sum(range(24)) <= sums[2] <= sum(range(16, 40))


# -- the CLIs on the CPU ------------------------------------------------------


def _small_run(monkeypatch, module, **kw):
    """`module.run` with its depth (and widths) cut to `kw`, for `main`."""
    monkeypatch.setattr(module, "run", functools.partial(module.run, **kw))


def test_roofline_cli_on_cpu(capsys, monkeypatch):
    _small_run(monkeypatch, profile_train_roofline, spd=2, chunks=1, n_data=32,
               model_cfg=NNUE_SMALL)
    assert profile_train_roofline.main(["4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 4 and out["steps_per_dispatch"] == 2
    assert out["card"] is None
    for name in _jax_roofline_stage_names():
        for key in (name + "_ms_per_step", name + "_images_per_sec"):
            assert np.isfinite(out[key]) and out[key] > 0, key
    for name in ("full_unroll4", "full_unroll8", "forward_arg", "full_prod"):
        assert name in out["notes"]
    assert out["draw_upload_ms"] > 0
    assert out["analytic"]["peak_f32_flops"] == 67e12
    assert out["analytic"]["hbm_bytes_per_sec"] == 3.35e12


@pytest.mark.parametrize("fused", [False, True], ids=["light", "fused"])
def test_sweep_cli_on_cpu(capsys, monkeypatch, fused):
    _small_run(monkeypatch, profile_train_sweep, images=16, model_cfg=NNUE_SMALL)
    argv = ["4", "8", "--spd", "2", "--device", "cpu"]
    assert profile_train_sweep.main(argv + (["--fused"] if fused else [])) == 0
    out = json.loads(capsys.readouterr().out)
    assert [p["batch"] for p in out["points"]] == [4, 8]
    for p in out["points"]:
        assert p["fused"] is fused and p["steps_per_dispatch"] == 2
        assert p["strength"] == "light" and p["peak_gb"] is None
        assert p["images_per_sec"] > 0 and np.isfinite(p["final_loss"])
    assert out["saturating_batch"]["2"] in (4, 8)


def test_saturating_batch_is_the_first_within_five_percent():
    pts = [{"steps_per_dispatch": 8, "batch": b, "images_per_sec": r}
           for b, r in ((512, 50.0), (1024, 96.0), (2048, 100.0), (4096, 99.0))]
    assert profile_train_sweep.saturating_batch(pts) == {"8": 1024}


def test_scaled_cli_on_cpu(capsys):
    assert profile_scaled_train.main(["--batch", "2", "--spd", "1",
                                      "--dispatches", "1", "--n-data", "8",
                                      "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("MEASURED: ")
    out = json.loads(line[len("MEASURED: "):])
    assert out["config"] == "grid20x20x8_L1-4096_input77"
    assert out["train_mfu"] is None and out["card"] is None
    assert "float32" in out["mfu_peak"]
    jcfg = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(20, 8),
                            l1_size=4096, l2_size=128, l3_size=32, num_classes=10,
                            input_size=77)
    assert out["fwd_flops_per_image"] == _script(
        "profile_scaled_train").fwd_flops_per_image(jcfg)
    jparams = jax.eval_shape(lambda: jnnue.nnue_init(jax.random.PRNGKey(0), jcfg))
    assert out["params"] == sum(int(np.prod(v.shape))
                                for v in jax.tree_util.tree_leaves(jparams))
    assert out["train_images_per_sec"] > 0 and np.isfinite(out["final_loss"])


def test_scaled_run_refuses_a_conv_past_its_grid():
    cfg = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(5, 8), l1_size=16,
                           l2_size=8, l3_size=4, num_classes=10, input_size=12)
    with pytest.raises(ValueError, match="grid"):
        profile_scaled_train.run(2, 1, 1, 8, "cpu", cfg)


def test_etiny_roofline_cli_on_cpu(capsys, monkeypatch):
    _small_run(monkeypatch, profile_etiny_roofline, batch=4, steps=2, chunks=1,
               n_data=16, model_cfg=ETINY_SMALL)
    assert profile_etiny_roofline.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["variant"] == "micro" and out["batch"] == 4
    for name in ("floor", "forward", "fwd_bwd", "full", "full_prod"):
        assert out[name + "_ms_per_step"] > 0, name
    assert "full_prod" in out["notes"]
    assert out["fwd_activation_bytes"] == profile_etiny_roofline.activation_bytes(4)
    assert out["activation_bound_ms_per_step"] == pytest.approx(
        3 * out["fwd_activation_bytes"] / 3.35e12 * 1e3)


def test_etiny_roofline_full_is_the_loop_step():
    """The graph-timed `full` slice is the loop's step: its first loss is
    the first loss of `scanned_train_steps` with augment off on the same
    rows, and the next steps follow it."""
    from nnue_vision_tpu_torch.models.etinynet import etinynet_init
    from nnue_vision_tpu_torch.training.step import (
        make_train_state,
        scanned_train_steps,
    )

    cfg = ETINY_SMALL
    images, labels = profile_train_roofline.train_data(12, 16, 16, "cpu")
    idx = np.random.default_rng(0).integers(0, 12, (3, 4))
    base = etinynet_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    opt = create_optimizer(profile_train_roofline.OPT, 97)
    full = profile_etiny_roofline.slices(
        lambda: copy.deepcopy(base), opt, images, labels,
        torch.from_numpy(idx))["full"]
    got = torch.stack([full() for _ in range(3)])
    want = scanned_train_steps(make_train_state(copy.deepcopy(base), opt),
                               images, labels, idx, torch.Generator(),
                               optimizer=opt, augment=False)["loss"]
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_etiny_train_cli_on_cpu(capsys, monkeypatch):
    _small_run(monkeypatch, profile_etiny_train, batch=4, dispatches=1,
               model_cfg=ETINY_SMALL)
    assert profile_etiny_train.main(["2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    tiers = out["steps_per_dispatch"]["2"]
    assert list(tiers) == ["no-aug", "light", "medium", "heavy"]
    for label, r in tiers.items():
        assert r["images_per_sec"] > 0 and np.isfinite(r["final_loss"]), label
    assert "production_eager_ms_per_step" not in out


def test_etiny_probes_use_the_jax_scripts_model():
    """The 0.98M EtinyNet of both JAX scripts, widths and parameter count."""
    jcfg = jetiny.EtinyNetConfig(variant="0.98M", num_classes=10, input_size=32)
    params, _ = jax.eval_shape(lambda: jetiny.etinynet_init(jax.random.PRNGKey(3),
                                                            jcfg))
    cfg = profile_etiny_roofline.ETINY
    assert (cfg.variant, cfg.num_classes, cfg.input_size, cfg.dtype) == (
        jcfg.variant, jcfg.num_classes, jcfg.input_size, jcfg.dtype)
    from nnue_vision_tpu_torch.models.etinynet import etinynet_init

    model = etinynet_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    assert profile_etiny_train.TIERS[0] == ("no-aug", "heavy", False)
