"""Data and tensor parallelism of the port (`nnue_vision_tpu_torch/parallel/`)
held against the JAX package's mesh (8 virtual CPU devices, conftest) and
against the port's own one-process step.

Two and four gloo ranks run as spawned processes (a join limit of 60 s, a
file:// rendezvous under the test's tmp dir, one thread each). Every rank
computes the scenarios below on the same numpy-made inputs and writes its
results; the tests read them here. `jax` is imported inside the tests
only, so the spawned workers never import it.

Tolerances. Against JAX, the bar of `test_torch_train.py` (NNUE: loss rtol
1e-5, params atol 1e-5) and of `test_torch_etinynet.py` (EtinyNet: loss
rtol 1e-5, norm statistics atol 1e-5, a gradient, here the first SGD
step's update over the LR, atol 1e-4 times max(1, its largest
magnitude)). Against the port's one process: a dp step sums each half
batch and then the halves, so it is not bitwise the one-process sum; loss
rtol 1e-6 and params atol 1e-6 for the NNUE, and for the EtinyNet, whose
gradients run through a dozen norms reduced in that other order, its bar
against JAX. The int8 paths are compared exactly. The NNUE inputs keep
every conv output 1e-3 away from the threshold, so summation order flips
no feature.
"""

import math
import os
import pickle
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.nn import functional as F

from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data.augment import device_generator, normalize_images
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
from nnue_vision_tpu_torch.parallel import distributed as tdist
from nnue_vision_tpu_torch.parallel import mesh as tmesh
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training import step as tstep
from nnue_vision_tpu_torch.training.evaluate import evaluate_int8_sim
from nnue_vision_tpu_torch.training.optim import create_optimizer

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 60.0
GRID, CH, H = 4, 4, 16
L1, L2, L3, NC = 16, 8, 4, 3
B = 16          # global batch of the NNUE steps
N_DATA, K = 64, 3  # the fused chunk's dataset and steps
EB, EH = 8, 32  # the EtinyNet steps' global batch and image side
OPT = types.SimpleNamespace(
    learning_rate=0.05, weight_decay=2e-4, momentum=0.9, optimizer_type="sgd",
    max_grad_norm=1.0, use_cosine_scheduler=False, max_epochs=1, decay_lr=False,
    use_cyclical_lr=False)
# the EtinyNet against JAX: no clip or decay, so an update is -lr·gradient
EOPT = types.SimpleNamespace(**{**vars(OPT), "weight_decay": 0.0,
                                "max_grad_norm": 0.0, "momentum": 0.0})
NNUE_STEPS_CFG = str(REPO / "config" / "train_nnue_test.py")
ETINY_CFG = str(REPO / "config" / "train_etinynet_test.py")


# ---------------------------------------------------------------------------
# inputs, made from numpy seeds (the same in every process)
# ---------------------------------------------------------------------------


def _nnue_cfg(qat=False):
    return tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(GRID, CH),
                            l1_size=L1, l2_size=L2, l3_size=L3, num_classes=NC,
                            input_size=H, qat=qat)


def _nnue_params(rng):
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    f = GRID * GRID * CH
    return {
        "conv_w": u((CH, 3, 3, 3), 27),
        "visual_threshold": np.asarray([0.1, 0.14, 0.06, 0.1], np.float32),
        "ft_w": (rng.standard_normal((f, L1)) * 0.1).astype(np.float32),
        "ft_b": (rng.standard_normal(L1) * 0.05).astype(np.float32),
        "fc1_w": u((L2, L1), L1), "fc1_b": u((L2,), L1),
        "fc2_w": u((L3, L2), L2), "fc2_b": u((L3,), L2),
        "out_w": u((NC, L3), L3), "out_b": u((NC,), L3),
        "nnue2score": np.float32(600.0),
    }


def _clear_raw(rng, p, n, margin=1e-3):
    """n raw [0, 1] images whose normalized conv outputs all lie `margin`
    or more from the threshold, float and QAT (the mean threshold and the
    rounded weights) alike."""
    raw = rng.random((8 * n, H, H, 3), dtype=np.float32)
    x = normalize_images(torch.from_numpy(raw)).double().permute(0, 3, 1, 2)
    gap = np.inf
    for qat in (False, True):
        w = p["conv_w"].astype(np.float64)
        t = p["visual_threshold"].astype(np.float64)
        if qat:
            t = np.full_like(t, t.mean())
            w = np.round(np.clip(w, -127 / 64, 127 / 64) * 64) / 64
        conv = F.conv2d(x, torch.from_numpy(w), stride=_nnue_cfg().conv_stride,
                        padding=1)
        gap = np.minimum(gap, np.abs(conv.permute(0, 2, 3, 1).numpy() - t)
                         .min(axis=(1, 2, 3)))
    keep = raw[gap > margin][:n]
    assert len(keep) == n
    return keep


def _make_inputs(jax_etiny):
    """Everything the ranks and the references share; `jax_etiny` is the
    (params, stats) of an EtinyNet micro from JAX's init, perturbed."""
    rng = np.random.default_rng(10)
    p = _nnue_params(rng)
    raw = _clear_raw(rng, p, N_DATA)
    e_params, e_stats = jax_etiny
    return dict(
        p=p, raw=raw,
        x=normalize_images(torch.from_numpy(raw[:B])).numpy(),
        y=rng.integers(0, NC, B).astype(np.int64),
        labels=rng.integers(0, NC, N_DATA).astype(np.int64),
        idx=rng.integers(0, N_DATA, (K, B)),
        serve=normalize_images(torch.from_numpy(
            rng.random((13, H, H, 3), dtype=np.float32))).numpy(),
        e_params=e_params, e_stats=e_stats,
        e_x=rng.standard_normal((EB, EH, EH, 3)).astype(np.float32),
        e_y=rng.integers(0, 10, EB).astype(np.int64),
        e_raw=rng.random((2 * EB, EH, EH, 3), dtype=np.float32),
        e_idx=rng.integers(0, 2 * EB, EB),
        e_serve=rng.standard_normal((13, EH, EH, 3)).astype(np.float32),
    )


def _etiny_cfg():
    return tetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=EH)


def _nnue_state(inp, qat=False, mesh=None, opt=OPT):
    model = bridge.nnue_from_jax_params(inp["p"], _nnue_cfg(qat), device="cpu")
    optimizer = create_optimizer(opt, steps_per_epoch=4)
    return tstep.make_train_state(model, optimizer, mesh), optimizer


def _etiny_state(inp, mesh=None):
    model = bridge.etinynet_from_jax(inp["e_params"], inp["e_stats"],
                                     _etiny_cfg(), device="cpu")
    tmesh.bind_data_axis(model, mesh)
    optimizer = create_optimizer(EOPT, steps_per_epoch=4)
    return tstep.make_train_state(model, optimizer, mesh), optimizer


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _dp_nnue_step(inp, mesh=None):
    state, opt = _nnue_state(inp, mesh=mesh)
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    if mesh is not None:
        x, y = tmesh.shard_batch(mesh, (x, y))
    m = tstep.train_step(state, x, y, optimizer=opt)
    return dict(loss=float(m["loss"]), acc=float(m["accuracy"]),
                params=_params(state.model))


def _fused_chunk(inp, identity, mesh=None):
    state, opt = _nnue_state(inp, qat=True, mesh=mesh)
    m = tstep.scanned_train_steps_fused(
        state, prepare_gather_dataset(torch.from_numpy(inp["raw"])),
        torch.from_numpy(inp["labels"]), inp["idx"],
        torch.Generator().manual_seed(7), optimizer=opt, height=H, width=H,
        identity_augment=identity)
    return dict(losses=m["loss"].numpy(), params=_params(state.model))


def _etiny_step(inp, mesh=None):
    state, opt = _etiny_state(inp, mesh)
    x, y = torch.from_numpy(inp["e_x"]), torch.from_numpy(inp["e_y"])
    if mesh is not None:
        x, y = tmesh.shard_batch(mesh, (x, y))
    m = tstep.train_step(state, x, y, optimizer=opt)
    return dict(loss=float(m["loss"]), params=_params(state.model))


def _etiny_heavy_step(inp, mesh=None):
    """A gathered heavy-tier step (K4 and K5's plain versions), the draws
    and the noise made for the global batch."""
    state, opt = _etiny_state(inp, mesh)
    gen = torch.Generator().manual_seed(3)
    noise_gen = device_generator(gen, "cpu")
    m = tstep.gathered_train_step(
        state, torch.from_numpy(inp["e_raw"]),
        torch.from_numpy(np.arange(2 * EB) % 10), inp["e_idx"], gen,
        optimizer=opt, strength="heavy", noise_gen=noise_gen)
    return dict(loss=float(m["loss"]), params=_params(state.model))


def _serving(inp, mesh=None):
    """The NNUE sim's and the EtinyNet sim's outputs on 13 images, and
    evaluate_int8_sim's metrics on three backends (plain versions here)."""
    model = bridge.nnue_from_jax_params(inp["p"], _nnue_cfg(qat=True), device="cpu")
    sim, cfg = nnue_sim_params(tnnue.nnue_quantize(model), device="cpu")
    emodel = bridge.etinynet_from_jax(inp["e_params"], inp["e_stats"],
                                      _etiny_cfg(), device="cpu")
    esim, ecfg = etiny_sim_params(tetiny.etinynet_quantize(emodel), device="cpu")

    def nnue_fwd(x):
        return nnue_engine_forward(sim, x, cfg=cfg, image_h=H, image_w=H)

    def etiny_fwd(x):
        return etiny_engine_forward(esim, x, cfg=ecfg, image_h=EH, image_w=EH)

    if mesh is not None:
        nnue_fwd, etiny_fwd = (tmesh.shard_map(nnue_fwd, mesh),
                               tmesh.shard_map(etiny_fwd, mesh))
    raw = inp["raw"][:13]
    loader = [(raw[:8], inp["labels"][:8]), (raw[8:], inp["labels"][8:13])]
    metrics = {}
    for mode in (False, True, "mega"):
        got = evaluate_int8_sim(model, loader, use_pallas=mode, mesh=mesh)
        metrics[str(mode)] = {k: v for k, v in got.items() if k != "ms_per_sample"}
    return dict(nnue=nnue_fwd(torch.from_numpy(inp["serve"])),
                etiny=etiny_fwd(torch.from_numpy(inp["e_serve"])),
                metrics=metrics)


def _loop_cfg(path, log_dir, **kw):
    from config import load_config

    cfg = load_config(path)
    cfg.log_dir = str(log_dir)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


NNUE_LOOP = dict(use_augmentation=True, augmentation_strength="light",
                 steps_per_dispatch=2, max_devices=2)
# at a global batch of 4 a micro EtinyNet's loss moves by 1% at step 3 for
# a 1e-9 change of its params (norms over 2 images per rank): 16 images in
# 3 steps keep one process and two ranks within 1e-6 of each other
ETINY_LOOP = dict(use_augmentation=True, augmentation_strength="heavy",
                  optimizer_type="sgd", learning_rate=0.01, batch_size=16,
                  max_samples_per_split=48, max_devices=2)


def _losses(log_dir):
    import json

    (metrics,) = list((Path(log_dir) / "runs").rglob("metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    return ([r["train/loss"] for r in records if "train/loss" in r],
            {k: v for r in records for k, v in r.items()
             if k.startswith(("val/", "compiled/", "test/"))
             and not k.endswith("ms_per_sample")})


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------


def _join(rank, world, tmp):
    torch.set_num_threads(1)
    os.environ["NV_SKIP_ENGINE"] = "1"
    tdist.initialize_distributed(f"file://{tmp}/rdv{world}", world, rank,
                                 backend="gloo", timeout_s=JOIN_S)
    with open(Path(tmp) / "inputs.pkl", "rb") as f:
        return pickle.load(f)


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # the test reads which rank raised what
        return f"{type(e).__name__}: {e}"
    return ""


def _worker2(rank, tmp):
    inp = _join(rank, 2, tmp)
    mesh = tmesh.make_mesh(2)
    ax = mesh.axis(tmesh.DATA_AXIS)
    out = {"slice": tdist.process_local_slice(11), "first": mesh.first}

    # collectives
    g = np.random.default_rng(rank)
    xs = {"f32": torch.from_numpy(g.standard_normal((3, 5)).astype(np.float32)),
          "i32": torch.from_numpy(g.integers(-9, 9, (3, 5)).astype(np.int32)),
          "i64": torch.from_numpy(g.integers(-9, 9, (2, 4)))}
    out["mine"] = xs
    out["gathered"] = {k: tmesh.all_gather(v, ax) for k, v in xs.items()}
    out["gathered_dim1"] = tmesh.all_gather(xs["f32"], ax, dim=1)
    x = xs["f32"].clone().requires_grad_(True)
    (tmesh.all_reduce(x, ax) * (rank + 1)).sum().backward()
    out["reduce_grad"] = x.grad
    x = xs["f32"].clone().requires_grad_(True)
    w = torch.from_numpy(g.standard_normal((6, 5)).astype(np.float32))
    (tmesh.all_gather(x, ax) * w).sum().backward()
    out["gather_w"], out["gather_grad"] = w, x.grad

    # replicate: equal copies pass; a rank whose copy differs raises on all
    model = bridge.nnue_from_jax_params(inp["p"], _nnue_cfg(), device="cpu")
    tmesh.replicate(mesh, model)
    if rank == 1:
        with torch.no_grad():
            model.fc2_b.add_(1.0)
    out["replicate_differs"] = _raised(lambda: tmesh.replicate(mesh, model))

    out["nnue_step"] = _dp_nnue_step(inp, mesh)
    out["fused_identity"] = _fused_chunk(inp, True, mesh)
    out["fused_drawn"] = _fused_chunk(inp, False, mesh)
    out["etiny_step"] = _etiny_step(inp, mesh)
    out["etiny_heavy"] = _etiny_heavy_step(inp, mesh)
    out["serving"] = _serving(inp, mesh)

    # the loop, on both families, and the width rule's max_devices=1
    calls = []
    real = tloop.scanned_train_steps_fused
    tloop.scanned_train_steps_fused = lambda *a, **k: calls.append(1) or real(*a, **k)
    tloop.train_model(_loop_cfg(NNUE_STEPS_CFG, Path(tmp) / "nnue_dp", **NNUE_LOOP),
                      "nnue", device="cpu")
    tloop.scanned_train_steps_fused = real
    out["fused_calls"] = len(calls)
    tloop.train_model(_loop_cfg(ETINY_CFG, Path(tmp) / "etiny_dp", **ETINY_LOOP),
                      "etinynet", device="cpu")
    # resume: one epoch with step checkpoints, then resumed to two, against
    # an unbroken two-epoch run (a constant LR: the schedule ignores the cut)
    for run_id, epochs, resume, orbax in (("cut", 1, False, "orbax"),
                                          ("resumed", 2, True, "orbax"),
                                          ("unbroken", 2, False, "orbax_unbroken")):
        tloop.train_model(_loop_cfg(
            NNUE_STEPS_CFG, Path(tmp) / "resume", **NNUE_LOOP, max_epochs=epochs,
            checkpoint_backend="orbax", orbax_dir=str(Path(tmp) / orbax),
            resume=resume), "nnue", run_id, device="cpu")
    out["alone"] = tloop.train_model(_loop_cfg(
        NNUE_STEPS_CFG, Path(tmp) / f"alone{rank}", max_devices=1), "nnue",
        device="cpu")

    # a probe that fails on rank 0 stops both ranks
    del os.environ["NV_SKIP_ENGINE"]

    def broken_probe(*_):
        raise OSError("engine build failed")

    tloop.engine_probe = broken_probe
    out["probe"] = _raised(lambda: tloop.train_model(
        _loop_cfg(NNUE_STEPS_CFG, Path(tmp) / "probe"), "nnue", device="cpu"))
    torch.save(out, Path(tmp) / f"out2_{rank}.pt")
    dist.destroy_process_group()


def _worker4(rank, tmp):
    inp = _join(rank, 4, tmp)
    mesh = tmesh.make_mesh(4, (tmesh.DATA_AXIS, tmesh.MODEL_AXIS), shape=(2, 2))
    state, opt = _nnue_state(inp, qat=True, mesh=mesh)
    tmesh.shard_params(mesh, state.model)
    state = tstep.make_train_state(state.model, opt, mesh)
    shapes = {k: tuple(v.shape) for k, v in state.model.named_parameters()}
    x, y = tmesh.shard_batch(mesh, (torch.from_numpy(inp["x"]),
                                    torch.from_numpy(inp["y"])))
    m = tstep.train_step(state, x, y, optimizer=opt)
    out = dict(loss=float(m["loss"]), shapes=shapes,
               coords={a.name: a.index for a in mesh.axes},
               params=tmesh.unshard_params(mesh, state.model))
    torch.save(out, Path(tmp) / f"out4_{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: inputs, the two runs, the references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax

    from nnue_vision_tpu.models import etinynet as jetiny

    jcfg = jetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=EH)
    params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(4), jcfg))
    prng = np.random.default_rng(4)

    def perturb(tree):
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = perturb(v)
            elif k == "scale":
                out[k] = prng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = prng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = prng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    inp = _make_inputs((perturb(params), perturb(stats)))
    tmp = tmp_path_factory.mktemp("dp")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    return inp, tmp


@pytest.fixture(scope="module")
def ranks2(inputs):
    _, tmp = inputs
    tdist.spawn(_worker2, 2, (str(tmp),), timeout_s=JOIN_S)
    return [torch.load(tmp / f"out2_{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def ranks4(inputs):
    _, tmp = inputs
    tdist.spawn(_worker4, 4, (str(tmp),), timeout_s=JOIN_S)
    return [torch.load(tmp / f"out4_{r}.pt", weights_only=False) for r in range(4)]


def _jax_mesh_state(params, optimizer, mesh, stats=None):
    from nnue_vision_tpu.parallel.mesh import replicate
    from nnue_vision_tpu.training.step import make_train_state

    return replicate(mesh, make_train_state(params, optimizer, stats))


def _jnnue_cfg(qat=False):
    from nnue_vision_tpu.models import nnue as jnnue

    return jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(GRID, CH),
                            l1_size=L1, l2_size=L2, l3_size=L3, num_classes=NC,
                            input_size=H, qat=qat)


def _assert_params(got, want, atol, names=None):
    for name in names or want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# mesh helpers against the JAX package
# ---------------------------------------------------------------------------


def _fake_mesh(shape, index):
    axes = tuple(tmesh.Axis(n, s, i) for n, s, i in
                 zip((tmesh.DATA_AXIS, tmesh.MODEL_AXIS), shape, index))
    return tmesh.Mesh(axes, True, None, torch.device("cpu"))


def test_shard_batch_matches_jax_shards():
    """Each of 8 ranks' rows are the data of JAX's shard on device i."""
    import jax

    from nnue_vision_tpu.parallel.mesh import make_mesh, shard_batch

    rng = np.random.default_rng(3)
    images = rng.random((16, 4, 4, 3), dtype=np.float32)
    labels = rng.integers(0, 3, 16)
    jimages, _ = shard_batch(make_mesh(8), (images, labels))
    want = {s.device.id: np.asarray(s.data) for s in jimages.addressable_shards}
    devices = [d.id for d in jax.devices()[:8]]
    for i in range(8):
        mesh = _fake_mesh((8,), (i,))
        got_t, got_l = tmesh.shard_batch(mesh, (torch.from_numpy(images), labels))
        assert tuple(got_t.shape) == (2, 4, 4, 3) and got_l.shape == (2,)
        np.testing.assert_array_equal(got_t.numpy(), want[devices[i]])
        np.testing.assert_array_equal(got_l, labels[2 * i:2 * i + 2])
    chunk = np.arange(24).reshape(3, 8)  # a (steps, batch) chunk: columns
    got = tmesh.shard_batch(_fake_mesh((2,), (1,)), chunk, dim=1)
    np.testing.assert_array_equal(got, chunk[:, 4:])
    with pytest.raises(ValueError, match="split"):
        tmesh.shard_batch(_fake_mesh((3,), (0,)), images)


def test_pad_batch_to_devices_matches_jax():
    from nnue_vision_tpu.parallel.mesh import pad_batch_to_devices as jpad

    batch = (np.ones((13, 2, 2, 3), np.float32), np.arange(13))
    for got, want in zip(tmesh.pad_batch_to_devices(batch, 8), jpad(batch, 8)):
        np.testing.assert_array_equal(got, np.asarray(want))
    got = tmesh.pad_batch_to_devices(torch.ones(13, 2), 8)
    assert got.shape == (16, 2) and float(got[13:].abs().sum()) == 0.0


def test_tp_plan_and_shard_shapes_match_jax():
    """The tensor-parallel plan names the same split dims as JAX's
    PartitionSpecs, and each rank's shard has the shape of JAX's shard."""
    import jax
    from jax.sharding import PartitionSpec as P

    from nnue_vision_tpu.models import nnue as jnnue
    from nnue_vision_tpu.parallel import mesh as jmesh

    jm = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                           ("data", "model"))
    jparams = jmesh.shard_params(jm, jnnue.nnue_init(jax.random.PRNGKey(0),
                                                     _jnnue_cfg()))
    jplan = jmesh.nnue_param_shardings(jm, jparams)
    mesh = _fake_mesh((2, 2), (1, 1))
    model = tnnue.nnue_init(_nnue_cfg(), torch.Generator().manual_seed(0),
                            device="cpu")
    plan = tmesh.nnue_param_shardings(mesh, model)
    assert set(plan) == set(jplan)
    for name, spec in plan.items():
        assert P(*spec) == jplan[name].spec, name
    full = {k: v.detach().clone() for k, v in model.named_parameters()}
    tmesh.shard_params(mesh, model)
    assert model.tp_sharded == ("ft_w", "ft_b", "fc1_w")
    for name, p in model.named_parameters():
        want = {s.data.shape for s in jparams[name].addressable_shards}
        assert want == {tuple(p.shape)}, name
    np.testing.assert_array_equal(model.ft_w.detach().numpy(),
                                  full["ft_w"][:, L1 // 2:].numpy())
    with pytest.raises(ValueError, match="model"):
        tmesh.nnue_param_shardings(_fake_mesh((4,), (0,)), model)


def test_one_process_mesh_is_the_identity():
    """Without a process group a mesh has one rank, no groups, and every
    collective and placement is the identity; more ranks than exist raise."""
    mesh = tmesh.make_mesh()
    assert mesh.size == 1 and mesh.group is None and mesh.first
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.all_gather(x, mesh.axis("data")) is x
    assert tmesh.all_reduce(x, mesh.axis("data")) is x
    assert tmesh.replicate(mesh, {"x": x})["x"] is x
    assert torch.equal(tmesh.shard_map(lambda t: t * 2, mesh)(x), x * 2)
    with pytest.raises(ValueError, match="requested"):
        tmesh.make_mesh(1024)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def test_zero_slot_all_gather_is_a_concatenation(ranks2):
    for rank in range(2):
        for k in ("f32", "i32", "i64"):
            want = torch.cat([ranks2[0]["mine"][k], ranks2[1]["mine"][k]])
            got = ranks2[rank]["gathered"][k]
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.int32) if k == "f32" else got,
                               want.view(torch.int32) if k == "f32" else want)
        want = torch.cat([ranks2[0]["mine"]["f32"], ranks2[1]["mine"]["f32"]], 1)
        assert torch.equal(ranks2[rank]["gathered_dim1"], want)


def test_collectives_differentiate(ranks2):
    """all_reduce: the gradient of Σ_r (r+1)·sum(y) is 1 + 2 on every
    rank; all_gather: rank r's slot of Σ_r w_r."""
    wsum = ranks2[0]["gather_w"] + ranks2[1]["gather_w"]
    for rank in range(2):
        assert torch.equal(ranks2[rank]["reduce_grad"], torch.full((3, 5), 3.0))
        torch.testing.assert_close(ranks2[rank]["gather_grad"],
                                   wsum[3 * rank:3 * rank + 3], rtol=0, atol=0)


def test_process_local_slice_and_replicate(ranks2):
    assert [r["slice"] for r in ranks2] == [(0, 5), (5, 11)]
    assert [r["first"] for r in ranks2] == [True, False]
    for r in ranks2:  # rank 1's fc2_b differs: both ranks raise
        assert r["replicate_differs"].startswith("RuntimeError: replicate")


def test_dp_nnue_step_matches_jax_mesh_step(inputs, ranks2):
    import jax
    import jax.numpy as jnp

    from nnue_vision_tpu.parallel.mesh import make_mesh, shard_batch
    from nnue_vision_tpu.training import optim as joptim
    from nnue_vision_tpu.training.step import train_step

    inp, _ = inputs
    mesh = make_mesh(2)
    jopt = joptim.create_optimizer(OPT, steps_per_epoch=4)
    state = _jax_mesh_state(jax.tree_util.tree_map(jnp.asarray, inp["p"]), jopt, mesh)
    x, y = shard_batch(mesh, (inp["x"], inp["y"]))
    state, m = train_step(state, x, y, model_type="nnue", model_cfg=_jnnue_cfg(),
                          optimizer=jopt)
    for r in ranks2:
        np.testing.assert_allclose(r["nnue_step"]["loss"], float(m["loss"]), rtol=1e-5)
        _assert_params({k: v.numpy() for k, v in r["nnue_step"]["params"].items()},
                       jax.device_get(state.params), atol=1e-5)


def test_dp_nnue_step_matches_one_process(inputs, ranks2):
    inp, _ = inputs
    one = _dp_nnue_step(inp)
    for r in ranks2:
        got = r["nnue_step"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        assert got["acc"] == one["acc"]
        _assert_params(got["params"], one["params"], atol=1e-6)
        assert not torch.equal(got["params"]["fc1_w"], torch.from_numpy(inp["p"]["fc1_w"]))


def test_dp_fused_chunk_matches_jax_mesh_chunk(inputs, ranks2):
    """Three fused steps (K3's plain version) with identity augmentation
    against JAX's fused chunk on make_mesh(2), interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nnue_vision_tpu.ops.input_pipeline import prepare_gather_dataset as jprep
    from nnue_vision_tpu.parallel.mesh import make_mesh, replicate
    from nnue_vision_tpu.training import optim as joptim
    from nnue_vision_tpu.training.step import scanned_train_steps_fused

    inp, _ = inputs
    mesh = make_mesh(2)
    jopt = joptim.create_optimizer(OPT, steps_per_epoch=4)
    state = _jax_mesh_state(jax.tree_util.tree_map(jnp.asarray, inp["p"]), jopt, mesh)
    state, m = scanned_train_steps_fused(
        state, replicate(mesh, jprep(jnp.asarray(inp["raw"]))),
        replicate(mesh, jnp.asarray(inp["labels"])),
        jax.device_put(inp["idx"], NamedSharding(mesh, P(None, "data"))),
        jax.random.PRNGKey(9), model_type="nnue", model_cfg=_jnnue_cfg(qat=True),
        optimizer=jopt, height=H, width=H, interpret=True, mesh=mesh,
        identity_augment=True)
    for r in ranks2:
        got = r["fused_identity"]
        np.testing.assert_allclose(got["losses"], np.asarray(m["loss"]), rtol=1e-5)
        _assert_params({k: v.numpy() for k, v in got["params"].items()},
                       jax.device_get(state.params), atol=1e-5)


@pytest.mark.parametrize("identity", [True, False], ids=["identity", "drawn"])
def test_dp_fused_chunk_matches_one_process(inputs, ranks2, identity):
    """With drawn augmentation too: each rank's columns of the global
    draws give the one-process chunk."""
    inp, _ = inputs
    one = _fused_chunk(inp, identity)
    for r in ranks2:
        got = r["fused_identity" if identity else "fused_drawn"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
        _assert_params(got["params"], one["params"], atol=1e-6)


def _etiny_close(got, want_loss, want_params, init):
    """The EtinyNet bar: loss rtol 1e-5, norm statistics atol 1e-5, each
    parameter's update atol 1e-4 · max(lr, its largest magnitude)."""
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    for name, want in want_params.items():
        got_v = np.asarray(got["params"][name])
        want = np.asarray(want)
        if name.endswith(("mean", "var")):
            np.testing.assert_allclose(got_v, want, rtol=0, atol=1e-5, err_msg=name)
            continue
        d_got, d_want = got_v - init[name], np.asarray(want) - init[name]
        scale = max(EOPT.learning_rate, float(np.abs(d_want).max()))
        np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_dp_etinynet_step_global_batchnorm_matches_jax(inputs, ranks2):
    """Float32 micro EtinyNet: the norms' batch statistics span the global
    batch of 8 (4 per rank), as GSPMD reduces them in JAX."""
    import jax
    import jax.numpy as jnp

    from nnue_vision_tpu.models import etinynet as jetiny
    from nnue_vision_tpu.parallel.mesh import make_mesh, shard_batch
    from nnue_vision_tpu.training import optim as joptim
    from nnue_vision_tpu.training.step import train_step

    inp, _ = inputs
    mesh = make_mesh(2)
    jopt = joptim.create_optimizer(EOPT, steps_per_epoch=4)
    tree = jax.tree_util.tree_map(jnp.asarray, (inp["e_params"], inp["e_stats"]))
    state = _jax_mesh_state(tree[0], jopt, mesh, tree[1])
    x, y = shard_batch(mesh, (inp["e_x"], inp["e_y"]))
    jcfg = jetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=EH)
    state, m = train_step(state, x, y, model_type="etinynet", model_cfg=jcfg,
                          optimizer=jopt)
    # the port's state-dict names are JAX's flattened params and statistics
    init = {**bridge._flatten(inp["e_params"]), **bridge._flatten(inp["e_stats"])}
    want = {**bridge._flatten(jax.device_get(state.params)),
            **bridge._flatten(jax.device_get(state.batch_stats))}
    for r in ranks2:
        _etiny_close(r["etiny_step"], float(m["loss"]), want, init)
    for key, value in ranks2[0]["etiny_step"]["params"].items():
        if key.endswith(("mean", "var")):  # equal on both ranks
            assert torch.equal(value, ranks2[1]["etiny_step"]["params"][key]), key


@pytest.mark.parametrize("step", ["plain", "heavy"])
def test_dp_etinynet_step_matches_one_process(inputs, ranks2, step):
    """The plain step, and a gathered heavy-tier step whose warp (K4) and
    photometric blocks (K5) run on each rank's rows of the global draws."""
    inp, _ = inputs
    one = (_etiny_step if step == "plain" else _etiny_heavy_step)(inp)
    init = {**bridge._flatten(inp["e_params"]), **bridge._flatten(inp["e_stats"])}
    for r in ranks2:
        got = r["etiny_step" if step == "plain" else "etiny_heavy"]
        _etiny_close(got, one["loss"], one["params"], init)


def test_sharded_int8_serving_is_bit_equal(inputs, ranks2):
    """The NNUE and EtinyNet sims on 13 images split over two ranks (padded
    to 14), and evaluate_int8_sim's metrics on each backend, equal one
    process exactly."""
    inp, _ = inputs
    one = _serving(inp)
    for r in ranks2:
        got = r["serving"]
        for g, w in zip(got["nnue"], one["nnue"]):
            assert torch.equal(g, w)
        assert torch.equal(got["etiny"], one["etiny"])
        assert got["metrics"] == one["metrics"]


def test_train_model_dp_matches_one_process(inputs, ranks2, tmp_path, monkeypatch):
    """train_model with max_devices=2 on two ranks takes the fused K3 path
    (4 chunks of 2 per rank) and logs the one-process losses and epoch
    metrics; an EtinyNet on the heavy tier its losses and float metrics
    (its int8 metrics may flip a rounding on a 1e-7 difference)."""
    _, tmp = inputs
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    assert [r["fused_calls"] for r in ranks2] == [4, 4]
    for name, path, kw, model_type, steps in (
            ("nnue_dp", NNUE_STEPS_CFG, NNUE_LOOP, "nnue", 8),
            ("etiny_dp", ETINY_CFG, ETINY_LOOP, "etinynet", 3)):
        assert tloop.train_model(_loop_cfg(path, tmp_path / name, **kw),
                                 model_type, device="cpu") == 0
        got_losses, got_metrics = _losses(tmp / name)
        want_losses, want_metrics = _losses(tmp_path / name)
        assert len(got_losses) == len(want_losses) == steps
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-6)
        assert set(got_metrics) == set(want_metrics)
        for k, v in want_metrics.items():
            if model_type == "nnue" or k.startswith(("val/", "test/")):
                np.testing.assert_allclose(got_metrics[k], v, rtol=1e-5, err_msg=k)


def test_dp_resumed_run_equals_an_unbroken_one(inputs, ranks2):
    """Both ranks restore the step checkpoint rank 0 wrote (the model, the
    optimizer state, the generators and the loader's epoch), and the
    resumed epoch's losses are bit-equal to an unbroken dp run's."""
    _, tmp = inputs
    logs = tmp / "resume"
    resumed = _step_losses(logs, "resumed")
    unbroken = _step_losses(logs, "unbroken")
    assert [s for s, _ in resumed] == list(range(8, 16))
    assert resumed == unbroken[8:]
    assert _step_losses(logs, "cut") == unbroken[:8]


def _step_losses(log_dir, run_id):
    import json

    path = Path(log_dir) / "runs" / run_id / "metrics.jsonl"
    return [(r["step"], r["train/loss"]) for r in map(
        json.loads, path.read_text().splitlines()) if "train/loss" in r]


def test_train_model_width_rule_and_failed_probe(inputs, ranks2):
    """max_devices=1 trains on rank 0 alone (rank 1 takes no step); a probe
    that fails on rank 0 raises there and on rank 1, which waits for it."""
    _, tmp = inputs
    assert [r["alone"] for r in ranks2] == [0, 0]
    assert (tmp / "alone0" / "runs").is_dir() and not (tmp / "alone1").exists()
    assert ranks2[0]["probe"] == "OSError: engine build failed"
    assert ranks2[1]["probe"] == "RuntimeError: the engine probe failed on rank 0"


# ---------------------------------------------------------------------------
# four ranks: data × model
# ---------------------------------------------------------------------------


def test_dp_tp_step_matches_one_process(inputs, ranks4):
    """data=2 × model=2, QAT: each rank holds half of L1 (fc1's columns
    split at the global half), and one step equals one process's."""
    inp, _ = inputs
    state, opt = _nnue_state(inp, qat=True)
    m = tstep.train_step(state, torch.from_numpy(inp["x"]),
                         torch.from_numpy(inp["y"]), optimizer=opt)
    want = _params(state.model)
    for r in ranks4:
        assert r["shapes"]["ft_w"] == (GRID * GRID * CH, L1 // 2)
        assert r["shapes"]["fc1_w"] == (L2, L1 // 2)
        assert r["shapes"]["fc2_w"] == (L3, L2)
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        _assert_params(r["params"], want, atol=1e-5)
    assert sorted((r["coords"]["data"], r["coords"]["model"]) for r in ranks4) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_dp_tp_step_matches_jax(inputs, ranks4):
    """The same step on JAX's 2-D (data, model) mesh with its tp plan."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nnue_vision_tpu.parallel.mesh import shard_params
    from nnue_vision_tpu.training import optim as joptim
    from nnue_vision_tpu.training.step import TrainState, train_step

    inp, _ = inputs
    jm = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                           ("data", "model"))
    jopt = joptim.create_optimizer(OPT, steps_per_epoch=4)
    params = shard_params(jm, jax.tree_util.tree_map(jnp.asarray, inp["p"]))
    rep = NamedSharding(jm, P())
    state = TrainState(
        params=params,
        opt_state=jax.tree_util.tree_map(lambda t: jax.device_put(t, rep),
                                         jopt.init(params)),
        batch_stats=None, step=jax.device_put(jnp.zeros((), jnp.int32), rep))
    data = NamedSharding(jm, P("data"))
    state, m = train_step(state, jax.device_put(inp["x"], data),
                          jax.device_put(inp["y"], data), model_type="nnue",
                          model_cfg=_jnnue_cfg(qat=True), optimizer=jopt)
    for r in ranks4:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        _assert_params({k: v.numpy() for k, v in r["params"].items()},
                       jax.device_get(state.params), atol=1e-5)
