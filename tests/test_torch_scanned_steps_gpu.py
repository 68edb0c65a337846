"""The graphed train chunk (`training/step.py` `ChunkGraph`) held to the
eager chunk on a card: a fused NNUE chunk (K3 in the graph) and a heavy
EtinyNet chunk (K4 and K5 in the graph) from copied states, each replay
`torch.equal` to the eager steps; a new capture after the model's config
or the optimizer's state changes; a replay advancing each kernel's
launch count by the launches captured; and the capture's nodes by phase
adding up to the graph's.

A state whose `chunk_graph` is None runs its next full chunk eagerly (the
warm-up of a new signature): the eager references below drop it before
each chunk. Marked `gpu`; each test skips where there is no CUDA device.
The file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_scanned_steps_gpu.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.data.augment import device_generator
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig, etinynet_init
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet, NNUEConfig, nnue_init
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops import warp_kernel as wk
from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
from nnue_vision_tpu_torch.training.optim import Optimizer, make_schedule
from nnue_vision_tpu_torch.training.step import (
    TrainState,
    gathered_train_step,
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
)

pytestmark = pytest.mark.gpu

K, B, N, H = 5, 64, 512, 32
NNUE_CFG = NNUEConfig(feature_set=GridFeatureSet(10, 8), l1_size=128, l2_size=32,
                      l3_size=16, num_classes=10, input_size=H, qat=True)
ETINY_CFG = EtinyNetConfig(variant="micro", num_classes=10, input_size=H,
                           dtype="bfloat16")


class _Opt:
    learning_rate, use_cosine_scheduler, warmup_iters, max_epochs = 0.02, True, 3, 4


@pytest.fixture
def cuda():
    """The card, with cuDNN's deterministic algorithms for the tests' span:
    by default a conv's weight gradient may sum with atomics, so two eager
    runs from one state differ in the last bits (and an EtinyNet's float32
    Adam run then drifts apart); with them the eager path repeats itself
    exactly, and a graph must equal it exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _optimizer(kind="sgd"):
    return Optimizer(make_schedule(_Opt, 4 * K), kind=kind, momentum=0.9,
                     weight_decay=2e-4, max_grad_norm=1.0)


def _data(cuda, seed=0):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((N, H, H, 3), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, N)).to(cuda)
    return images, labels, rng


def _chunks(rng, count):
    return [rng.integers(0, N, (K, B)) for _ in range(count)]


def _copy(state):
    opt = {k: v if k == "count" else {n: t.clone() for n, t in v.items()}
           for k, v in state.opt_state.items()}
    return TrainState(copy.deepcopy(state.model), opt, state.step)


def _gen_copy(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _assert_phases_add_up(graph):
    """The capture's nodes by phase (input, model, update, and the chunk's
    tail) add up to the graph's nodes, each phase but the tail in every
    step; the `tracing` gauge holds the newest capture's."""
    phases = graph.phase_nodes
    assert tracing.GAUGES["chunk_graph_nodes"] == phases
    assert list(phases) == ["input", "model", "update", "tail"]
    assert sum(phases.values()) == graph.nodes
    assert all(phases[p] >= K for p in ("input", "model", "update"))
    assert phases["tail"] > 0


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for (name, t), (_, u) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        assert torch.equal(t, u), name
    for k, v in a.opt_state.items():
        if k != "count":
            for name, t in v.items():
                assert torch.equal(t, b.opt_state[k][name]), (k, name)


def test_fused_chunk_graph_equals_eager(cuda):
    images, labels, rng = _data(cuda)
    dataset = prepare_gather_dataset(images)
    opt = _optimizer()
    state = make_train_state(
        nnue_init(NNUE_CFG, torch.Generator().manual_seed(0), device=cuda), opt)
    gen = torch.Generator().manual_seed(1)
    kw = dict(optimizer=opt, height=H, width=H)
    chunks = _chunks(rng, 3)
    scanned_train_steps_fused(state, dataset, labels, chunks[0], gen, **kw)
    assert state.chunk_graph is not None and state.chunk_graph.graph is None
    ref, ref_gen = _copy(state), _gen_copy(gen)

    before = ip.LAUNCHES["light_pipeline_kernel"]
    got = [scanned_train_steps_fused(state, dataset, labels, c, gen, **kw)
           for c in chunks[1:]]
    graph = state.chunk_graph
    assert graph.graph is not None and graph.replays == 2 and graph.nodes > 0
    assert graph.launches == {("input_pipeline", "light_pipeline_kernel"): K}
    _assert_phases_add_up(graph)
    assert ip.LAUNCHES["light_pipeline_kernel"] - before == 2 * K
    want = []
    for c in chunks[1:]:
        ref.chunk_graph = None  # eager: the warm-up path
        want.append(scanned_train_steps_fused(ref, dataset, labels, c, ref_gen, **kw))
    for g, w in zip(got, want):
        assert torch.equal(g["loss"], w["loss"])
        assert torch.equal(g["accuracy"], w["accuracy"])
    _assert_states_equal(state, ref)
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def _heavy_setup(cuda, kind="sgd"):
    images, labels, rng = _data(cuda, 2)
    opt = _optimizer(kind)
    model = etinynet_init(ETINY_CFG, torch.Generator().manual_seed(0), device=cuda)
    gen = torch.Generator().manual_seed(3)
    return images, labels, rng, opt, make_train_state(model, opt), gen, \
        device_generator(gen, cuda)


def test_heavy_chunk_graph_equals_gathered_steps(cuda):
    images, labels, rng, opt, state, gen, noise = _heavy_setup(cuda)
    kw = dict(optimizer=opt, strength="heavy")
    chunks = _chunks(rng, 3)
    scanned_train_steps(state, images, labels, chunks[0], gen, noise_gen=noise, **kw)
    ref, ref_gen, ref_noise = _copy(state), _gen_copy(gen), _gen_copy(noise)
    before = (wk.LAUNCHES["warp_kernel"], pk.LAUNCHES["photometric_kernel"])
    got = [scanned_train_steps(state, images, labels, c, gen, noise_gen=noise, **kw)
           for c in chunks[1:]]
    graph = state.chunk_graph
    assert graph.replays == 2 and graph.launches == {
        ("warp_kernel", "warp_kernel"): 2 * K,
        ("photometric_kernel", "photometric_kernel"): 2 * K}
    _assert_phases_add_up(graph)
    assert (wk.LAUNCHES["warp_kernel"] - before[0],
            pk.LAUNCHES["photometric_kernel"] - before[1]) == (4 * K, 4 * K)
    for g, c in zip(got, chunks[1:]):
        want = [gathered_train_step(ref, images, labels, i, ref_gen,
                                    noise_gen=ref_noise, **kw) for i in c]
        assert torch.equal(g["loss"], torch.stack([m["loss"] for m in want]))
    _assert_states_equal(state, ref)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert torch.equal(noise.get_state(), ref_noise.get_state())


def test_new_config_or_optimizer_state_captures_anew(cuda):
    """`model.cfg = ...` (the ef switch's config) and a fresh optimizer state
    (the switch's restart, a resume) each drop the graph: the next full
    chunk runs eagerly, the one after it is a new capture, and both equal
    the eager steps."""
    images, labels, rng, opt, state, gen, noise = _heavy_setup(cuda, "adam")
    kw = dict(optimizer=opt, strength="medium")
    for c in _chunks(rng, 2):
        scanned_train_steps(state, images, labels, c, gen, noise_gen=noise, **kw)
    first = state.chunk_graph
    assert first.replays == 1

    for change in ("config", "optimizer state"):
        if change == "config":
            state.model.cfg = dataclasses.replace(state.model.cfg, dtype="float32")
        else:
            state.opt_state = opt.init(dict(state.model.named_parameters()))
        ref, ref_gen, ref_noise = _copy(state), _gen_copy(gen), _gen_copy(noise)
        chunks = _chunks(rng, 3)
        got = [scanned_train_steps(state, images, labels, c, gen, noise_gen=noise,
                                   **kw) for c in chunks]
        assert state.chunk_graph is not first and state.chunk_graph.replays == 2
        first = state.chunk_graph
        for g, c in zip(got, chunks):
            want = [gathered_train_step(ref, images, labels, i, ref_gen,
                                        noise_gen=ref_noise, **kw) for i in c]
            assert torch.equal(g["loss"], torch.stack([m["loss"] for m in want]))
        _assert_states_equal(state, ref)


def test_replay_spans_leave_the_device_events_alone(cuda):
    """A replayed chunk under the profiler with CUDA activity records its
    spans (`chunk`, its draws, pack, load and replay; the heavy tier's 70
    host calls a step) and no device event carries a span's name."""
    from torch.profiler import ProfilerActivity, profile

    images, labels, rng, opt, state, gen, noise = _heavy_setup(cuda)
    kw = dict(optimizer=opt, strength="heavy", noise_gen=noise)
    for c in _chunks(rng, 2):  # the warm-up, then the capture
        scanned_train_steps(state, images, labels, c, gen, **kw)
    (idx,) = _chunks(rng, 1)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scanned_train_steps(state, images, labels, idx, gen, **kw)
        torch.cuda.synchronize()
    spans = {s.name: s for s in tracing.spans()}
    assert set(spans) == {"chunk", "chunk.draws", "chunk.pack", "chunk.load",
                          "chunk.replay"}
    assert spans["chunk.draws"].counts == {"draw_calls": 70 * K}
    device = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device and not set(device) & set(spans)
