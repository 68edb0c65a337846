"""The port's spans and counters (`nnue_vision_tpu_torch/tracing.py`) on the
CPU: nothing recorded with no profiler active; a train chunk's spans with
their parents and counts under `torch.profiler`; the spans and the
profiler's own events on one clock; the host draw calls of each tier; the
chunk, its draws and its pack split, still equal to K
`gathered_train_step` calls bit for bit; the serving entries' spans; the
registry behind the kernel modules' `LAUNCHES`; and the training loop's
`profile_dir` trace carrying the spans on its time base.

Sizes are small: a micro EtinyNet and a grid-4 NNUE on 16×16 images, K = 4
steps of batch 8; the draw counts also at 1024×32×32, where they are
the same. The file imports no jax.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from config import load_config
from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.data.augment import DRAWS, device_generator, draw_batch
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNetConfig,
    etinynet_init,
    etinynet_quantize,
)
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
    nnue_quantize,
)
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops.engine_sim import etiny_sim_params, nnue_sim_params
from nnue_vision_tpu_torch.ops.etiny_kernels import (
    etiny_forward_kernel,
    etiny_kernel_params,
)
from nnue_vision_tpu_torch.ops.input_pipeline import (
    draw_light_params,
    prepare_gather_dataset,
)
from nnue_vision_tpu_torch.training import loop as tloop
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    gathered_train_step,
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
)

REPO = Path(__file__).resolve().parent.parent
K, B, N, H = 4, 8, 64, 16
OPT = dict(learning_rate=0.05, weight_decay=1e-4, momentum=0.9,
           optimizer_type="sgd", max_grad_norm=1.0, use_cosine_scheduler=False,
           max_epochs=1, decay_lr=False, use_cyclical_lr=False)
# host generator calls a step of each tier (the fused light chunk: a chunk)
CALLS = {"none": 0, "light": 8, "medium": 39, "heavy": 70}
CHUNK = ("chunk.draws", "chunk.pack", "chunk.load", "chunk.eager")


def _cpu_profile():
    """A CPU profiler whose stretch starts the span buffer anew: a span
    found the profiler off just before it."""
    with tracing.span("off"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def _data(seed=0):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((N, H, H, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, N))
    return images, labels, rng.integers(0, N, (K, B))


def _etiny_state():
    model = etinynet_init(EtinyNetConfig(variant="micro", num_classes=10,
                                         input_size=H),
                          torch.Generator().manual_seed(0), device="cpu")
    opt = create_optimizer(types.SimpleNamespace(**OPT), steps_per_epoch=K)
    return make_train_state(model, opt), opt


def _chunk(tier, state, opt, images, labels, idx, gen, noise):
    return scanned_train_steps(
        state, images, labels, idx, gen, optimizer=opt,
        strength="light" if tier == "none" else tier, augment=tier != "none",
        noise_gen=noise)


def _by_name(records):
    out = {}
    for s in records:
        out.setdefault(s.name, []).append(s)
    return out


def test_a_span_records_only_under_a_profiler():
    with _cpu_profile():
        with tracing.span("outer", n=1):
            with tracing.span("inner") as s:
                s.count(k=2)
    first = tracing.spans()
    assert [(s.name, s.parent, s.counts) for s in first] == [
        ("inner", "outer", {"k": 2}), ("outer", None, {"n": 1})]
    state, opt = _etiny_state()
    images, labels, idx = _data()
    _chunk("light", state, opt, images, labels, idx,
           torch.Generator().manual_seed(1), None)
    with tracing.span("off") as s:
        s.count(k=3)
    assert tracing.spans() == first  # nothing recorded with no profiler
    with _cpu_profile():
        with tracing.span("next"):
            pass
    assert [s.name for s in tracing.spans()] == ["next"]  # a stretch anew


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    before = tracing.dropped()
    with _cpu_profile():
        for _ in range(5):
            with tracing.span("s"):
                pass
    assert len(tracing.spans()) == 3 and tracing.dropped() - before == 2


@pytest.mark.parametrize("tier", list(CALLS))
def test_chunk_spans_nest_with_their_counts(tier):
    """`chunk` holds its draws, pack, load and eager body (the CPU runs the
    body eagerly), each a child of it and inside it; `draw_calls` is the
    tier's host calls for the K steps."""
    state, opt = _etiny_state()
    images, labels, idx = _data()
    gen = torch.Generator().manual_seed(1)
    noise = device_generator(gen, "cpu") if tier in ("medium", "heavy") else None
    with _cpu_profile():
        _chunk(tier, state, opt, images, labels, idx, gen, noise)
    spans = _by_name(tracing.spans())
    assert set(spans) == {"chunk", *CHUNK}
    assert all(len(v) == 1 for v in spans.values())
    (chunk,) = spans["chunk"]
    assert chunk.parent is None and chunk.counts == {"steps": K}
    for name in CHUNK:
        (s,) = spans[name]
        assert s.parent == "chunk"
        assert chunk.start_ns <= s.start_ns <= s.end_ns <= chunk.end_ns
    order = [spans[n][0] for n in CHUNK]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert spans["chunk.draws"][0].counts == {"draw_calls": K * CALLS[tier]}


def test_fused_chunk_draws_once_a_chunk():
    cfg = NNUEConfig(feature_set=GridFeatureSet(4, 4), l1_size=16, l2_size=8,
                     l3_size=4, num_classes=10, input_size=H)
    opt = create_optimizer(types.SimpleNamespace(**OPT), steps_per_epoch=K)
    state = make_train_state(
        nnue_init(cfg, torch.Generator().manual_seed(0), device="cpu"), opt)
    images, labels, idx = _data()
    with _cpu_profile():
        scanned_train_steps_fused(state, prepare_gather_dataset(images), labels,
                                  idx, torch.Generator().manual_seed(1),
                                  optimizer=opt, height=H, width=H)
    spans = _by_name(tracing.spans())
    assert set(spans) == {"chunk", *CHUNK}
    assert spans["chunk"][0].counts == {"steps": K}
    assert spans["chunk.draws"][0].counts == {"draw_calls": CALLS["light"]}


def test_spans_and_profiler_events_share_a_clock():
    """Every `aten::rand` the profiler saw (the light tier's draws, one a
    host generator call) lies inside the `chunk.draws` span on the span's
    clock, and no other operation of the chunk does."""
    state, opt = _etiny_state()
    images, labels, idx = _data()
    with _cpu_profile() as prof:
        _chunk("light", state, opt, images, labels, idx,
               torch.Generator().manual_seed(1), None)
    (draws,) = _by_name(tracing.spans())["chunk.draws"]
    (pack,) = _by_name(tracing.spans())["chunk.pack"]
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    rand = [e for e in events if e[0] == "aten::rand"]
    assert len(rand) == K * CALLS["light"]
    for _, a, b in rand:
        assert draws.start_ns <= a <= b <= draws.end_ns
    stacks = [e for e in events if e[0] == "aten::stack"]
    assert stacks and any(pack.start_ns <= a <= b <= pack.end_ns
                          for _, a, b in stacks)
    assert not any(draws.start_ns <= a <= draws.end_ns for _, a, _ in stacks)


@pytest.mark.parametrize("tier", ["light", "medium", "heavy"])
def test_host_draw_calls_of_a_step_at_full_size(tier):
    gen = torch.Generator().manual_seed(0)
    before = DRAWS["host_draw_calls"]
    draw_batch(gen, tier, 1024, 32, 32)
    assert DRAWS["host_draw_calls"] - before == CALLS[tier]


def test_host_draw_calls_of_a_fused_chunk_and_not_the_noise_seed():
    gen = torch.Generator().manual_seed(0)
    before = DRAWS["host_draw_calls"]
    draw_light_params(gen, 39, 512, 32, 32)
    assert DRAWS["host_draw_calls"] - before == CALLS["light"]
    device_generator(gen, "cpu")
    assert DRAWS["host_draw_calls"] - before == CALLS["light"]


@pytest.mark.parametrize("tier", list(CALLS))
def test_chunk_with_split_draws_equals_gathered_steps(tier):
    """The chunk draws all K steps, then packs them: the losses, the state
    and both generators end where K `gathered_train_step` calls leave
    theirs, bit for bit."""
    images, labels, idx = _data()
    results = []
    for chunked in (True, False):
        state, opt = _etiny_state()
        gen = torch.Generator().manual_seed(1)
        noise = (device_generator(gen, "cpu") if tier in ("medium", "heavy")
                 else None)
        kw = dict(optimizer=opt, strength="light" if tier == "none" else tier,
                  augment=tier != "none", noise_gen=noise)
        if chunked:
            loss = scanned_train_steps(state, images, labels, idx, gen, **kw)["loss"]
        else:
            loss = torch.stack([gathered_train_step(
                state, images, labels, i, gen, **kw)["loss"] for i in idx])
        results.append((loss, state.model.state_dict(), gen.get_state(),
                        None if noise is None else noise.get_state()))
    (l1, s1, g1, n1), (l2, s2, g2, n2) = results
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert n1 is None and n2 is None or torch.equal(n1, n2)
    for name, t in s1.items():
        assert torch.equal(t, s2[name]), name


def _nnue_serving():
    cfg = NNUEConfig(feature_set=GridFeatureSet(4, 4), l1_size=16, l2_size=8,
                     l3_size=4, num_classes=10, input_size=H)
    model = nnue_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return nnue_sim_params(nnue_quantize(model), device="cpu")


def _images(b=4):
    return torch.rand((b, H, H, 3), generator=torch.Generator().manual_seed(2))


def test_serving_spans_of_the_nnue_entries():
    sim, scfg = _nnue_serving()
    x = _images()
    kw = dict(cfg=scfg, image_h=H, image_w=H)
    with _cpu_profile():
        mega = nk.nnue_engine_forward_mega(
            nk.mega_head_params(sim, scfg, H, H), x.reshape(4, -1), **kw)
    assert [(s.name, s.parent) for s in tracing.spans()] == [
        ("serve.kernels", None)]
    tracing.clear()
    with _cpu_profile():
        fused = nk.nnue_engine_forward_fused(sim, nk.pallas_head_params(sim),
                                             x, **kw)
    assert tracing.spans() == []  # no cell reads the fused entry's time
    want = nk.nnue_engine_forward_fused_reference(
        sim, nk.pallas_head_params(sim), x, **kw)
    for a, b, c in zip(mega, fused, want):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_serving_spans_of_the_etinynet_entry():
    cfg = EtinyNetConfig(variant="micro", num_classes=10, input_size=H)
    model = etinynet_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    sim, scfg = etiny_sim_params(etinynet_quantize(model.eval()), device="cpu")
    kp = etiny_kernel_params(sim, scfg)
    with _cpu_profile():
        etiny_forward_kernel(kp, _images(), cfg=scfg, image_h=H, image_w=H)
    spans = tracing.spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("serve.stem", None), ("serve.kernels", None), ("serve.tail", None)]
    stem, kernels, tail = spans
    assert (stem.start_ns <= stem.end_ns <= kernels.start_ns
            <= kernels.end_ns <= tail.start_ns <= tail.end_ns)


def test_launch_counters_are_one_registry():
    assert tracing.COUNTERS["input_pipeline"] is ip.LAUNCHES
    assert tracing.COUNTERS["nnue_kernels"] is nk.LAUNCHES
    assert tracing.COUNTERS["draws"] is DRAWS
    values = tracing.snapshot()
    ip.LAUNCHES["light_pipeline_kernel"] += 5
    tracing.add({("input_pipeline", "light_pipeline_kernel"): 2})
    assert (ip.LAUNCHES["light_pipeline_kernel"]
            == values[("input_pipeline", "light_pipeline_kernel")] + 7)
    tracing.restore(values)
    assert tracing.snapshot() == values
    ip.reset_launch_counts()
    assert tracing.COUNTERS["input_pipeline"] == {"light_pipeline_kernel": 0}


def test_train_trace_carries_the_spans(tmp_path, monkeypatch):
    """The loop's `profile_dir` trace holds the epoch's spans on a track of
    their own, on the trace's time base: each draw (`aten::rand`) lies
    inside a `chunk.draws` span, each span inside its `chunk`."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(REPO / "config" / "train_nnue_test.py"))
    cfg.log_dir = str(tmp_path / "logs")
    cfg.profile_dir = str(tmp_path / "trace")
    cfg.use_augmentation = True  # the light tier: the fused chunk
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    doc = json.loads((tmp_path / "trace" / "train_epoch0.trace.json").read_text())
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert {e["pid"] for e in spans} == {"program spans"}
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert {"chunk", "chunk.draws", "chunk.pack", "chunk.eager"} <= set(by)
    # the test config: 32 images in batches of 4, one chunk of 8 steps
    assert [e["args"]["steps"] for e in by["chunk"]] == [8]

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])
    for e in spans:
        if e["name"] != "chunk":
            assert e["args"]["parent"] == "chunk"
            assert any(inside(e, c) for c in by["chunk"])
    rand = [e for e in events if e.get("name") == "aten::rand"]
    assert rand and all(any(inside(r, d) for d in by["chunk.draws"])
                        for r in rand)
