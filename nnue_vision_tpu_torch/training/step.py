"""The train and eval steps of both model families (port of
`nnue_vision_tpu/training/step.py:23-112, 178-328`).

The JAX package's steps are jitted pure functions over a TrainState
pytree; here a step runs eagerly and updates the model's parameters, its
norm statistics (an EtinyNet's running mean and variance, which a
training-mode forward updates in place: JAX's `new_stats`) and the
optimizer state in place. The loss is cross-entropy; after every optimizer
step an NNUE's FT and classifier weights are clipped to [-1, 1] (an
EtinyNet's are not, as in JAX).

`scanned_train_steps` is JAX's K optimizer steps in one device dispatch
(its jitted `lax.scan`): all K steps' host draws are made first, in the
order K `gathered_train_step` calls make them, and packed with the batch
indices and each step's optimizer scalars (`Optimizer.step_scalars`) into
one (K, S) int32 buffer, uploaded once; then per step: gather the rows,
apply the tier (`data/augment.py` `apply_draws`: K4 and K5 on the medium
and heavy tiers), normalize, train. `scanned_train_steps_fused` is the
fused light-tier chunk: per step one K3 launch (`fused_light_pipeline`)
and one train step. Both return the steps' metrics as (K,) tensors, so
a chunk syncs with the host once.

On a card a chunk is a CUDA graph (`ChunkGraph`, held by the TrainState):
the first full chunk of a signature (the model, its config and buffers,
the optimizer and its state's buffers, the data, tier, teacher, K, B and
device) runs eagerly on a side stream, the warm-up that capture needs;
the second captures the K-step body, and every later one is one copy of
its packed draws into the graph's static buffer and one `replay()`. A
changed signature drops the graph and starts again. A failed capture or
replay raises; nothing falls back. On the CPU, and under a mesh (a gloo
all-reduce can not be captured), the same body runs eagerly. Either way
the result equals K `gathered_train_step` calls bit for bit.

Tracing (`tracing.py`): while a profiler runs, a chunk records the span
`chunk` and within it `chunk.draws` (with the host generator calls it
made), `chunk.pack`, `chunk.load`, and `chunk.capture`, `chunk.replay` or
`chunk.eager`; a capture counts the graph's nodes by phase (`PHASES`),
each phase's end marked in the body and in `train_step`.

Data parallelism (a `Mesh` in the TrainState, `parallel/mesh.py`): each
rank holds the whole model and trains on its shard of the global batch.
Between `torch.autograd.grad` and the optimizer the gradients are averaged
over the mesh in one float32 all-reduce, the step's loss and accuracy with
them (JAX's GSPMD psum; `.grad` stays empty, so DDP's reducer would never
fire), so the global-norm clip sees the reduced gradients, as in JAX. Every
rank draws the augmentation of the *global* batch from the same generator
stream, as JAX draws outside `shard_map`, and keeps its rows, so a dp run
computes what one process computes on the whole batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.data.augment import (
    DRAWS,
    apply_draws,
    batch_draws,
    draw_batch,
    draw_specs,
    field_views,
    normalize_images,
    pack_fields,
    packed_size,
    preprocess_batch,
    shard_rows,
)
from nnue_vision_tpu_torch.models.nnue import NNUE, nnue_clip_weights
from nnue_vision_tpu_torch.ops.input_pipeline import (
    LightParams,
    draw_light_params,
    fused_light_pipeline,
    identity_light_params,
)
from nnue_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce,
    average_gradients,
    shard_map,
)
from nnue_vision_tpu_torch.tracing import span
from nnue_vision_tpu_torch.training.optim import SCALARS, Optimizer, OptState

_I32, _F32 = torch.int32, torch.float32
# a captured chunk's parts, in order: per step the input (gather, K3 or the
# tier's K4/K5, normalize), the model (forward, loss, autograd.grad) and
# the update (optimizer, clip, accuracy); then the chunk's tail (the stack)
PHASES = ("input", "model", "update", "tail")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and norm statistics), the optimizer state,
    the step count, the mesh the step runs over (None: one process), and on
    a card the CUDA graph of the last full chunk's signature."""
    model: nn.Module
    opt_state: OptState
    step: int = 0
    mesh: Optional[Mesh] = None
    chunk_graph: Optional["ChunkGraph"] = dataclasses.field(default=None,
                                                            repr=False)


def make_train_state(model: nn.Module, optimizer: Optimizer,
                     mesh: Optional[Mesh] = None) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())),
                      mesh=mesh)


def data_shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this rank's index, the number of shards) of the global batch along
    the mesh's data axis; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    axis = mesh.axis(DATA_AXIS)
    return axis.index, axis.size


def _sq_norm(model: nn.Module):
    """The squared global norm of a tensor-parallel model's gradients: the
    replicated ones whole here, the shards' parts summed over the model
    axis. None for an unsharded model (the optimizer's own sum)."""
    sharded = set(getattr(model, "tp_sharded", ()))
    if not sharded:
        return None

    def sq(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        whole = sum(torch.sum(g * g) for n, g in grads.items() if n not in sharded)
        part = sum(torch.sum(g * g) for n, g in grads.items() if n in sharded)
        return whole + all_reduce(part, model.tp_axis)

    return sq


@dataclasses.dataclass(frozen=True)
class Teacher:
    """A frozen model whose softened logits the student also fits: weight
    `alpha` on the hard-label CE, 1 − alpha on the teacher term, at
    temperature `temp`."""
    model: nn.Module
    alpha: float = 0.5
    temp: float = 4.0


def distillation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      images: torch.Tensor, teacher: Optional[Teacher]
                      ) -> torch.Tensor:
    """The CE of `logits`, and with a teacher the JAX package's
    alpha·CE + (1 − alpha)·T²·CE(logits / T, softmax(teacher(images) / T))."""
    loss = F.cross_entropy(logits, labels)
    if teacher is None:
        return loss
    with torch.no_grad():
        t_logits = teacher.model.eval()(images)
    temp = teacher.temp
    t_prob = torch.softmax(t_logits / temp, dim=-1)
    kd = -(t_prob * F.log_softmax(logits / temp, dim=-1)).sum(dim=-1).mean()
    return teacher.alpha * loss + (1.0 - teacher.alpha) * (temp * temp) * kd


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               *, optimizer: Optimizer, teacher: Optional[Teacher] = None,
               scalars: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on normalized images (B, H, W, 3) and labels (B,),
    then, for an NNUE, the FT and classifier weights clipped to [-1, 1].
    Under a mesh the images and labels are this rank's shard, and the
    gradients, loss and accuracy are averaged over the mesh first.
    `scalars`: the step's optimizer scalars on the device (`Optimizer.step`).
    Returns {"loss", "accuracy"} as device scalars."""
    model = state.model.train()
    params = dict(model.named_parameters())
    logits = model(images)
    loss = distillation_loss(logits, labels, images, teacher)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))
    _phase_end("model")
    loss = loss.detach()
    acc = (logits.detach().argmax(dim=-1) == labels).to(torch.float32).mean()
    if state.mesh is not None:
        grads, (loss, acc) = average_gradients(
            state.mesh, grads, params,
            sharded=getattr(model, "tp_sharded", ()), scalars=(loss, acc))
    optimizer.step(params, grads, state.opt_state, sq_norm=_sq_norm(model),
                   scalars=scalars)
    if isinstance(model, NNUE):
        nnue_clip_weights(model)
    state.step += 1
    _phase_end("update")
    return {"loss": loss, "accuracy": acc}


def _check_indices(idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"batch indices outside [0, {n})")


def gathered_train_step(state: TrainState, device_images: torch.Tensor,
                        device_labels: torch.Tensor, idx: np.ndarray,
                        gen: torch.Generator, *, optimizer: Optimizer,
                        strength: str = "medium", augment: bool = True,
                        noise_gen: Optional[torch.Generator] = None,
                        teacher: Optional[Teacher] = None
                        ) -> Dict[str, torch.Tensor]:
    """Gather a batch by index from the device-resident dataset, augment,
    normalize, train one step. The medium and heavy tiers draw their noise
    from `noise_gen`, a generator on the dataset's device. Under a mesh
    `idx` is the global batch: this rank gathers and trains on its rows,
    augmented with its rows of the global batch's draws."""
    idx = np.asarray(idx)
    _check_indices(idx, device_labels.shape[0])
    shard = data_shard(state.mesh)
    idx = idx[shard_rows(len(idx), shard)]
    i = torch.as_tensor(idx, dtype=torch.int64).to(device_images.device)
    x = preprocess_batch(gen, device_images[i], strength=strength,
                         augment=augment, noise_gen=noise_gen, shard=shard)
    return train_step(state, x, device_labels[i], optimizer=optimizer,
                      teacher=teacher)


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    """The CUDA driver, with the two queries the chunk graph asks."""
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    driver.cuGraphGetNodes.restype = ctypes.c_int
    driver.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_void_p]
    driver.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
    return driver


def _nodes_of(raw_graph: int) -> int:
    """The nodes of a CUDA graph (a `CUgraph` handle), asked of the driver."""
    n = ctypes.c_size_t(0)
    err = _driver().cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph (kept with `keep_graph=True`)."""
    return _nodes_of(graph.raw_cuda_graph())


class _PhaseNodes:
    """The nodes a capture on `stream` adds in each of `PHASES`: each mark
    counts the nodes of the graph under capture (`cuStreamGetCaptureInfo`
    gives it; the driver answers queries on it while capture runs) and
    credits those since the last mark to the phase that ends there."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream.cuda_stream
        self.nodes = dict.fromkeys(PHASES, 0)
        self.last = 0

    def mark(self, phase: str) -> None:
        status, graph = ctypes.c_int(0), ctypes.c_void_p(None)
        err = _driver().cuStreamGetCaptureInfo_v2(
            self.stream, ctypes.byref(status), None, ctypes.byref(graph),
            None, None)
        if err != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"cuStreamGetCaptureInfo: CUresult {err}, "
                               f"capture status {status.value}")
        n = _nodes_of(graph.value)
        self.nodes[phase] += n - self.last
        self.last = n


# the phase count of the capture running, set by ChunkGraph._capture alone
_capturing: Optional[_PhaseNodes] = None


def _phase_end(phase: str) -> None:
    """Where a phase of a step ends: counted while a chunk is captured, a
    no-op otherwise (eagerly, on the CPU, in a replay)."""
    if _capturing is not None:
        _capturing.mark(phase)


def _buffers(model: nn.Module, opt_state: OptState) -> Tuple[int, ...]:
    """The addresses a captured step reads and writes: the model's
    parameters and buffers, and the optimizer state's buffers."""
    ptrs = [t.data_ptr() for t in model.parameters()]
    ptrs += [t.data_ptr() for t in model.buffers()]
    ptrs += [t.data_ptr() for k, v in sorted(opt_state.items()) if k != "count"
             for t in v.values()]
    return tuple(ptrs)


class ChunkGraph:
    """K train steps of one signature as one CUDA graph (the JAX package's
    jitted `lax.scan` of the step).

    `key` is the signature: tensors enter it as addresses, modules,
    optimizers and generators as themselves (compared by identity), configs
    by value. `buf` is the static (K, S) int32 input the body reads: each
    chunk's packed draws, indices and optimizer scalars are copied into it
    before the chunk runs. The first chunk (`warm_up`) runs the body
    eagerly on the graph's side stream; the next captures it and every one
    after that only replays. A replay runs none of the body's Python: the
    host's optimizer count and step advance by K, and each kernel's launch
    count by the launches its wrapper made during capture (the capture's own
    calls launch nothing and are taken back out). `generators` (the medium
    and heavy tiers' device noise) are registered with the graph, so that
    each replay advances their Philox offset as K eager steps would.
    `phase_nodes` is the graph's nodes by `PHASES`, counted at capture and
    summed over its steps: they add up to `nodes`. The newest capture's are
    also the `tracing` gauge "chunk_graph_nodes".
    """

    def __init__(self, key: tuple, rows: torch.Tensor, device: torch.device,
                 generators: Tuple[torch.Generator, ...] = ()):
        self.key = key
        self.steps = rows.shape[0]
        self.buf = torch.empty(rows.shape, dtype=_I32, device=device)
        self.stream = torch.cuda.Stream(device)
        self.generators = generators
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Dict[str, torch.Tensor] = {}
        self.launches: Dict[Tuple[str, str], int] = {}
        self.capture_s = self.instantiate_s = 0.0
        self.nodes = 0
        self.phase_nodes: Dict[str, int] = {}
        self.replays = 0

    def _load(self, rows: torch.Tensor) -> None:
        # pinned, so the copy is queued on the stream; the host's caching
        # allocator keeps the pinned block until the copy has run
        with span("chunk.load"):
            self.buf.copy_(rows.pin_memory(), non_blocking=True)

    def warm_up(self, rows: torch.Tensor, body: Callable) -> Dict[str, torch.Tensor]:
        self._load(rows)
        current = torch.cuda.current_stream(self.buf.device)
        self.stream.wait_stream(current)
        with span("chunk.eager"), torch.cuda.stream(self.stream):
            out = body(self.buf)
        current.wait_stream(self.stream)
        return out

    def _capture(self, state: TrainState, body: Callable) -> None:
        global _capturing
        count, step = state.opt_state["count"], state.step
        before = tracing.snapshot()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        phases = _PhaseNodes(self.stream)
        try:
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self.stream):
                _capturing = phases
                out = body(self.buf)
                _capturing = None
            t1 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s = time.perf_counter() - t1
            self.capture_s = t1 - t0
            after = tracing.snapshot()
            self.launches = {k: after[k] - before[k] for k in before
                             if after[k] != before[k]}
        finally:
            _capturing = None
            tracing.restore(before)
            state.opt_state["count"], state.step = count, step
        self.nodes = _graph_nodes(graph)
        self.phase_nodes = phases.nodes
        tracing.GAUGES["chunk_graph_nodes"] = dict(phases.nodes)
        self.graph, self.out = graph, out

    def run(self, state: TrainState, rows: torch.Tensor,
            body: Callable) -> Dict[str, torch.Tensor]:
        """One chunk: load `rows`, capture on the first call, replay."""
        self._load(rows)
        if self.graph is None:
            with span("chunk.capture"):
                self._capture(state, body)
        with span("chunk.replay"):
            self.graph.replay()
        self.replays += 1
        state.opt_state["count"] += self.steps
        state.step += self.steps
        tracing.add(self.launches)
        state.model.train()
        return {k: v.clone() for k, v in self.out.items()}

    def describe(self) -> str:
        return (f"graphed: {self.steps} steps as one CUDA graph of "
                f"{self.nodes} nodes, captured in {self.capture_s:.3f} s and "
                f"instantiated in {self.instantiate_s:.3f} s")


def _run_chunk(state: TrainState, device: torch.device, key: tuple,
               rows: torch.Tensor, body: Callable,
               generators: Tuple[torch.Generator, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    """`body` (K steps reading their inputs from a (K, S) int32 tensor on
    `device`) on the chunk's packed host `rows`: eagerly on the CPU and
    under a mesh, else through the state's `ChunkGraph` for `key`."""
    if device.type != "cuda" or state.mesh is not None:
        with span("chunk.load"):
            buf = rows.to(device)
        with span("chunk.eager"):
            return body(buf)
    graph = state.chunk_graph
    if graph is None or graph.key != key:
        state.chunk_graph = None  # the old graph's memory goes first
        graph = ChunkGraph(key, rows, device, generators)
        out = graph.warm_up(rows, body)
        state.chunk_graph = graph
        return out
    return graph.run(state, rows, body)


def _stack(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    out = {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}
    _phase_end("tail")
    return out


def _chunk_span(fn: Callable) -> Callable:
    """`fn`, a chunk call, inside the span `chunk` with its `steps`."""
    @functools.wraps(fn)
    def chunk(state, data, labels, idx_chunk, *args, **kwargs):
        with span("chunk", steps=len(idx_chunk)):
            return fn(state, data, labels, idx_chunk, *args, **kwargs)
    return chunk


@_chunk_span
def scanned_train_steps(state: TrainState, device_images: torch.Tensor,
                        device_labels: torch.Tensor, idx_chunk: np.ndarray,
                        gen: torch.Generator, *, optimizer: Optimizer,
                        strength: str = "medium", augment: bool = True,
                        noise_gen: Optional[torch.Generator] = None,
                        teacher: Optional[Teacher] = None
                        ) -> Dict[str, torch.Tensor]:
    """K = len(idx_chunk) `gathered_train_step`s in one dispatch (JAX's
    `scanned_train_steps`): `idx_chunk` (K, B) the batches' indices (under
    a mesh the global batches, of which this rank trains its rows). Every
    host draw of the K steps is made first, in the order K
    `gathered_train_step` calls make them, so the generators end where
    theirs do and the result is theirs bit for bit. The medium and heavy
    tiers need `noise_gen`. Returns {"loss", "accuracy"} as (K,) tensors."""
    idx_chunk = np.asarray(idx_chunk)
    steps, batch = idx_chunk.shape
    _check_indices(idx_chunk, device_labels.shape[0])
    if augment and strength != "light" and noise_gen is None:
        raise ValueError("the medium and heavy tiers draw their noise from "
                         "noise_gen; pass one")
    shard = data_shard(state.mesh)
    idx_chunk = idx_chunk[:, shard_rows(batch, shard)]
    b = idx_chunk.shape[1]
    h, w = device_images.shape[1], device_images.shape[2]
    with span("chunk.draws") as sp:
        calls = DRAWS["host_draw_calls"]
        draws = [draw_batch(gen, strength, batch, h, w, shard) if augment
                 else torch.zeros(0, dtype=_I32) for _ in range(steps)]
        sp.count(draw_calls=DRAWS["host_draw_calls"] - calls)
    with span("chunk.pack"):
        scalars = optimizer.step_scalars(state.opt_state["count"], steps)
        rows = torch.stack([pack_fields([
            torch.from_numpy(idx_chunk[k]).to(_I32), draws[k],
            torch.from_numpy(scalars[k])]) for k in range(steps)])
    n_draws = packed_size(draw_specs(strength, b)) if augment else 0
    specs = [((b,), _I32), ((n_draws,), _I32), ((SCALARS,), _F32)]

    def body(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        metrics = []
        for k in range(steps):
            i, draws, sc = field_views(buf[k], specs)
            x = device_images.index_select(0, i)
            if augment:
                x = apply_draws(x, batch_draws(draws, strength, b), noise_gen,
                                shard)
            x, y = normalize_images(x), device_labels.index_select(0, i)
            _phase_end("input")
            metrics.append(train_step(state, x, y, optimizer=optimizer,
                                      teacher=teacher, scalars=sc))
        return _stack(metrics)

    model = state.model
    key = ("gathered", model, model.cfg, _buffers(model, state.opt_state),
           optimizer, device_images.device, device_images.data_ptr(), tuple(device_images.shape),
           device_labels.data_ptr(), strength if augment else None, teacher,
           noise_gen, steps, b)
    gens = (noise_gen,) if augment and strength != "light" else ()
    return _run_chunk(state, device_images.device, key, rows, body, gens)


@_chunk_span
def scanned_train_steps_fused(state: TrainState, gather_dataset: torch.Tensor,
                              device_labels: torch.Tensor,
                              idx_chunk: np.ndarray, gen: torch.Generator, *,
                              optimizer: Optimizer, height: int, width: int,
                              identity_augment: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """K train steps of the light tier with the whole input path in one K3
    launch per step. The (K, B) draws are made once, on the host, and the
    effective indices (flip folded in as +N) are checked there, while they
    are numpy. Under a mesh `idx_chunk` holds the global batches: the draws
    are the global batches', and this rank takes its columns of the
    indices, draws and labels before its K3 launches.

    `identity_augment`: no flip, α = 1, β = 0, no hole (JAX's option), so
    the step equals the unaugmented one."""
    idx_chunk = np.asarray(idx_chunk)
    steps, batch = idx_chunk.shape
    n = device_labels.shape[0]
    _check_indices(idx_chunk, n)
    with span("chunk.draws") as sp:
        calls = DRAWS["host_draw_calls"]
        params = (identity_light_params(steps, batch) if identity_augment
                  else draw_light_params(gen, steps, batch, height, width))
        sp.count(draw_calls=DRAWS["host_draw_calls"] - calls)
    with span("chunk.pack"):
        idx_eff = idx_chunk + n * params.flip.numpy().astype(np.int64)
        _check_indices(idx_eff, 2 * n)
        cols = shard_rows(batch, data_shard(state.mesh))
        idx_chunk, idx_eff = idx_chunk[:, cols], idx_eff[:, cols]
        params = LightParams(*(t[:, cols].contiguous() for t in params))
        b = idx_chunk.shape[1]
        scalars = optimizer.step_scalars(state.opt_state["count"], steps)
        rows = torch.stack([pack_fields([
            torch.from_numpy(idx_eff[k]).to(_I32),
            torch.from_numpy(idx_chunk[k]).to(_I32), params.pf[k],
            params.pi[k], torch.from_numpy(scalars[k])]) for k in range(steps)])
    specs = [((b,), _I32), ((b,), _I32), ((b, 2), _F32), ((b, 4), _I32),
             ((SCALARS,), _F32)]

    def body(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        metrics = []
        for k in range(steps):
            i_eff, i, pf, pi, sc = field_views(buf[k], specs)
            x = fused_light_pipeline(gather_dataset, i_eff, pf, pi, h=height,
                                     w=width)
            y = device_labels.index_select(0, i)
            _phase_end("input")
            metrics.append(train_step(state, x, y, optimizer=optimizer,
                                      scalars=sc))
        return _stack(metrics)

    model = state.model
    key = ("fused", model, model.cfg, _buffers(model, state.opt_state),
           optimizer, gather_dataset.device, gather_dataset.data_ptr(), tuple(gather_dataset.shape),
           device_labels.data_ptr(), steps, b)
    return _run_chunk(state, gather_dataset.device, key, rows, body)


@torch.no_grad()
def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
              mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE loss over the batch, logits), the model in eval mode (an
    EtinyNet normalizes with its running statistics). Under a mesh each
    rank runs its rows of the batch and the logits are gathered: every
    rank gets the whole batch's."""
    model = model.eval()
    logits = model(images) if mesh is None else shard_map(model, mesh)(images)
    return F.cross_entropy(logits, labels, reduction="sum"), logits
