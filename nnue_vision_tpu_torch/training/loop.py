"""The training loop: train_model(config, "nnue" | "etinynet"), on one
device or data-parallel over a process group.

Port of `nnue_vision_tpu/training/loop.py:57-90, 103-668`, with the same
control flow, so the same steps take the same path: a training set that
fits `device_resident_max_bytes` is uploaded once and batches are gathered
by index on the device; full chunks of `steps_per_dispatch` steps run
through `scanned_train_steps_fused` (one K3 launch per step) for an NNUE
on the light augmentation tier when 3× the dataset fits, else through
`scanned_train_steps` (the medium and heavy tiers: one warp (K4) and one
photometric (K5) launch per block), each a CUDA graph on the card (the
log names each graph when it is captured) and eager on the CPU and under
a mesh; a last partial chunk runs step by step through
`gathered_train_step`. The losses come back to the host once per chunk.
Each epoch ends with the non-finite check, float train and val evals,
and the int8 eval (`compiled_backend` "sim",
"pallas" or "mega"), then best-model checkpointing on
`checkpoint_metric`. `ef_warmup_epochs` trains a QAT NNUE without
rounding first, and an engine_friendly EtinyNet as its continuous
engine-structured model (`ef_quantizers=False`), then switches the model's
config to the quantized one and restarts the optimizer
(`ef_finetune_restart`); only an epoch after the switch can become the
best model. A final test eval closes the run.

The trainer runs on the CUDA card unless `device` names another; asking
for CUDA on a host without it raises. It sets
`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`
to False, so the float conv and matmuls compute in float32 as the JAX
reference does. With `profile_dir` set, the training steps of the first
epoch run under `torch.profiler` (CPU and, on the card, CUDA activities;
the JAX loop traces the same span with `jax.profiler`), and the trace is
written to `profile_dir/train_epoch0.trace.json` for chrome://tracing or
Perfetto, with the program's spans of the epoch (`tracing.py`: the chunk's
draws, pack, load, capture, replay) on a track of their own.

Both families train in float32 or bfloat16 (`dtype`: the conv and matmul
stack computes in it, the params stay float32); an EtinyNet also in
float64, a verification mode (`models/etinynet.py`). An EtinyNet's int8 eval
is the engine sim whatever `compiled_backend` says, as in the JAX package.

The C++ engine is held to the trained model as in the JAX loop: before the
first step the engine's tools are built (`training/engine_build.py`, into
`build/torch_engine/`) and four training images go through the engine
with the initial weights (with NNUE_SANITIZER_SMOKE=1 also the sanitizer
build and its smoke test), and `compiled_backend="engine"` takes every
epoch's int8 metrics from the engine binary. NV_SKIP_ENGINE=1 skips the
probe and turns "engine" into "sim", as in JAX; unlike the JAX loop it
leaves "mega" and "pallas" as configured, since they run the card's
kernels, give the sim's bits and need no engine build.

`distill_from` names a best-model checkpoint of the same model type (the
port's or the JAX package's pickle) whose logits the student also fits
(`distill_alpha`, `distill_temp`; `training/step.py`); the fused K3 path
is off then, as in JAX. `checkpoint_backend="orbax"` writes a
`StepCheckpointer` step every epoch under `orbax_dir` (default
`log_dir/orbax/<run name>`), keeping `orbax_max_to_keep`; `resume=True`
restores the latest and starts at the epoch after it. The step carries
the model, the optimizer state (its count carries the LR schedule on), the
best gate value so far, and, unlike the JAX package, whose resumed run
replays epoch 0's shuffle and augmentation draws, the host and device
generators and the loader's epoch: on the CPU a resumed run equals an
uninterrupted one bit for bit.

Data parallelism, as the JAX loop trains on a data mesh over every local
chip: in a process group (`parallel/distributed.py`; one process per
card) the loop trains over the largest n ≤ min(ranks, `max_devices` or
all) that divides `batch_size` (JAX's width rule), so `max_devices=1`
stays on one card; a rank outside those n says so and takes no step.
Every rank builds the model from the same seed (checked by `replicate`),
holds the whole training set, gathers its rows of each global batch, and
draws the global batch's augmentation (K3, K4 and K5 run on its shard);
the gradients are averaged over the group before the clip and the
optimizer (`training/step.py`), an EtinyNet's norms reduce their
statistics over the global batch, and the evals split each batch and
gather its logits. Rank 0 alone runs the engine probe and the engine
eval (their outcome broadcast, so a failure there stops every rank),
logs, and writes checkpoints, each write followed by a barrier; every
rank reads a resumed step checkpoint.

When the run ends, in success or failure, rank 0 calls `stop_cloud`
unless `keep_alive` is set: on a cloud instance that names itself
(`cloud/launcher.py` `stop_instance`) the instance is deleted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.data.augment import device_generator, preprocess_batch
from nnue_vision_tpu_torch.data.loaders import (
    create_data_loaders,
    head_subset_loader,
)
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNetConfig,
    count_parameters,
    etinynet_init,
)
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
)
from nnue_vision_tpu_torch.ops.engine_sim import resolve_device
from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
from nnue_vision_tpu_torch.parallel.distributed import rank_and_world
from nnue_vision_tpu_torch.parallel.mesh import (
    Mesh,
    bind_data_axis,
    make_mesh,
    replicate,
    shard_batch,
)
from nnue_vision_tpu_torch.training import checkpoint as ckpt
from nnue_vision_tpu_torch.training.engine_build import (
    build_sanitizer_engine,
    compile_cpp_engine,
    smoke_test_sanitizer_engine,
)
from nnue_vision_tpu_torch.training.evaluate import (
    evaluate_compiled_model,
    evaluate_int8_sim,
    evaluate_model,
    maybe_resident,
)
from nnue_vision_tpu_torch.training.logging import (
    default_run_name,
    early_log,
    init_run,
    replay_early_logs,
    set_rank,
)
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    Teacher,
    data_shard,
    gathered_train_step,
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
    train_step,
)
from nnue_vision_tpu_torch.training.utils import check_for_nonfinite

# compiled_backend → evaluate_int8_sim's use_pallas; the fourth backend,
# "engine", runs the C++ engine binary instead
_USE_PALLAS = {"sim": False, "pallas": True, "mega": "mega"}


def build_model(config: Any, model_type: str, generator: torch.Generator,
                device):
    """(model, model_cfg) from an executable config module."""
    input_size = config.input_size
    if isinstance(input_size, (tuple, list)):
        input_size = input_size[0]
    if model_type == "etinynet":
        model_cfg = EtinyNetConfig(
            variant=config.etinynet_variant,
            num_classes=config.num_classes,
            input_size=input_size,
            use_asq=getattr(config, "use_asq", False),
            asq_bits=getattr(config, "asq_bits", 4),
            engine_friendly=getattr(config, "engine_friendly", False),
            dtype=getattr(config, "dtype", "float32"),
        )
        return etinynet_init(model_cfg, generator, device=device), model_cfg
    if model_type != "nnue":
        raise ValueError(f"unknown model type: {model_type}")
    model_cfg = NNUEConfig(
        feature_set=GridFeatureSet(
            grid_size=config.grid_size,
            num_features_per_square=config.num_features_per_square,
        ),
        l1_size=config.l1_size,
        l2_size=config.l2_size,
        l3_size=config.l3_size,
        num_classes=config.num_classes,
        input_size=input_size,
        qat=getattr(config, "qat", False),
        dtype=getattr(config, "dtype", "float32"),
    )
    return nnue_init(model_cfg, generator, device=device), model_cfg


def _check_backend(config: Any) -> None:
    backend = getattr(config, "compiled_backend", "sim")
    if backend != "engine" and backend not in _USE_PALLAS:
        raise ValueError(f"unknown compiled_backend {backend!r}")


def data_parallel_width(config: Any, world: int) -> int:
    """JAX's width rule: the largest n ≤ min(world, `max_devices` or all)
    that divides `batch_size`, so that every shard is equal."""
    n = min(world, int(getattr(config, "max_devices", 0) or 0) or world)
    while n > 1 and config.batch_size % n:
        n -= 1
    return n


def _on_first_rank(mesh: Optional[Mesh], fn, what: str):
    """fn() on the mesh's first rank alone (here without a mesh); the
    outcome is broadcast, so that a failure there raises on every rank
    instead of leaving the others waiting in a collective."""
    if mesh is None:
        return fn()
    result, error = None, None
    if mesh.first:
        try:
            result = fn()
        except Exception as e:  # re-raised below, after the others know
            error = e
    ok, result = mesh.broadcast_object((error is None, result))
    if error is not None:
        raise error
    if not ok:
        raise RuntimeError(f"{what} failed on rank 0")
    return result


def _first_rank_writes(mesh: Optional[Mesh], fn) -> None:
    """fn() (a file write) on the mesh's first rank, then a barrier."""
    if mesh is None or mesh.first:
        fn()
    if mesh is not None:
        mesh.barrier()


def engine_probe(model, dataset, model_type: str) -> None:
    """Build the engine and run four training images through it with the
    current weights (with NNUE_SANITIZER_SMOKE=1 also the sanitizer build
    and its smoke test): raises before any step if the engine cannot
    build or evaluate."""
    compile_cpp_engine(model_type)
    if os.environ.get("NNUE_SANITIZER_SMOKE", "0") == "1":
        build_sanitizer_engine()
        smoke_test_sanitizer_engine(model_type)
    early_log("Testing C++ engine inference with current weights...")
    metrics = evaluate_compiled_model(
        model, [(dataset.images[:4], dataset.labels[:4])])
    early_log(f"Engine OK: f1={metrics['f1']:.4f} "
              f"{metrics['ms_per_sample']:.2f} ms/sample")


def _load_teacher(config: Any, model_type: str, dev: torch.device
                  ) -> Optional[Teacher]:
    """The frozen teacher of `distill_from`, or None."""
    path = getattr(config, "distill_from", None)
    if not path:
        return None
    payload = ckpt.load_checkpoint(Path(path))
    if payload["model_type"] != model_type:
        raise ValueError(
            f"distill_from checkpoint is a {payload['model_type']} model; "
            f"training a {model_type}")
    build = (ckpt.nnue_from_checkpoint if model_type == "nnue"
             else ckpt.etinynet_from_checkpoint)
    model = build(payload, device=dev).eval().requires_grad_(False)
    teacher = Teacher(model, alpha=float(getattr(config, "distill_alpha", 0.5)),
                      temp=float(getattr(config, "distill_temp", 4.0)))
    early_log(f"distilling from {path} (alpha={teacher.alpha}, T={teacher.temp})")
    return teacher


def _start_trace(dev: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace = torch.profiler.profile(activities=activities)
    tracing.clear()
    trace.start()
    return trace


def _span_events(spans, base_ns: int) -> List[Dict[str, Any]]:
    """The program's spans (`tracing.spans()`) as Chrome trace events on a
    track of their own ("program spans"), in µs from `base_ns` (the trace's
    `baseTimeNanoseconds`, on the spans' Unix-epoch clock)."""
    pid = "program spans"
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": pid}}]
    for s in spans:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": 0, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"parent": s.parent, **s.counts}})
    return events


def _stop_trace(trace: torch.profiler.profile, profile_dir: Path,
                dev: torch.device) -> None:
    """Wait for the traced work, stop, and write the Chrome trace with the
    epoch's program spans added as a track of their own."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    trace.stop()
    profile_dir.mkdir(parents=True, exist_ok=True)
    path = profile_dir / "train_epoch0.trace.json"
    trace.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    doc["traceEvents"] += _span_events(tracing.spans(),
                                       doc.get("baseTimeNanoseconds", 0))
    path.write_text(json.dumps(doc))
    early_log(f"profiler trace written to {path}")


def stop_cloud(reason: str = "") -> None:
    """Best-effort stop of the cloud instance this run is on (upstream
    stop_runpod, train.py:450-453; `cloud/launcher.py` `stop_instance`, a
    no-op off the cloud). A failure is logged and swallowed, so shutdown
    never masks the training result."""
    try:
        from nnue_vision_tpu_torch.cloud.launcher import stop_instance

        stop_instance(reason=reason)
    except Exception as e:
        early_log(f"cloud stop failed (ignored): {e}")


def train_model(config: Any, model_type: str,
                wandb_run_id: Optional[str] = None, *, device="cuda") -> int:
    """Train per `config` on `device`; returns 0. `wandb_run_id` names the
    local run. In a process group every rank calls it, each with its card."""
    _check_backend(config)
    dev = resolve_device(device)
    rank, world = rank_and_world()
    set_rank(rank)
    mesh = None
    if world > 1:
        n = data_parallel_width(config, world)
        mesh = make_mesh(n, device=dev)
        width = (f"{n} of {world} ranks (batch_size {config.batch_size}, "
                 f"max_devices {getattr(config, 'max_devices', None)})")
        if not mesh.member:
            print(f"rank {rank}: outside the data-parallel group of {width}; "
                  "no step taken", flush=True)
            return 0
        early_log(f"Data-parallel over {width}")
        if n == 1:
            mesh = None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    early_log(f"Using device {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    run_cfg = {k: v for k, v in vars(config).items() if not k.startswith("__")}
    log_dir = getattr(config, "log_dir", "logs")
    run_id = wandb_run_id or default_run_name()
    if mesh is not None:
        run_id = mesh.broadcast_object(run_id)  # one run on every rank
    run = init_run(getattr(config, "project_name", "nnue_vision_tpu"), run_cfg,
                   run_id=run_id, log_dir=log_dir)
    early_log(f"Run: {run.name} ({run.url})")
    replay_early_logs()
    best_path = Path(log_dir) / "checkpoints" / run.name / "best_model.ckpt"
    steps_ckpt = None
    if getattr(config, "checkpoint_backend", "pickle") == "orbax":
        steps_ckpt = ckpt.StepCheckpointer(
            getattr(config, "orbax_dir", None)
            or Path(log_dir) / "orbax" / run.name,
            max_to_keep=int(getattr(config, "orbax_max_to_keep", 3)))
        early_log(f"step checkpoints → {steps_ckpt.dir}")

    train_loader, val_loader, test_loader = create_data_loaders(
        dataset_name=getattr(config, "dataset_name", "cifar10"),
        batch_size=config.batch_size,
        target_size=None,
        max_samples_per_split=getattr(config, "max_samples_per_split", None),
        subset=getattr(config, "subset", 1.0),
        use_augmentation=getattr(config, "use_augmentation", True),
        augmentation_strength=getattr(config, "augmentation_strength", "medium"),
        seed=getattr(config, "seed", 42),
        synthetic_size=getattr(config, "synthetic_size", 512),
        synthetic_class_seed=getattr(config, "synthetic_class_seed", None),
    )
    if train_loader.dataset.is_synthetic:
        early_log("NOTE: dataset not found on disk — training on synthetic data")

    # one host generator: the init draws first, then every augmentation draw
    gen = torch.Generator().manual_seed(getattr(config, "seed", 42))
    model, model_cfg = build_model(config, model_type, gen, dev)
    early_log(f"Model: {model_type}, parameters: {count_parameters(model):,}")
    if mesh is not None:
        replicate(mesh, model)
        bind_data_axis(model, mesh)

    steps_per_epoch = max(1, len(train_loader))
    optimizer = create_optimizer(config, steps_per_epoch)
    state = make_train_state(model, optimizer, mesh)
    compiled_backend = getattr(config, "compiled_backend", "sim")
    if os.environ.get("NV_SKIP_ENGINE") != "1":
        _on_first_rank(mesh, lambda: engine_probe(
            model, train_loader.dataset, model_type), "the engine probe")
    elif compiled_backend == "engine":
        compiled_backend = "sim"

    use_aug = getattr(config, "use_augmentation", True)
    strength = getattr(config, "augmentation_strength", "medium")
    max_epochs = getattr(config, "max_epochs", 1)
    best_val_f1 = 0.0

    # progressive QAT: warm up on the continuous function of the same
    # family (an engine_friendly EtinyNet without its quantizers, a QAT
    # NNUE without weight/bias rounding), then switch the quantizers on
    # with a fresh optimizer over the remaining epochs
    ef_warmup = int(getattr(config, "ef_warmup_epochs", 0))
    warm_cfg = model_cfg
    if ef_warmup > 0 and getattr(model_cfg, "engine_friendly", False):
        warm_cfg = dataclasses.replace(model_cfg, ef_quantizers=False)
    elif ef_warmup > 0 and getattr(model_cfg, "qat", False):
        warm_cfg = dataclasses.replace(model_cfg, qat_rounding=False)
    else:
        ef_warmup = 0

    def cfg_for(epoch: int):
        return warm_cfg if epoch < ef_warmup else model_cfg

    ft_optimizer = optimizer
    if ef_warmup > 0 and getattr(config, "ef_finetune_restart", True):
        class _FtCfg:  # config may be a module; delegate, override epochs
            def __getattr__(self, name):
                if name == "max_epochs":
                    return int(getattr(config, "max_epochs", 1)) - ef_warmup
                return getattr(config, name)

        ft_optimizer = create_optimizer(_FtCfg(), steps_per_epoch)

    def opt_for(epoch: int):
        return optimizer if epoch < ef_warmup else ft_optimizer

    teacher = _load_teacher(config, model_type, dev)
    distill = {"teacher": teacher} if teacher is not None else {}

    # device-resident training set; batches gathered on the device by index
    device_data = None
    ds = train_loader.dataset
    dataset_bytes = ds.images.nbytes + ds.labels.nbytes
    max_resident = int(getattr(config, "device_resident_max_bytes", 4 << 30))
    if dataset_bytes <= max_resident:
        device_data = (torch.from_numpy(ds.images).to(dev),
                       torch.from_numpy(ds.labels).to(dev))
        early_log(f"training set resident on device ({dataset_bytes / 1e6:.1f} MB)")

    # fused input path (K3); the JAX package's 3x residency gate is kept so
    # the same configs take the same path
    gather_data = None
    if (
        device_data is not None
        and 3 * dataset_bytes <= max_resident
        and model_type == "nnue"
        and use_aug
        and strength == "light"
        and teacher is None
        and bool(getattr(config, "fused_input_pipeline", True))
    ):
        gather_data = prepare_gather_dataset(device_data[0])
        early_log(
            "fused input pipeline active: one gather+augment+normalize kernel "
            "per step" + (" (plain version on the CPU)" if dev.type == "cpu" else "")
        )

    eval_train_loader = train_loader
    eval_train_n = int(getattr(config, "eval_train_samples", 0) or 0)
    eval_bs = getattr(config, "eval_batch_size", None)
    if eval_train_n and eval_train_n < len(ds.labels):
        eval_train_loader = head_subset_loader(train_loader, eval_train_n)
        early_log(f"train-split epoch metrics subsampled to {eval_train_n} samples")
    eval_train_loader = maybe_resident(eval_train_loader, max_resident, dev, eval_bs)
    eval_val_loader = maybe_resident(val_loader, max_resident, dev, eval_bs)
    eval_test_loader = maybe_resident(test_loader, max_resident, dev, eval_bs)

    steps_per_dispatch = int(getattr(config, "steps_per_dispatch", 8))
    profile_dir = getattr(config, "profile_dir", None)
    height, width = int(ds.images.shape[1]), int(ds.images.shape[2])
    # the medium and heavy tiers' noise tensors are drawn on the device
    noise_gen = (device_generator(gen, dev)
                 if use_aug and strength in ("medium", "heavy") else None)

    # the path full chunks take: each captured graph once, when it is
    # captured (its first replay); the eager paths once a run
    eager_logged = []

    def log_chunk_path(state) -> None:
        graph = state.chunk_graph
        if dev.type == "cuda" and mesh is None:
            if graph is not None and graph.replays == 1:
                early_log(f"full chunks {graph.describe()}")
        elif not eager_logged:
            eager_logged.append(True)
            early_log(f"full chunks of {steps_per_dispatch} steps: eager "
                      + ("under a mesh (a gloo all-reduce can not be captured)"
                         if mesh is not None else "on the CPU"))

    start_epoch = 0
    if steps_ckpt is not None and getattr(config, "resume", False):
        latest = steps_ckpt.latest_step()
        if latest is not None:
            saved, meta = steps_ckpt.restore()
            model.load_state_dict(saved["model"])
            state.opt_state = {
                k: v if k == "count" else {n: t.to(dev) for n, t in v.items()}
                for k, v in saved["opt_state"].items()}
            state.step = int(saved["step"])
            gen.set_state(saved["host_generator"])
            if noise_gen is not None:
                noise_gen.set_state(saved["noise_generator"])
            train_loader.epoch = int(saved["loader_epoch"])
            start_epoch = int(meta["epoch"]) + 1
            best_val_f1 = float(meta.get("best_val_f1", 0.0))
            early_log(f"resumed from step checkpoint {latest} → epoch "
                      f"{start_epoch} (best gate F1 so far {best_val_f1:.4f})")

    try:
        for epoch in range(start_epoch, max_epochs):
            if epoch == ef_warmup and ef_warmup > 0 and ft_optimizer is not optimizer:
                state.opt_state = ft_optimizer.init(dict(model.named_parameters()))
                early_log(
                    f"quantizer switch at epoch {epoch}: optimizer restarted "
                    "(fresh moments, cosine over the fine-tune phase)"
                )
            model.cfg = cfg_for(epoch)
            epoch_start = time.perf_counter()
            trace = (_start_trace(dev) if profile_dir and epoch == 0 and rank == 0
                     else None)
            losses = []

            if device_data is not None:
                idx_batches = list(train_loader.iter_indices())
                step_no = 0
                pos = 0
                while pos < len(idx_batches):
                    chunk = idx_batches[pos : pos + steps_per_dispatch]
                    full = len(chunk) == steps_per_dispatch > 1
                    if full and gather_data is not None:
                        chunk_loss = scanned_train_steps_fused(
                            state, gather_data, device_data[1],
                            np.stack(chunk), gen, optimizer=opt_for(epoch),
                            height=height, width=width,
                        )["loss"]
                        log_chunk_path(state)
                    elif full:
                        chunk_loss = scanned_train_steps(
                            state, device_data[0], device_data[1],
                            np.stack(chunk), gen, optimizer=opt_for(epoch),
                            strength=strength, augment=use_aug,
                            noise_gen=noise_gen, **distill,
                        )["loss"]
                        log_chunk_path(state)
                    else:
                        chunk_loss = torch.stack([
                            gathered_train_step(
                                state, device_data[0], device_data[1], idx, gen,
                                optimizer=opt_for(epoch), strength=strength,
                                augment=use_aug, noise_gen=noise_gen,
                                **distill,
                            )["loss"]
                            for idx in chunk
                        ])
                    chunk_losses = chunk_loss.cpu().numpy().tolist()
                    for loss in chunk_losses:
                        losses.append(loss)
                        run.log({"train/loss": loss},
                                step=epoch * steps_per_epoch + step_no)
                        step_no += 1
                    pos += len(chunk)
            else:
                for batch_idx, (images, labels) in enumerate(train_loader):
                    if mesh is not None:  # this rank's rows
                        images, labels = shard_batch(mesh, (images, labels))
                    x = preprocess_batch(
                        gen, torch.from_numpy(images).to(dev),
                        strength=strength, augment=use_aug,
                        noise_gen=noise_gen, shard=data_shard(mesh),
                    )
                    metrics = train_step(
                        state, x, torch.from_numpy(labels).to(dev),
                        optimizer=opt_for(epoch), **distill,
                    )
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    run.log({"train/loss": loss},
                            step=epoch * steps_per_epoch + batch_idx)

            if trace is not None:
                _stop_trace(trace, Path(profile_dir), dev)

            if losses and not np.isfinite(losses[-1]):
                detail = check_for_nonfinite(model, where="params")
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch + 1}: "
                    f"{losses[-1]}; {detail or 'params finite — loss path'}"
                )

            train_loss, train_metrics = evaluate_model(
                model, eval_train_loader, mesh=mesh)
            val_loss, val_metrics = evaluate_model(model, eval_val_loader,
                                                   mesh=mesh)
            if compiled_backend == "engine":
                compiled_metrics = _on_first_rank(
                    mesh, lambda: evaluate_compiled_model(model, val_loader),
                    "the engine eval")
            else:
                compiled_metrics = evaluate_int8_sim(
                    model, eval_val_loader,
                    use_pallas=_USE_PALLAS[compiled_backend], mesh=mesh)

            log_data = {
                "train/epoch_loss": train_loss,
                "train/epoch_f1": train_metrics["f1"],
                "train/epoch_accuracy": train_metrics["acc"],
                "val/loss": val_loss,
                "val/f1": val_metrics["f1"],
                "val/accuracy": val_metrics["acc"],
                "compiled/f1": compiled_metrics["f1"],
                "compiled/accuracy": compiled_metrics["acc"],
                "compiled/ms_per_sample": compiled_metrics["ms_per_sample"],
                "compiled/latent_density": compiled_metrics["latent_density"],
            }
            run.log(log_data, step=(epoch + 1) * steps_per_epoch - 1)
            early_log(
                f"Epoch {epoch + 1}/{max_epochs} [{time.perf_counter() - epoch_start:.1f}s] - "
                f"train loss {train_loss:.4f} f1 {train_metrics['f1']:.4f} | "
                f"val loss {val_loss:.4f} f1 {val_metrics['f1']:.4f} acc {val_metrics['acc']:.4f} | "
                f"compiled f1 {compiled_metrics['f1']:.4f} "
                f"acc {compiled_metrics['acc']:.4f} "
                f"density {compiled_metrics['latent_density']:.4f}"
            )

            # during an ef warmup the model is not the deployable function:
            # only epochs of the final config may become the best model. The
            # JAX package's CheckpointManager gates again on val_f1, which
            # under checkpoint_metric="compiled_f1" skips a new best; the
            # port saves on this gate alone (ROADMAP Queue C)
            gate_f1 = (
                compiled_metrics["f1"]
                if getattr(config, "checkpoint_metric", "val_f1") == "compiled_f1"
                else val_metrics["f1"]
            )
            is_new_best = epoch >= ef_warmup and gate_f1 > best_val_f1
            if is_new_best:
                best_val_f1 = gate_f1
            if steps_ckpt is not None:
                # the best gate value rides along, so a resumed run never
                # overwrites a better best model
                t0 = time.perf_counter()
                _first_rank_writes(mesh, lambda: steps_ckpt.save(epoch, {
                    "model": model.state_dict(),
                    "opt_state": state.opt_state,
                    "step": state.step,
                    "host_generator": gen.get_state(),
                    "noise_generator": (noise_gen.get_state()
                                        if noise_gen is not None else None),
                    "loader_epoch": train_loader.epoch,
                }, metadata={"model_type": model_type, "epoch": epoch,
                             "val_f1": float(val_metrics["f1"]),
                             "best_val_f1": float(best_val_f1)}))
                early_log(f"step checkpoint {epoch} written in "
                          f"{time.perf_counter() - t0:.4f} s")
            if is_new_best:
                _first_rank_writes(mesh, lambda: ckpt.save_checkpoint(
                    best_path,
                    model_type=model_type,
                    model_config=model_cfg,
                    model=model,
                    opt_state=state.opt_state,
                    epoch=epoch,
                    metrics={
                        "val_f1": val_metrics["f1"],
                        "val_loss": val_loss,
                        "compiled_f1": compiled_metrics["f1"],
                    },
                    config_name=getattr(config, "name", ""),
                ))

        model.cfg = model_cfg
        test_loss, test_metrics = evaluate_model(model, eval_test_loader,
                                                 mesh=mesh)
        run.log({"test/f1": test_metrics["f1"], "test/loss": test_loss})
        early_log(
            f"Test: loss {test_loss:.4f} f1 {test_metrics['f1']:.4f} "
            f"acc {test_metrics['acc']:.4f}"
        )
    finally:
        run.finish()
        if rank == 0 and not getattr(config, "keep_alive", False):
            stop_cloud("training finished")
    return 0
