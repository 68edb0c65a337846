"""The training loop on one device: train_model(config, "nnue" |
"etinynet").

Port of `nnue_vision_tpu/training/loop.py:57-90, 103-668`, with the same
control flow, so the same steps take the same path: a training set that
fits `device_resident_max_bytes` is uploaded once and batches are gathered
by index on the device; for an NNUE on the light augmentation tier, when
3× the dataset fits, full chunks of `steps_per_dispatch` steps run through
`scanned_train_steps_fused` (one K3 launch per step), and every other
step through `gathered_train_step` (the medium and heavy tiers: one warp
(K4) and one photometric (K5) launch per block); the losses come back to
the host once per chunk. Each epoch ends with the non-finite check, float
train and val evals, and the int8 eval (`compiled_backend` "sim",
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
Perfetto.

An EtinyNet trains in float32 or bfloat16 (`dtype`); its int8 eval is the
engine sim whatever `compiled_backend` says, as in the JAX package.

Not ported yet, and raising NotImplementedError with the ROADMAP item: a
mesh (`max_devices > 1`), `distill_from`, `checkpoint_backend="orbax"`,
an NNUE `dtype` other than float32, `compiled_backend="engine"`, and the
C++ engine start-up probe,
which the JAX loop runs unless NV_SKIP_ENGINE=1 (set it). Unlike the JAX
loop, NV_SKIP_ENGINE=1 leaves `compiled_backend` as configured: "mega" and
"pallas" run the card's kernels and need no engine build.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

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
from nnue_vision_tpu_torch.training import checkpoint as ckpt
from nnue_vision_tpu_torch.training.evaluate import (
    evaluate_int8_sim,
    evaluate_model,
    maybe_resident,
)
from nnue_vision_tpu_torch.training.logging import (
    early_log,
    init_run,
    replay_early_logs,
)
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    gathered_train_step,
    make_train_state,
    scanned_train_steps_fused,
    train_step,
)
from nnue_vision_tpu_torch.training.utils import check_for_nonfinite

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
    )
    return nnue_init(model_cfg, generator, device=device), model_cfg


def _refuse_unported(config: Any, model_type: str) -> None:
    """NotImplementedError for what the port cannot train yet."""
    backend = getattr(config, "compiled_backend", "sim")
    dtype = getattr(config, "dtype", "float32")
    checks = (
        (os.environ.get("NV_SKIP_ENGINE") != "1",
         "the C++ engine start-up probe (set NV_SKIP_ENGINE=1)",
         "4a (engine-subprocess backend and probe)"),
        (backend == "engine", "compiled_backend='engine'",
         "4a (engine-subprocess backend and probe)"),
        (model_type == "nnue" and dtype != "float32",
         f"NNUE dtype={dtype!r}", "4b (bf16 compute)"),
        (int(getattr(config, "max_devices", 0) or 0) > 1,
         "max_devices > 1 (a data-parallel mesh)", "4c (mesh / DDP)"),
        (bool(getattr(config, "distill_from", None)), "distill_from",
         "4d (distillation)"),
        (getattr(config, "checkpoint_backend", "pickle") == "orbax",
         "checkpoint_backend='orbax'", "4e (orbax resume)"),
    )
    for hit, what, item in checks:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to nnue_vision_tpu_torch yet "
                f"(ROADMAP Queue A item {item})")
    if backend not in _USE_PALLAS:
        raise ValueError(f"unknown compiled_backend {backend!r}")


def _start_trace(dev: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace = torch.profiler.profile(activities=activities)
    trace.start()
    return trace


def _stop_trace(trace: torch.profiler.profile, profile_dir: Path,
                dev: torch.device) -> None:
    """Wait for the traced work, stop, and write the Chrome trace."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    trace.stop()
    profile_dir.mkdir(parents=True, exist_ok=True)
    path = profile_dir / "train_epoch0.trace.json"
    trace.export_chrome_trace(str(path))
    early_log(f"profiler trace written to {path}")


def train_model(config: Any, model_type: str,
                wandb_run_id: Optional[str] = None, *, device="cuda") -> int:
    """Train per `config` on `device`; returns 0. `wandb_run_id` names the
    local run."""
    _refuse_unported(config, model_type)
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    early_log(f"Using device {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    run_cfg = {k: v for k, v in vars(config).items() if not k.startswith("__")}
    log_dir = getattr(config, "log_dir", "logs")
    run = init_run(getattr(config, "project_name", "nnue_vision_tpu"), run_cfg,
                   run_id=wandb_run_id, log_dir=log_dir)
    early_log(f"Run: {run.name} ({run.url})")
    replay_early_logs()
    best_path = Path(log_dir) / "checkpoints" / run.name / "best_model.ckpt"

    train_loader, val_loader, test_loader = create_data_loaders(
        dataset_name=getattr(config, "dataset_name", "cifar10"),
        batch_size=config.batch_size,
        max_samples_per_split=getattr(config, "max_samples_per_split", None),
        subset=getattr(config, "subset", 1.0),
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

    steps_per_epoch = max(1, len(train_loader))
    optimizer = create_optimizer(config, steps_per_epoch)
    state = make_train_state(model, optimizer)
    compiled_backend = getattr(config, "compiled_backend", "sim")

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

    try:
        for epoch in range(max_epochs):
            if epoch == ef_warmup and ef_warmup > 0 and ft_optimizer is not optimizer:
                state.opt_state = ft_optimizer.init(dict(model.named_parameters()))
                early_log(
                    f"quantizer switch at epoch {epoch}: optimizer restarted "
                    "(fresh moments, cosine over the fine-tune phase)"
                )
            model.cfg = cfg_for(epoch)
            epoch_start = time.perf_counter()
            trace = _start_trace(dev) if profile_dir and epoch == 0 else None
            losses = []

            if device_data is not None:
                idx_batches = list(train_loader.iter_indices())
                step_no = 0
                pos = 0
                while pos < len(idx_batches):
                    chunk = idx_batches[pos : pos + steps_per_dispatch]
                    if (gather_data is not None
                            and len(chunk) == steps_per_dispatch > 1):
                        chunk_loss = scanned_train_steps_fused(
                            state, gather_data, device_data[1],
                            np.stack(chunk), gen, optimizer=opt_for(epoch),
                            height=height, width=width,
                        )["loss"]
                    else:
                        chunk_loss = torch.stack([
                            gathered_train_step(
                                state, device_data[0], device_data[1], idx, gen,
                                optimizer=opt_for(epoch), strength=strength,
                                augment=use_aug, noise_gen=noise_gen,
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
                    x = preprocess_batch(
                        gen, torch.from_numpy(images).to(dev),
                        strength=strength, augment=use_aug,
                        noise_gen=noise_gen,
                    )
                    metrics = train_step(
                        state, x, torch.from_numpy(labels).to(dev),
                        optimizer=opt_for(epoch),
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

            train_loss, train_metrics = evaluate_model(model, eval_train_loader)
            val_loss, val_metrics = evaluate_model(model, eval_val_loader)
            compiled_metrics = evaluate_int8_sim(
                model, eval_val_loader, use_pallas=_USE_PALLAS[compiled_backend])

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
            if epoch >= ef_warmup and gate_f1 > best_val_f1:
                best_val_f1 = gate_f1
                ckpt.save_checkpoint(
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
                )

        model.cfg = model_cfg
        test_loss, test_metrics = evaluate_model(model, eval_test_loader)
        run.log({"test/f1": test_metrics["f1"], "test/loss": test_loss})
        early_log(
            f"Test: loss {test_loss:.4f} f1 {test_metrics['f1']:.4f} "
            f"acc {test_metrics['acc']:.4f}"
        )
    finally:
        run.finish()
    return 0
