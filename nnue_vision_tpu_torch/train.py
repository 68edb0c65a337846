"""Training CLI of the PyTorch port (port of the root `train.py:22-161`).

    python -m nnue_vision_tpu_torch.train nnue \\
        --config config/train_nnue_hard.py            # on the card
    python -m nnue_vision_tpu_torch.train nnue \\
        --config config/train_nnue_test.py --device cpu
    python -m nnue_vision_tpu_torch.train nnue \\
        --config config/train_nnue_qat_bf16.py --dataset_name synthetic-hard \\
        --synthetic_size 50000                        # bf16 compute
    python -m nnue_vision_tpu_torch.train etinynet \\
        --config config/train_etinynet.py --dataset_name synthetic-hard \\
        --synthetic_size 50000                        # on the card
    python -m nnue_vision_tpu_torch.train etinynet \\
        --config config/train_etinynet_distill.py \\
        --distill_from logs/checkpoints/<run>/best_model.ckpt
    python -m nnue_vision_tpu_torch.train etinynet \\
        --config config/train_etinynet_test.py --device cpu
    python -m nnue_vision_tpu_torch.train etinynet \\
        --config config/train_etinynet_imagenet.py    # 224×224, on the card
    NV_SKIP_ENGINE=1 python -m nnue_vision_tpu_torch.train etinynet \\
        --config config/train_etinynet_imagenet.py --etinynet_variant micro \\
        --batch_size 4 --synthetic_size 8 --max_epochs 1 --device cpu

The port trains NNUE and EtinyNet on one device: the CUDA card unless
--device names another (the root CLI likewise trains on JAX's default
device, the accelerator); without a card, --device cuda raises rather
than train on the CPU. Before the first step the C++ engine is built into
build/torch_engine/ and probed with four training images, as the root CLI
does (NV_SKIP_ENGINE=1 skips it). The overrides are the root CLI's that
apply to these models, plus --etinynet_variant (a narrower EtinyNet, e.g.
the micro one for a CPU run of a production config) and --synthetic_size,
which sizes a synthetic training set (the production configs name CIFAR-10 and ImageNet, whose
files the repository does not hold: a dataset that is not on disk, under
data/raw or NV_DATA_DIR, trains on its synthetic fallback at its native
size, 224×224 for ImageNet); runs are tracked locally under --log_dir.
A config with checkpoint_backend="orbax" and resume=True continues from
its latest step checkpoint.

Data-parallel training (one process per card, as the root CLI's default
mesh spans every local chip): on a host with several visible cards, a
plain run with max_devices other than 1 starts one worker per card (NCCL,
a local rendezvous); under torchrun each process joins the group torchrun
describes; across hosts, or on the CPU (gloo), give each process
--coordinator, --num-hosts and --process-id:

    torchrun --nproc_per_node 4 -m nnue_vision_tpu_torch.train nnue \
        --config config/train_nnue_hard.py
    python -m nnue_vision_tpu_torch.train nnue --config config/train_nnue_test.py \
        --device cpu --coordinator file:///tmp/rdv --num-hosts 2 --process-id 0
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

import torch

from config import ConfigError, load_config
from nnue_vision_tpu_torch.parallel.distributed import (
    initialize_distributed,
    spawn,
)
from nnue_vision_tpu_torch.training.logging import early_log

_OVERRIDES = (
    "batch_size", "max_epochs", "learning_rate", "note", "use_augmentation",
    "augmentation_strength", "num_classes", "dataset_name", "seed",
    "synthetic_class_seed", "synthetic_size", "ef_warmup_epochs",
    "checkpoint_metric", "distill_from",
    "eval_train_samples", "eval_batch_size", "etinynet_variant",
)


def setup_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train NNUE and EtinyNet models with the PyTorch port",
        epilog="Before the first step the C++ engine is built "
               "(build/torch_engine/) and probed; NV_SKIP_ENGINE=1 skips "
               "that and turns compiled_backend 'engine' into 'sim'.",
    )
    parser.add_argument("model_type", choices=["nnue", "etinynet"],
                        help="Model type to train")
    parser.add_argument("--config", type=str, help="Path to the configuration file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on: cuda (default), "
                             "cuda:N, cpu; cuda raises where there is no card")
    parser.add_argument("--batch_size", type=int, help="Override batch size")
    parser.add_argument("--max_epochs", type=int, help="Override max epochs")
    parser.add_argument("--learning_rate", type=float, help="Override learning rate")
    parser.add_argument("--note", type=str, help="Note to add to the run")
    parser.add_argument("--wandb-run-id", type=str, help="Name of the local run")
    parser.add_argument("--log_dir", type=str, default="logs",
                        help="Directory for logs and checkpoints")
    parser.add_argument("--use_augmentation", type=lambda x: x.lower() == "true",
                        help="Enable data augmentation (true/false)")
    parser.add_argument("--augmentation_strength",
                        choices=["light", "medium", "heavy"],
                        help="Augmentation strength")
    parser.add_argument("--dataset_name", type=str,
                        choices=["cifar10", "cifar100", "imagenet", "synthetic",
                                 "synthetic-hard"],
                        help="Dataset to use")
    parser.add_argument("--num_classes", type=int, help="Number of classes")
    parser.add_argument("--seed", type=int, help="Override training/data seed")
    parser.add_argument("--synthetic_class_seed", type=int,
                        help="Synthetic-hard generator variant")
    parser.add_argument("--synthetic_size", type=int,
                        help="Training images of a synthetic dataset")
    parser.add_argument("--etinynet_variant",
                        choices=["1.0", "0.75", "0.98M", "micro"],
                        help="Override the EtinyNet width variant")
    parser.add_argument("--distill_from", type=str,
                        help="Checkpoint path of a frozen teacher for "
                             "knowledge distillation")
    parser.add_argument("--ef_warmup_epochs", type=int,
                        help="Override progressive-QAT warmup epochs")
    parser.add_argument("--name_suffix", type=str,
                        help="Suffix appended to the config name")
    parser.add_argument("--checkpoint_metric", choices=["val_f1", "compiled_f1"],
                        help="Best-model gate: float val F1 (default) or the "
                             "deployed int8 compiled F1")
    parser.add_argument("--eval_train_samples", type=int,
                        help="Evaluate per-epoch train metrics on only the "
                             "first N samples")
    parser.add_argument("--eval_batch_size", type=int,
                        help="Batch size for per-epoch evals")
    parser.add_argument("--coordinator", type=str,
                        help="Rendezvous of a data-parallel run, host:port or "
                             "a file:// URL (torchrun's MASTER_ADDR:MASTER_PORT "
                             "when absent); a process drives one card")
    parser.add_argument("--num-hosts", type=int,
                        help="Processes (cards) in the run (torchrun's "
                             "WORLD_SIZE when absent)")
    parser.add_argument("--process-id", type=int,
                        help="This process's rank (torchrun's RANK when absent)")
    return parser


def load_and_setup_config(args: argparse.Namespace, model_type: str):
    if args.config is None:
        args.config = f"config/train_{model_type}_default.py"
    early_log(f"Loading configuration: {args.config}")
    config = load_config(args.config)
    early_log(f"Configuration loaded: {config.name}")
    for attr in _OVERRIDES:
        value = getattr(args, attr, None)
        if value is not None:
            setattr(config, attr, value)
    if args.log_dir:
        config.log_dir = args.log_dir
    if args.name_suffix:
        config.name = f"{config.name}_{args.name_suffix}"
    return config


def _one_worker_per_card(args, config) -> int:
    """The number of local cards to start one worker each on: those visible,
    for a plain run (no group given, none from torchrun) on the default
    card with max_devices other than 1; else 0."""
    if (args.coordinator or args.num_hosts or "WORLD_SIZE" in os.environ
            or args.device != "cuda" or not torch.cuda.is_available()
            or int(getattr(config, "max_devices", 0) or 0) == 1):
        return 0
    count = torch.cuda.device_count()
    return count if count > 1 else 0


def _card_worker(rank: int, argv, coordinator: str, nprocs: int) -> None:
    rc = main(list(argv) + ["--coordinator", coordinator, "--num-hosts",
                            str(nprocs), "--process-id", str(rank)])
    if rc:
        sys.exit(rc)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = setup_argument_parser().parse_args(argv)
    try:
        config = load_and_setup_config(args, args.model_type)
    except ConfigError as e:
        early_log(f"Error loading configuration: {e}")
        return 1

    cards = _one_worker_per_card(args, config)
    if cards:
        with socket.socket() as s:  # a free local port for the rendezvous
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        early_log(f"{cards} cards visible: one worker each (NCCL)")
        spawn(_card_worker, cards, (argv, f"127.0.0.1:{port}", cards),
              timeout_s=None)
        return 0

    from nnue_vision_tpu_torch.training.loop import train_model

    joined = initialize_distributed(
        args.coordinator, args.num_hosts, args.process_id,
        backend="gloo" if torch.device(args.device).type == "cpu" else None)
    try:
        return train_model(config, args.model_type,
                           wandb_run_id=args.wandb_run_id, device=args.device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
