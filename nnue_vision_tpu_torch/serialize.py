"""Serialize a trained checkpoint to the engine's `.nnue` / `.etiny` format
(the port's counterpart of the repository's root `serialize.py`).

    python -m nnue_vision_tpu_torch.serialize INPUT OUTPUT \\
        [--model-type auto|nnue|etinynet] [--features F] [--force] \\
        [--device cuda]

INPUT is a best-model checkpoint of this package or of the JAX package
(the same pickle payload, `training/checkpoint.py`) or an upstream torch
checkpoint or state dict (`torch_import.py`). The model type is taken from
the checkpoint, or inferred from its parameters; an NNUE checkpoint
without its config gets one inferred from the parameter shapes. The model
is built on `--device` (the card unless the caller names another; without
CUDA that raises), quantized with the port's `nnue_quantize` /
`etinynet_quantize`, written with the port's `formats.py` and read back
to verify it. Given the same float params, the bytes equal those the root
CLI writes. An EtinyNet not trained `engine_friendly` deploys at about
chance through the engine: the file is written, and a warning goes to
stderr unless `--force`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Tuple

from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.formats import read_etiny, read_nnue, write_etiny, write_nnue
from nnue_vision_tpu_torch.models.etinynet import etinynet_quantize
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet, NNUEConfig, nnue_quantize
from nnue_vision_tpu_torch.torch_import import (
    is_torch_checkpoint,
    load_torch_checkpoint_auto,
)
from nnue_vision_tpu_torch.training.checkpoint import (
    etinynet_from_checkpoint,
    load_checkpoint,
    nnue_from_checkpoint,
)

# the config fields the root CLI reads from a checkpoint's model_config
_NNUE_FIELDS = ("feature_set", "l1_size", "l2_size", "l3_size", "num_classes",
                "input_size")
_ETINY_FIELDS = ("variant", "num_classes", "input_size", "use_asq", "asq_bits",
                 "engine_friendly")


def detect_model_type(payload: dict) -> str:
    """Detect from checkpoint contents (upstream detect_model_type:588-636)."""
    explicit = payload.get("model_type")
    if explicit in ("nnue", "etinynet"):
        return explicit
    params = payload.get("params", payload)
    keys = set(params.keys()) if isinstance(params, dict) else set()
    if {"ft_w", "conv_w"} <= keys or "visual_threshold" in keys:
        return "nnue"
    if "stem_w" in keys or "blocks" in keys:
        return "etinynet"
    raise ValueError("cannot determine model type from checkpoint contents")


def infer_nnue_config(params: dict) -> NNUEConfig:
    """Infer the architecture from parameter shapes
    (upstream infer_architecture_from_state_dict:715-788)."""
    num_features, l1 = params["ft_w"].shape
    ch = params["conv_w"].shape[0]
    grid = int(round((num_features / ch) ** 0.5))
    if grid * grid * ch != num_features:
        raise ValueError(
            f"cannot infer grid: {num_features} features, {ch} channels"
        )
    return NNUEConfig(
        feature_set=GridFeatureSet(grid, ch),
        l1_size=l1, l2_size=params["fc1_w"].shape[0],
        l3_size=params["fc2_w"].shape[0], num_classes=params["out_w"].shape[0],
    )


def load_checkpoint_auto(path: Path, device="cuda") -> Tuple[str, object, object]:
    """(model_type, model on `device`, its config) from a pickle checkpoint
    of this package or the JAX package, or from an upstream torch file.

    The model's config holds the fields the root CLI reads (an NNUE's
    widths and input size; an EtinyNet's variant, classes, input size, ASQ
    and `engine_friendly`); the rest take their defaults, as there."""
    if is_torch_checkpoint(path):
        return load_torch_checkpoint_auto(path, device=device)

    payload = load_checkpoint(path)
    model_type = detect_model_type(payload)
    params = payload.get("params", payload)
    cfg_dict = payload.get("model_config")
    if model_type == "nnue":
        if not cfg_dict:
            cfg = infer_nnue_config(params)
            return model_type, nnue_from_jax_params(params, cfg, device=device), cfg
        mc = {k: cfg_dict[k] for k in _NNUE_FIELDS if k in cfg_dict}
        model = nnue_from_checkpoint({"params": params, "model_config": mc},
                                     device=device)
    else:
        if not cfg_dict:
            raise ValueError("EtinyNet checkpoints must embed model_config")
        mc = {k: cfg_dict[k] for k in _ETINY_FIELDS if k in cfg_dict}
        model = etinynet_from_checkpoint(
            {"params": params, "batch_stats": payload.get("batch_stats"),
             "model_config": mc}, device=device)
    return model_type, model, model.cfg


ETINY_TRAP_WARNING = (
    "WARNING: this EtinyNet checkpoint was NOT trained engine_friendly "
    "(config lacks engine_friendly=True). The .etiny format hard-caps "
    "every internal activation at 7 integer levels; a standard-trained "
    "model deploys at ~random accuracy through the engine (measured "
    "0.078 on a task it scored 1.000 in float — PARITY.md). Retrain "
    "with an engine_friendly QAT config (e.g. "
    "config/train_etinynet_hard.py), or pass --force to silence this "
    "warning if shipping the artifact is intentional."
)


def serialize_checkpoint(input_path: Path, output_path: Path,
                         model_type: str = "auto", force: bool = False,
                         device="cuda") -> Path:
    """Write `input_path`'s model to `output_path` (its suffix set to
    `.nnue` / `.etiny` unless it is one of those or `.bin`), read it back,
    and return the path written."""
    detected, model, cfg = load_checkpoint_auto(Path(input_path), device=device)
    if model_type != "auto":
        detected = model_type
    output_path = Path(output_path)

    if (detected == "etinynet" and not force
            and not getattr(cfg, "engine_friendly", False)):
        # the file still writes (measuring the trap is a legitimate use),
        # but never silently
        print(ETINY_TRAP_WARNING, file=sys.stderr, flush=True)

    if detected == "nnue":
        if output_path.suffix not in (".nnue", ".bin"):
            output_path = output_path.with_suffix(".nnue")
        write_nnue(nnue_quantize(model), output_path)
        read_nnue(output_path)  # self-verify
    else:
        if output_path.suffix not in (".etiny", ".bin"):
            output_path = output_path.with_suffix(".etiny")
        write_etiny(etinynet_quantize(model), output_path)
        read_etiny(output_path)  # self-verify
    print(f"Serialized {detected} model to {output_path} "
          f"({output_path.stat().st_size} bytes)")
    return output_path


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Serialize a checkpoint to the .nnue/.etiny engine format"
    )
    parser.add_argument("input", type=Path, help="Input checkpoint (.ckpt)")
    parser.add_argument("output", type=Path, help="Output file (.nnue/.etiny)")
    parser.add_argument("--model-type", choices=["auto", "nnue", "etinynet"],
                        default="auto")
    parser.add_argument("--features", type=str,
                        help="(accepted for interface parity; auto-detected)")
    parser.add_argument("--force", action="store_true",
                        help="silence the non-engine_friendly EtinyNet "
                             "deployment warning")
    parser.add_argument("--device", default="cuda",
                        help="where the model is built (default: the card)")
    args = parser.parse_args(argv)

    if not args.input.exists():
        raise FileNotFoundError(f"Input file not found: {args.input}")
    serialize_checkpoint(args.input, args.output, args.model_type,
                         force=args.force, device=args.device)
    print("Serialization complete!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
