"""Import upstream NNUE-Vision checkpoints into the port's models (port of
`nnue_vision_tpu/torch_import.py`).

Migration path for users of the upstream PyTorch project: their
`.pt`/`.ckpt` files (state dicts, bare or under `"state_dict"`, with the
upstream module tree's keys: `conv.weight`, `input.weight`,
`classifier.classifier.0.weight`, ... for an NNUE; `conv_initial.weight`,
`stage1.0.pw_expand.weight`, ... for an EtinyNet) load into the port's
`NNUE` / `EtinyNet` on `device`, after which training, serialization and
int8 serving work unchanged. The upstream keys are mapped to the JAX
package's numpy layout exactly as its `torch_import` maps them, and
`bridge.py` builds the module from that layout.

Architecture inference follows upstream `infer_architecture_from_state_dict`
(serialize.py:715-788 upstream): the grid from the feature count over the
conv's channels, the EtinyNet variant from the stem's width. An upstream
one-element `visual_threshold` is broadcast to one value per channel: the
same function, as the float forward compares against it per channel and
quantization takes the mean.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from nnue_vision_tpu_torch.bridge import etinynet_from_jax, nnue_from_jax_params
from nnue_vision_tpu_torch.models.etinynet import EtinyNet, EtinyNetConfig
from nnue_vision_tpu_torch.models.nnue import NNUE, GridFeatureSet, NNUEConfig

ETINYNET_STEM_WIDTHS = {32: "1.0", 28: "0.98M", 24: "0.75", 8: "micro"}


def _to_numpy_state_dict(path: Path) -> Dict[str, np.ndarray]:
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    state = checkpoint.get("state_dict", checkpoint)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()}


def is_torch_checkpoint(path: Path) -> bool:
    """Cheap sniff: torch zip-serialized files start with PK, legacy ones
    (`_use_new_zipfile_serialization=False`) with pickle protocol 2; the
    pickles this package and the JAX package write are protocol 5. (The
    JAX package compares four bytes with the two of protocol 2, so it
    never recognizes a legacy file.)"""
    with open(path, "rb") as f:
        head = f.read(2)
    return head in (b"PK", b"\x80\x02")


def _nnue_numpy_params(sd: Dict[str, np.ndarray]) -> Tuple[dict, NNUEConfig]:
    """An upstream NNUE state dict → (the JAX package's numpy params, the
    port's NNUEConfig)."""
    if "input.weight" not in sd:
        raise ValueError(
            "not an upstream NNUE state dict (missing input.weight); "
            f"keys: {sorted(sd)[:8]}"
        )
    num_features, l1 = sd["input.weight"].shape  # (F, L1), not (L1, F)
    ch = sd["conv.weight"].shape[0]
    grid = int(round((num_features / ch) ** 0.5))
    if grid * grid * ch != num_features:
        raise ValueError(
            f"cannot infer grid from {num_features} features / {ch} channels"
        )
    l2 = sd["classifier.classifier.0.weight"].shape[0]
    l3 = sd["classifier.classifier.2.weight"].shape[0]
    num_classes = sd["classifier.classifier.4.weight"].shape[0]

    cfg = NNUEConfig(
        feature_set=GridFeatureSet(grid, ch),
        l1_size=int(l1), l2_size=int(l2), l3_size=int(l3),
        num_classes=int(num_classes),
    )
    threshold = sd["visual_threshold"].astype(np.float32).reshape(-1)
    params = {
        "conv_w": sd["conv.weight"].astype(np.float32),  # OIHW both sides
        "visual_threshold": np.broadcast_to(threshold, (ch,)).copy(),
        "ft_w": sd["input.weight"].astype(np.float32),
        "ft_b": sd["input.bias"].astype(np.float32),
        "fc1_w": sd["classifier.classifier.0.weight"].astype(np.float32),
        "fc1_b": sd["classifier.classifier.0.bias"].astype(np.float32),
        "fc2_w": sd["classifier.classifier.2.weight"].astype(np.float32),
        "fc2_b": sd["classifier.classifier.2.bias"].astype(np.float32),
        "out_w": sd["classifier.classifier.4.weight"].astype(np.float32),
        "out_b": sd["classifier.classifier.4.bias"].astype(np.float32),
        "nnue2score": np.float32(sd.get("nnue2score", np.float32(600.0))),
    }
    return params, cfg


def load_torch_nnue(path: Path, device="cuda") -> Tuple[NNUE, NNUEConfig]:
    """Upstream NNUE checkpoint → (NNUE on `device`, its config); the card
    unless the caller names another (raises without one)."""
    params, cfg = _nnue_numpy_params(_to_numpy_state_dict(path))
    return nnue_from_jax_params(params, cfg, device=device), cfg


def _bn(sd, prefix) -> Dict[str, np.ndarray]:
    return {
        "scale": sd[f"{prefix}.weight"].astype(np.float32),
        "bias": sd[f"{prefix}.bias"].astype(np.float32),
    }


def _bn_stats(sd, prefix) -> Dict[str, np.ndarray]:
    return {
        "mean": sd[f"{prefix}.running_mean"].astype(np.float32),
        "var": sd[f"{prefix}.running_var"].astype(np.float32),
    }


def _etinynet_numpy_params(sd: Dict[str, np.ndarray]
                          ) -> Tuple[dict, dict, EtinyNetConfig]:
    """An upstream EtinyNet state dict → (the JAX package's numpy params and
    batch_stats, the port's EtinyNetConfig). The variant follows the stem's
    width (upstream infer_etinynet_variant_from_state_dict,
    serialize.py:674-691); any other width raises."""
    if "conv_initial.weight" not in sd:
        raise ValueError("not an upstream EtinyNet state dict")
    stem_out = sd["conv_initial.weight"].shape[0]
    variant = ETINYNET_STEM_WIDTHS.get(stem_out)
    if variant is None:
        raise ValueError(f"unknown stem width {stem_out}")
    num_classes = sd["classifier.weight"].shape[0]
    cfg = EtinyNetConfig(variant=variant, num_classes=int(num_classes),
                         input_size=32)

    def conv_hwio(key):  # torch OIHW → HWIO; depthwise (C,1,3,3) → (3,3,1,C)
        return np.transpose(sd[key], (2, 3, 1, 0)).astype(np.float32)

    params = {
        "stem_w": conv_hwio("conv_initial.weight"),
        "stem_bn": _bn(sd, "bn_initial"),
        "blocks": [],
        "final_w": conv_hwio("conv_final.weight"),
        "final_bn": _bn(sd, "bn_final"),
        "cls_w": sd["classifier.weight"].astype(np.float32),
        "cls_b": sd["classifier.bias"].astype(np.float32),
    }
    stats = {
        "stem_bn": _bn_stats(sd, "bn_initial"),
        "blocks": [],
        "final_bn": _bn_stats(sd, "bn_final"),
    }

    # upstream module paths: stage{1..4}.{i}.<lb.>pw_expand etc.
    stage_lengths = [len(cfg.table[f"stage{k}"]) for k in range(1, 5)]
    idx_in_stage, stage_no = 0, 1
    for _, in_c, _, out, stride, dense in cfg.block_specs():
        base = f"stage{stage_no}.{idx_in_stage}"
        inner = f"{base}.lb" if dense else base
        bp = {
            "pw_expand_w": conv_hwio(f"{inner}.pw_expand.weight"),
            "bn1": _bn(sd, f"{inner}.bn1"),
            "dw_w": conv_hwio(f"{inner}.dw_conv.weight"),
            "bn2": _bn(sd, f"{inner}.bn2"),
            "pw_project_w": conv_hwio(f"{inner}.pw_project.weight"),
            "bn3": _bn(sd, f"{inner}.bn3"),
        }
        bs = {
            "bn1": _bn_stats(sd, f"{inner}.bn1"),
            "bn2": _bn_stats(sd, f"{inner}.bn2"),
            "bn3": _bn_stats(sd, f"{inner}.bn3"),
        }
        if dense and stride == 1 and in_c == out:
            bp["dense_proj_w"] = conv_hwio(f"{base}.dense_proj.weight")
            bp["dense_bn"] = _bn(sd, f"{base}.dense_bn")
            bs["dense_bn"] = _bn_stats(sd, f"{base}.dense_bn")
        params["blocks"].append(bp)
        stats["blocks"].append(bs)
        idx_in_stage += 1
        if idx_in_stage >= stage_lengths[stage_no - 1]:
            stage_no += 1
            idx_in_stage = 0
    return params, stats, cfg


def load_torch_etinynet(path: Path, device="cuda"
                        ) -> Tuple[EtinyNet, EtinyNetConfig]:
    """Upstream EtinyNet checkpoint → (EtinyNet on `device`, its config);
    the card unless the caller names another (raises without one)."""
    params, stats, cfg = _etinynet_numpy_params(_to_numpy_state_dict(path))
    return etinynet_from_jax(params, stats, cfg, device=device), cfg


def load_torch_checkpoint_auto(path: Path, device="cuda"
                               ) -> Tuple[str, object, object]:
    """(model_type, model on `device`, its config) from an upstream
    checkpoint of either family."""
    sd = _to_numpy_state_dict(path)
    if "input.weight" in sd or any("layer_stacks" in k for k in sd):
        params, cfg = _nnue_numpy_params(sd)
        return "nnue", nnue_from_jax_params(params, cfg, device=device), cfg
    if "conv_initial.weight" in sd or any(k.startswith("stage") for k in sd):
        params, stats, cfg = _etinynet_numpy_params(sd)
        return ("etinynet",
                etinynet_from_jax(params, stats, cfg, device=device), cfg)
    raise ValueError(f"unrecognized torch checkpoint: {sorted(sd)[:8]}")
