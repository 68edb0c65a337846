"""The NNUE family: how the benchmark builds the program's model from a
configuration file and the benchmark's weights, which entry serves it,
and which plain reference stands beside it (`perfbench/reference/nnue.py`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from perfbench.reference import nnue as ref

param_specs = ref.param_specs
ref_after_update = ref.after_update
forward_macs = ref.forward_macs
serve_macs = ref.forward_macs  # the engine runs the model's own layers
ref_engine = ref.engine_forward


def init_stats(cfg: dict, device) -> Dict[str, torch.Tensor]:
    return {}


def ref_forward(p, stats, images, cfg, *, train=True, low=False):
    """The reference's logits in cfg["dtype"]; the NNUE has no norm
    statistics. `low` rounds the operands to float8."""
    return ref.forward(p, images, cfg, low=low)


def ref_quantize(params, stats, cfg, bits=8):
    return ref.quantize(params, cfg, bits)


def port_model(cfg: dict, device):
    """The program's model for `cfg`, its parameters still to be loaded."""
    from nnue_vision_tpu_torch.models.nnue import NNUE, GridFeatureSet, NNUEConfig

    return NNUE(NNUEConfig(
        feature_set=GridFeatureSet(cfg["grid_size"],
                                   cfg["num_features_per_square"]),
        l1_size=cfg["l1_size"], l2_size=cfg["l2_size"], l3_size=cfg["l3_size"],
        num_classes=cfg["num_classes"], input_size=cfg["input_size"],
        qat=cfg["qat"], dtype=cfg["dtype"]), device=device)


def serving_stats(params, cfg, seed, device) -> Dict[str, torch.Tensor]:
    return {}


def port_serving(model, cfg: dict, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program's int8 serving entry for the float `model`: K1
    (`nnue_engine_forward_mega`, f32 flat input, no counts) on
    `mega_head_params(nnue_sim_params(nnue_quantize(model)))`, as a call of
    a (B, H, W, 3) float32 batch returning its logits on the device."""
    from nnue_vision_tpu_torch.models.nnue import nnue_quantize
    from nnue_vision_tpu_torch.ops import nnue_kernels as nk
    from nnue_vision_tpu_torch.ops.engine_sim import nnue_sim_params

    hw = cfg["input_size"]
    sim, scfg = nnue_sim_params(nnue_quantize(model), device=device)
    head = nk.mega_head_params(sim, scfg, hw, hw)

    def call(images: torch.Tensor) -> torch.Tensor:
        flat = images.reshape(images.shape[0], hw * hw * 3)
        return nk.nnue_engine_forward_mega(head, flat, cfg=scfg, image_h=hw,
                                           image_w=hw, with_count=False)[0]
    return call
