"""The EtinyNet family: how the benchmark builds the program's model from a
configuration file and the benchmark's weights, which entry serves it,
and which plain reference stands beside it
(`perfbench/reference/etinynet.py`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from perfbench import inputs
from perfbench.reference import augment as ref_aug
from perfbench.reference import etinynet as ref

param_specs = ref.param_specs
forward_macs = ref.forward_macs
ref_forward = ref.forward
ref_quantize = ref.quantize
ref_engine = ref.engine_forward
init_stats = ref.init_stats


def serve_macs(cfg: dict) -> float:
    """Multiply-adds of one image through the int8 engine."""
    return sum(ref.engine_macs(cfg))


def ref_after_update(p) -> None:
    """EtinyNet clips no weight after a step."""


def port_model(cfg: dict, device):
    """The program's model for `cfg`, its parameters and statistics still
    to be loaded."""
    from nnue_vision_tpu_torch.models.etinynet import EtinyNet, EtinyNetConfig

    return EtinyNet(EtinyNetConfig(
        variant=cfg["variant"], num_classes=cfg["num_classes"],
        input_size=cfg["input_size"], dtype=cfg["dtype"]), device=device)


def serving_stats(params, cfg, seed, device) -> Dict[str, torch.Tensor]:
    """Running statistics for a served model (`reference.etinynet.calibrate`)
    from `calibration_images` seeded, normalized images."""
    x = ref_aug.normalize(inputs.make_images(
        cfg["calibration_images"], cfg["input_size"], seed, "calibration",
        device))
    return ref.calibrate(params, x, cfg)


def port_serving(model, cfg: dict, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program's int8 serving entry for the float `model`:
    `etiny_forward_kernel` (the stem kernel, one K6 launch a run of LB
    blocks in the run plan, the pool + classifier kernel) on
    `etiny_kernel_params(etiny_sim_params(etinynet_quantize(model)))`, as
    a call of a (B, H, W, 3) float32 batch returning its logits on the
    device."""
    from nnue_vision_tpu_torch.models.etinynet import etinynet_quantize
    from nnue_vision_tpu_torch.ops.engine_sim import etiny_sim_params
    from nnue_vision_tpu_torch.ops.etiny_kernels import (
        etiny_forward_kernel,
        etiny_kernel_params,
    )

    hw = cfg["input_size"]
    sim, scfg = etiny_sim_params(etinynet_quantize(model), device=device)
    kp = etiny_kernel_params(sim, scfg)

    def call(images: torch.Tensor) -> torch.Tensor:
        return etiny_forward_kernel(kp, images, cfg=scfg, image_h=hw,
                                    image_w=hw)
    return call
