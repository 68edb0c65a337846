"""The EtinyNet-1.0 family at ImageNet size: how the benchmark builds the
program's model from a configuration file and the benchmark's weights,
which entry serves it, and which plain reference stands beside it
(`perfbench/reference/etinynet_imagenet.py`), for serving and for
training. The program's side is the EtinyNet family's
(`families/etinynet.py`).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench import inputs
from perfbench.families import etinynet
from perfbench.reference import augment as ref_aug
from perfbench.reference import etinynet_imagenet as ref

param_specs = ref.param_specs
forward_macs = ref.forward_macs
ref_forward = ref.forward
ref_quantize = ref.quantize
ref_engine = ref.engine_forward
init_stats = ref.init_stats
ref_after_update = etinynet.ref_after_update
port_model = etinynet.port_model
port_serving = etinynet.port_serving


def serve_macs(cfg: dict) -> float:
    """Multiply-adds of one image through the int8 engine."""
    return sum(ref.engine_macs(cfg))


def serving_stats(params, cfg, seed, device) -> Dict[str, torch.Tensor]:
    """Running statistics for a served model (`reference.etinynet_imagenet.
    calibrate`) from `calibration_images` seeded, normalized images."""
    x = ref_aug.normalize(inputs.make_images(
        cfg["calibration_images"], cfg["input_size"], seed, "calibration",
        device))
    return ref.calibrate(params, x, cfg)


def k6_stage_work(cfg: dict, batch: int):
    """(bytes, operations) of one call's LB stage, every block of the
    engine from the stem's output to the final block's: the stage's int8
    input read once, its output written once, every block's weights read
    once (pw-expand, its int32 bias, the depthwise, pw-project; the final
    1×1 conv as one more block with its identity depthwise and diagonal
    project); the stage's multiply-adds ×2."""
    t = ref.VARIANTS[cfg["variant"]]
    h = (cfg["input_size"] - 1) // 2 + 1
    nbytes = batch * h * h * t["conv_channels"]
    weights = 0
    for cin, mid, out, stride, _, _ in ref.blocks(cfg):
        h = (h - 1) // stride + 1
        weights += cin * mid + 4 * mid + 9 * mid + mid * out
    last, fin = ref.blocks(cfg)[-1][2], t["final_channels"]
    weights += last * fin + 4 * fin + 9 * fin + fin * fin
    nbytes += weights + batch * h * h * fin
    return nbytes, 2.0 * ref.engine_macs(cfg)[1] * batch
