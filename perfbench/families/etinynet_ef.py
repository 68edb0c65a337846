"""The engine-friendly EtinyNet family in quantization-aware training: how
the benchmark builds the program's model from a configuration file and
the benchmark's weights, and which plain reference stands beside it
(`perfbench/reference/etinynet_ef.py`). Trained only: no cell serves it.
"""

from __future__ import annotations

from perfbench.reference import etinynet_ef as ref

param_specs = ref.param_specs
init_stats = ref.init_stats
forward_macs = ref.forward_macs
ref_forward = ref.forward


def ref_after_update(p) -> None:
    """EtinyNet clips no weight after a step."""


def port_model(cfg: dict, device):
    """The program's engine-friendly model for `cfg`, its quantizers on as
    `ef_quantizers` says, its parameters and statistics still to be
    loaded."""
    from nnue_vision_tpu_torch.models.etinynet import EtinyNet, EtinyNetConfig

    return EtinyNet(EtinyNetConfig(
        variant=cfg["variant"], num_classes=cfg["num_classes"],
        input_size=cfg["input_size"], dtype=cfg["dtype"],
        engine_friendly=True, ef_quantizers=cfg["ef_quantizers"]),
        device=device)
