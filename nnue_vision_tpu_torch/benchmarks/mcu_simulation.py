"""MCU deployment simulation: parameters, MACs, memory, latency, energy
(port of the repository's `benchmarks/mcu_simulation.py`, layer L9 of the
system: the Cortex-M latency, energy and memory-fit analysis).

The same public names and cost model, over the port's facade
(`nnue_vision_tpu_torch.models.api.NNUE` / `EtinyNet`). Everything here
is host arithmetic on the model's shapes, except `analyze_sparsity`, which
runs the float forward on the model's device (the card unless the facade
was built elsewhere) and reads the binarized grid's density from its aux.

Cost model:
* latency = effective MACs / (peak MACs/s), MCUs execute 1 MAC ≈ 2 ops →
  peak MACs/s = peak_ops_per_second / 2; a 1.2× scheduling/memory overhead
  factor; int8 quantization gives a 2× MAC-rate uplift (SIMD dual-issue on
  Cortex-M DSP extensions).
* energy = power × time, idle floor added for duty-cycled operation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.api import count_mac_operations as _etiny_macs


@dataclass
class MCUSpecs:
    name: str
    peak_ops_per_second: float
    memory_flash_kb: float
    memory_ram_kb: float
    power_active_mw: float
    power_idle_mw: float


# Representative Cortex-M deployment targets (datasheet-order-of-magnitude).
MCU_SPECS: Dict[str, MCUSpecs] = {
    "cortex_m4": MCUSpecs(
        name="ARM Cortex-M4",
        peak_ops_per_second=180e6,   # ~90 MHz dual-issue DSP
        memory_flash_kb=1024,
        memory_ram_kb=256,
        power_active_mw=33,
        power_idle_mw=1.5,
    ),
    "cortex_m33": MCUSpecs(
        name="ARM Cortex-M33",
        peak_ops_per_second=320e6,
        memory_flash_kb=2048,
        memory_ram_kb=512,
        power_active_mw=40,
        power_idle_mw=1.2,
    ),
    "cortex_m7": MCUSpecs(
        name="ARM Cortex-M7",
        peak_ops_per_second=960e6,   # ~480 MHz dual-issue
        memory_flash_kb=2048,
        memory_ram_kb=1024,
        power_active_mw=120,
        power_idle_mw=3.0,
    ),
}


@dataclass
class ModelStats:
    total_parameters: int
    trainable_parameters: int
    total_macs: int
    conv_macs: int
    linear_macs: int
    feature_transformer_macs: int
    model_size_bytes: int
    activation_memory_bytes: int
    quantized_model_size_bytes: int
    quantization_bit_width: int
    sparsity_ratio: float
    effective_macs: int

    @property
    def compression_ratio(self) -> float:
        if self.quantized_model_size_bytes <= 0:
            return 1.0
        return self.model_size_bytes / self.quantized_model_size_bytes

    @property
    def sparsity_speedup(self) -> float:
        dense = max(1, self.total_macs)
        eff = max(1, self.effective_macs)
        return dense / eff


def _leaves(tree) -> List[np.ndarray]:
    """The arrays of a nested dict/list pytree (the facade's `.params`)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def count_model_parameters(model) -> Tuple[int, int]:
    """(total, trainable) over `model.params` (an EtinyNet's batch_stats
    excluded, as in the JAX package). All params are trainable."""
    total = sum(int(np.prod(x.shape)) for x in _leaves(model.params))
    return total, total


def _is_nnue(model) -> bool:
    return hasattr(model, "feature_set")


def model_images(model, images) -> torch.Tensor:
    """A numpy batch of [0, 1] images, normalized, on the model's device."""
    x = torch.as_tensor(np.asarray(images, np.float32), device=model.device)
    return normalize_images(x)


def count_mac_operations(model, input_shape: Optional[tuple] = None) -> Dict[str, int]:
    """MACs per inference: {"conv", "feature_transformer", "linear", "total"}.

    Conv MACs = out_c·in_c·k²·out_h·out_w with out = in // stride (the
    upstream spec's convention); FT = num_features·L1 (dense worst case).
    An EtinyNet's are `models.api.count_mac_operations` of its config.
    """
    if not _is_nnue(model):
        return _etiny_macs(model.cfg)
    cfg = model.cfg
    in_h = in_w = cfg.input_size
    if input_shape is not None:
        in_h, in_w = input_shape[1], input_shape[2]
    stride = max(
        1, -(-(in_h - 1) // (cfg.feature_set.grid_size - 1))
    ) if cfg.feature_set.grid_size > 1 else in_h
    out_h, out_w = in_h // stride, in_w // stride
    ch = cfg.feature_set.num_features_per_square
    conv = ch * 3 * 3 * 3 * out_h * out_w
    ft = cfg.feature_set.num_features * cfg.l1_size
    linear = (
        cfg.l1_size * cfg.l2_size
        + cfg.l2_size * cfg.l3_size
        + cfg.l3_size * cfg.num_classes
    )
    return {"conv": conv, "feature_transformer": ft, "linear": linear,
            "total": conv + ft + linear}


def estimate_memory_usage(model) -> Dict[str, int]:
    """{"model_parameters", "activations", "working_buffers", "total"} bytes."""
    total, _ = count_model_parameters(model)
    param_bytes = total * 4  # float32

    if _is_nnue(model):
        cfg = model.cfg
        act = 4 * (
            cfg.feature_set.num_features  # binarized grid
            + 2 * cfg.l1_size             # FT accumulator + pairwise
            + cfg.l2_size + cfg.l3_size + cfg.num_classes
        )
    else:
        h = model.cfg.input_size
        h = h if isinstance(h, int) else h[0]
        widest = max(m for _, _, m, o, _, _ in model.cfg.block_specs())
        act = 4 * ((h // 2) * (h // 2) * widest)
    working = max(1024, act // 2)
    return {
        "model_parameters": param_bytes,
        "activations": act,
        "working_buffers": working,
        "total": param_bytes + act + working,
    }


def estimate_quantized_model_size(model) -> int:
    """Bytes of the serialized int8/int16/int32 model (by tensor role)."""
    if _is_nnue(model):
        p = model.params
        size = 0
        size += int(np.prod(np.shape(p["conv_w"])))            # int8
        size += int(np.prod(np.shape(p["ft_w"]))) * 2          # int16
        size += int(np.prod(np.shape(p["ft_b"]))) * 4
        for w, b in (("fc1_w", "fc1_b"), ("fc2_w", "fc2_b"), ("out_w", "out_b")):
            size += int(np.prod(np.shape(p[w])))
            size += int(np.prod(np.shape(p[b]))) * 4
        return size
    total, _ = count_model_parameters(model)
    return total  # int8 everywhere


def analyze_sparsity(model, data_loader, num_samples: int = 100) -> Dict[str, float]:
    """Feature sparsity (1 - density) of the binarized grid over real data,
    from the float forward's aux on the model's device."""
    if not _is_nnue(model):
        raise ValueError("sparsity analysis applies to NNUE models")

    sparsities: List[float] = []
    seen = 0
    with torch.no_grad():
        for images, _ in data_loader:
            _, aux = model(model_images(model, images), return_aux=True)
            density = aux["density"].cpu().numpy()
            sparsities.extend((1.0 - density).tolist())
            seen += len(density)
            if seen >= num_samples:
                break
    if not sparsities:
        return {"avg_sparsity": 0.0, "min_sparsity": 0.0,
                "max_sparsity": 0.0, "std_sparsity": 0.0}
    arr = np.clip(np.asarray(sparsities[:num_samples]), 0.0, 1.0)
    return {
        "avg_sparsity": float(arr.mean()),
        "min_sparsity": float(arr.min()),
        "max_sparsity": float(arr.max()),
        "std_sparsity": float(arr.std()),
    }


def simulate_mcu_latency(
    model_stats: ModelStats, mcu_spec: MCUSpecs, use_sparsity: bool = True
) -> Dict[str, float]:
    """Latency/throughput on the target MCU; ∝ effective MACs."""
    peak_macs = max(mcu_spec.peak_ops_per_second, 1.0) / 2.0
    macs = model_stats.effective_macs if use_sparsity else model_stats.total_macs
    macs = max(1, macs)
    base_ms = macs / peak_macs * 1000.0
    overhead_ms = base_ms * 1.2
    quantized_ms = overhead_ms / 2.0  # int8 SIMD dual-issue
    return {
        "base_latency_ms": base_ms,
        "with_overhead_ms": overhead_ms,
        "quantized_latency_ms": quantized_ms,
        "throughput_fps": 1000.0 / quantized_ms,
    }


def estimate_energy_consumption(
    latency_ms: float, mcu_spec: MCUSpecs
) -> Dict[str, float]:
    """Energy per inference.

    Unit convention inherited from the upstream spec (its integration tests
    assert active_energy_mj ≈ power_active_mw × latency_ms — i.e., mW·ms,
    which is physically µJ but labeled mJ upstream; total_energy_uj is that
    ×1000). Kept verbatim so spec-shaped consumers get the numbers they
    expect; treat these as relative figures across models/MCUs.
    """
    active_mj = mcu_spec.power_active_mw * latency_ms
    idle_mj = mcu_spec.power_idle_mw * latency_ms
    total_mj = active_mj + idle_mj
    return {
        "active_energy_mj": active_mj,
        "idle_energy_mj": idle_mj,
        "total_energy_mj": total_mj,
        "total_energy_uj": total_mj * 1000.0,
    }


def generate_model_stats(
    model, data_loader=None, target_sparsity: float = 0.0
) -> ModelStats:
    """Full ModelStats; sparsity from data when a loader is given."""
    total, trainable = count_model_parameters(model)
    macs = count_mac_operations(model)
    memory = estimate_memory_usage(model)
    quantized = estimate_quantized_model_size(model)

    sparsity = target_sparsity
    if data_loader is not None and _is_nnue(model):
        sparsity = analyze_sparsity(model, data_loader, num_samples=32)["avg_sparsity"]
    sparsity = float(np.clip(sparsity, 0.0, 1.0))
    effective = int(macs["total"] * (1.0 - sparsity))

    return ModelStats(
        total_parameters=total,
        trainable_parameters=trainable,
        total_macs=macs["total"],
        conv_macs=macs["conv"],
        linear_macs=macs["linear"],
        feature_transformer_macs=macs["feature_transformer"],
        model_size_bytes=memory["model_parameters"],
        activation_memory_bytes=memory["activations"],
        quantized_model_size_bytes=quantized,
        quantization_bit_width=8,
        sparsity_ratio=sparsity,
        effective_macs=effective,
    )


def run_mcu_benchmark(
    model,
    data_loader=None,
    mcu_specs: Optional[List[MCUSpecs]] = None,
    target_sparsity: float = 0.5,
    verbose: bool = True,
) -> Dict:
    """Full pipeline: stats + per-MCU latency/energy/memory-fit/efficiency."""
    if mcu_specs is None:
        mcu_specs = list(MCU_SPECS.values())
    # target_sparsity is authoritative here (the upstream integration spec
    # expects model_stats.sparsity_ratio == target); pass a loader to
    # generate_model_stats directly for measured sparsity.
    stats = generate_model_stats(model, None, target_sparsity)

    results = {"model_stats": stats, "mcu_results": {}}
    for spec in mcu_specs:
        latency = simulate_mcu_latency(stats, spec)
        energy = estimate_energy_consumption(latency["quantized_latency_ms"], spec)
        flash_fit = stats.quantized_model_size_bytes <= spec.memory_flash_kb * 1024
        ram_fit = stats.activation_memory_bytes <= spec.memory_ram_kb * 1024
        ms = max(latency["quantized_latency_ms"], 1e-9)
        results["mcu_results"][spec.name] = {
            "latency": latency,
            "energy": energy,
            "memory_fit": {"flash": flash_fit, "ram": ram_fit,
                           "fits": flash_fit and ram_fit},
            "efficiency_metrics": {
                "fps": latency["throughput_fps"],
                "energy_per_inference_uj": energy["total_energy_uj"],
                "macs_per_ms": stats.effective_macs / ms,
            },
        }
        if verbose:
            print(f"{spec.name}: {latency['quantized_latency_ms']:.2f} ms, "
                  f"{energy['total_energy_uj']:.1f} µJ, "
                  f"fits={flash_fit and ram_fit}")
    return results
