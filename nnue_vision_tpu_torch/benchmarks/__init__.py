"""MCU simulation + TinyML benchmark suite (port of the repository's
`benchmarks/` package: layer L9 of the system, the Cortex-M latency,
energy and memory-fit analysis and the MLPerf-Tiny report), over the
port's model facade `models/api.py`, with the same public names."""

from nnue_vision_tpu_torch.benchmarks.mcu_simulation import (  # noqa: F401
    MCU_SPECS,
    MCUSpecs,
    ModelStats,
    analyze_sparsity,
    count_mac_operations,
    count_model_parameters,
    estimate_energy_consumption,
    estimate_memory_usage,
    estimate_quantized_model_size,
    generate_model_stats,
    run_mcu_benchmark,
    simulate_mcu_latency,
)
from nnue_vision_tpu_torch.benchmarks.tinyml_benchmarks import (  # noqa: F401
    TINYML_BASELINES,
    BaselineComparison,
    MLPerfTinyResult,
    benchmark_incremental_updates,
    compare_with_baselines,
    create_pareto_plot_data,
    evaluate_model_accuracy,
    generate_tinyml_report,
    run_mlperf_tiny_benchmark,
)
