"""nnue_vision_tpu_torch — the PyTorch + CUDA port of `nnue_vision_tpu`.

The JAX package beside it is the reference this port is held against; the
port imports `torch` and never `jax`. Ported so far: int8 serving and
training of both model families (NNUE and EtinyNet), on one device
or data-parallel over several:

* `ops/engine_sim.py`: the bit-exact NNUE int8 engine simulation in plain
  torch — the oracle and the CPU path.
* `ops/nnue_kernels.py`: the two hand-written Hopper kernels
  (`csrc/nnue_head.cu`) behind `nnue_engine_forward_mega`,
  `nnue_engine_forward_fused` and `fused_nnue_head`, each with a plain
  `*_reference` beside it.
* `models/nnue.py`: the float NNUE as an `nn.Module`, plus quantization to
  the shared `.nnue` format; `bridge.py` moves params to and from the JAX
  package's numpy layout.
* `training/evaluate.py`: `evaluate_int8_sim` over any of the three backends.
* `models/etinynet.py`, `ops/etiny_kernels.py` (`csrc/etiny_block.cu`, one
  LB block per launch) and the EtinyNet half of `ops/engine_sim.py`.
* `data/augment.py` (three tiers), with the warp (`ops/warp_kernel.py`,
  `csrc/warp.cu`) and photometric (`ops/photometric_kernel.py`,
  `csrc/photometric.cu`) kernels of the medium and heavy tiers, the light
  tier's fused input kernel (`ops/input_pipeline.py`), and `training/`
  with `train_model` and its CLI, `python -m nnue_vision_tpu_torch.train`:
  the C++ engine's build and start-up probe (`training/engine_build.py`),
  the engine backend (`evaluate_compiled_model`), bf16 compute for both
  families, distillation and step-checkpoint resume.

* `parallel/`: data parallelism over `torch.distributed`, one process per
  card (`distributed.py`: the group's initialization, torchrun's variables,
  `spawn`; `mesh.py`: the mesh, its sharding helpers, the tensor-parallel
  NNUE plan and the differentiable collectives): `train_model` and its CLI
  train over a data group, and the evals and int8 serving split a batch
  over it.

* The deployment entry points: `serialize.py` and `evaluate.py` (the
  root CLIs' counterparts: checkpoint → `.nnue` / `.etiny`, and float,
  int8-sim and engine metrics), `torch_import.py` (upstream PyTorch
  checkpoints), the incremental NNUE accumulator in `ops/engine_sim.py`
  with `stream_inference_demo.py`, `models/api.py` (the object facade),
  `training/utils.py` (run utilities) and `cloud/` (a one-H100 GPU VM
  launcher; the loop stops the instance when a run ends).

* `profile_mega_bisect.py` and `profile_warp_split.py`: the profiling
  probes, on the stage-cut mega kernel and the single warp passes
  (`ops/timing.py` times them in CUDA graphs), and `train_model`'s
  `profile_dir` trace.

* `tracing.py`: the program's spans (the train chunk's draws, pack, load,
  capture and replay; the int8 serving entries' stem, kernels and tail),
  recorded while a torch profiler runs, and its one registry of counters
  (each kernel module's `LAUNCHES`, the host draw calls) and gauges (the
  chunk graph's nodes by phase).

* The user tools, `python -m nnue_vision_tpu_torch.<tool>`: the MCU/TinyML
  analysis (`benchmarks/`, `run_mcu_benchmarks.py`,
  `run_example_benchmark.py`), the engine-speed comparisons
  (`compare_engine_speed.py`, the C++ engine beside the int8 kernels;
  `engine_speed_parity.py`), the interchange check
  (`upstream_e2e_check.py`) and the accuracy tools (`real_data_eval.py`,
  `reference_anchor.py`).

The `.nnue` / `.etiny` readers and writers and their records are
`formats.py` and `quantize.py`, numpy-only copies of the JAX package's
modules: the port imports nothing of `nnue_vision_tpu`.
"""

__version__ = "0.1.0"

from nnue_vision_tpu_torch.formats import (  # noqa: F401
    QConv,
    QFeatureTransformer,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
    QuantizedNNUE,
    read_etiny,
    read_nnue,
    write_etiny,
    write_nnue,
)
