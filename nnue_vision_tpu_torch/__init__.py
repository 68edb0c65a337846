"""nnue_vision_tpu_torch — the PyTorch + CUDA port of `nnue_vision_tpu`.

The JAX package beside it is the reference this port is held against; the
port imports `torch` and never `jax`. What is ported so far is the int8
serving path:

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

The `.nnue` reader/writer and the `QuantizedNNUE` record are the
framework-free `nnue_vision_tpu.formats`, shared by both packages.
"""

__version__ = "0.1.0"

from nnue_vision_tpu.formats import (  # noqa: F401
    QConv,
    QFeatureTransformer,
    QLinear,
    QuantizedNNUE,
    read_nnue,
    write_nnue,
)
