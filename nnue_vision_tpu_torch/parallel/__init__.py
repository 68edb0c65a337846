"""Data and tensor parallelism over `torch.distributed`: one process per
card (port of `nnue_vision_tpu/parallel/`)."""

from nnue_vision_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)
