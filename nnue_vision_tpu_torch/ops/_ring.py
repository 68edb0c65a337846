"""Host side of the persistent bulk-copy kernels (`csrc/bulk_ring.cuh`): the
light pipeline (K3), the warp (K4), its single pass and the no-gather
control (K8), and the photometric block (K5).

Each of those kernels runs a persistent grid whose blocks walk items (an
image, a band of one, or a tile of packed rows) through one shared-memory slot fed by bulk
copies; the blocks resident on an SM overlap one another's copies and
compute. `grid_size` sizes the grid from the kernel's resident blocks per
SM, which the library reports per shape (`*_blocks_per_sm`) and `grid`
asks once per kernel, shape and device. `grid_size` is plain Python, so
the CPU tests hold it. The wrappers launch through `_build.launch`.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from nnue_vision_tpu_torch.ops import _build

TILE_CELLS = 1024  # cells ((row, pixel) pairs) per tile of a single pass


def grid_size(items: int, sms: int, per_sm: int) -> int:
    """Blocks for `items` items on a card of `sms` SMs where `per_sm` blocks
    fit on an SM (0: none does): as many as are resident at once, never more
    than items, so that at a batch that fits one wave every image gets a
    block of its own."""
    if per_sm <= 0:
        raise ValueError("the kernel's slot does not fit shared memory for "
                         "this shape")
    return min(items, sms * per_sm)


def pass_tile_rows(n: int) -> int:
    """Packed rows per tile of a single pass over rows of n pixels: at most
    TILE_CELLS cells, so that a thread of 256 holds at most four."""
    return max(1, TILE_CELLS // n)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_BLOCKS_PER_SM: Dict[tuple, int] = {}


def grid(dev: torch.device, items: int, query: str, *shape: int) -> int:
    """`grid_size` for the kernel whose occupancy query is `query`, at
    `shape` (the query's arguments), on `dev`; the library is asked once
    per query, shape and device."""
    key = (query, dev.index, shape)
    per_sm = _BLOCKS_PER_SM.get(key)
    if per_sm is None:
        with torch.cuda.device(dev):
            per_sm = _BLOCKS_PER_SM[key] = int(
                getattr(_build.load_library().lib, query)(*shape))
    return grid_size(items, sm_count(dev.index), per_sm)
