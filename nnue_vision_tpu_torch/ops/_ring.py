"""Host side of the persistent bulk-copy kernels (`csrc/bulk_ring.cuh`): the
light pipeline (K3), the warp (K4), its single pass and the no-gather
control (K8), and the photometric block (K5).

Each of those kernels runs a persistent grid whose blocks walk items (an
image, a band of one, or a tile of packed rows) through one shared-memory slot fed by bulk
copies; the blocks resident on an SM overlap one another's copies and
compute. `grid_size` sizes the grid from the kernel's resident blocks per
SM, which the library reports per shape (`*_blocks_per_sm`) and `grid`
asks once per kernel, shape and device. `grid_size` is plain Python, so
the CPU tests hold it.

`launch` is the wrappers' one path to a kernel: the library's functions
looked up once, the arguments packed into one int64 array (ctypes then
converts one pointer, not a dozen), the current stream's raw handle taken
without building a `torch.cuda.Stream`, and a device switch only when the
tensor is not on the current device. It raises when the launcher reports
an error.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict

import torch

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
def library():
    from nnue_vision_tpu_torch.ops._build import load_library

    return load_library().lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the current device and its current stream's raw handle, without building
# a torch.cuda.Stream (torch's own bindings where it has them)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda index: torch.cuda.current_stream(index).cuda_stream))


_BLOCKS_PER_SM: Dict[tuple, int] = {}


def grid(dev: torch.device, items: int, query: str, *shape: int) -> int:
    """`grid_size` for the kernel whose occupancy query is `query`, at
    `shape` (the query's arguments), on `dev`; the library is asked once
    per query, shape and device."""
    key = (query, dev.index, shape)
    per_sm = _BLOCKS_PER_SM.get(key)
    if per_sm is None:
        with torch.cuda.device(dev):
            per_sm = _BLOCKS_PER_SM[key] = int(getattr(library(), query)(*shape))
    return grid_size(items, sm_count(dev.index), per_sm)


_ARGS = threading.local()  # per thread: the packed argument array


def launch(dev: torch.device, kernel: str, fn_name: str, args: tuple) -> None:
    """Call launcher `fn_name` on `dev` with `args` and the current stream
    of `dev`, packed into one int64 array (one pointer for ctypes to
    convert); raise if it reports an error."""
    fn = getattr(library(), fn_name)
    index = dev.index
    buf = getattr(_ARGS, "buf", None)
    if buf is None:
        buf = _ARGS.buf = (ctypes.c_int64 * 24)()
    if index == _current_device():
        buf[:len(args) + 1] = args + (_raw_stream(index),)
        err = fn(buf)
    else:
        with torch.cuda.device(index):
            buf[:len(args) + 1] = args + (_raw_stream(index),)
            err = fn(buf)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{library().nnue_error_string(err).decode()}")
