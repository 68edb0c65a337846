"""Build the package's CUDA sources with nvcc and load them with ctypes.

`load_library()` compiles `nnue_vision_tpu_torch/csrc/*.cu` at first use into
`build/torch_kernels/` under the repository root (listed in `.gitignore`),
keyed by a hash of the sources, and loads the shared library: one nvcc per
source, all started together, then one link. The sources have a plain C
interface, so the build takes seconds (no PyTorch headers).

Only sources in the repository are compiled, and a failed build raises:
there is no fallback. `--use_fast_math` is deliberately absent: it makes
f32 division approximate, and the logits are `acc / out_scale`.

`launch` is the wrappers' one path to a kernel: every launcher takes one
packed int64 array (`csrc/launch_args.cuh`; ctypes then converts one
pointer, not dozens), a float32 as its bits in a word's low 32 (`f32`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# the queries; every exported `*_launch` takes one packed int64 array
# (`launch`) and gets its signature at its first call
SIGNATURES = {
    "nnue_error_string": ([_I], ctypes.c_char_p),
    "nnue_mega_tile": ([_I] * 8 + [_P], _I),
    "light_pipeline_blocks_per_sm": ([_I] * 2, _I),
    "warp_blocks_per_sm": ([_I], _I),
    "lerp_pass_blocks_per_sm": ([_I] * 3, _I),
    "photometric_blocks_per_sm": ([_I] * 2, _I),
    "etiny_block_smem": ([_I] * 8, _I),
    "etiny_block_tile": ([_I] * 8, _I),
    "etiny_run_smem": ([_P], _I),
    "etiny_narrow_columns": ([], _I),
}
# words of the packed argument: the widest launcher's, etiny_run_launch's
# for a run of 16 blocks (4 + 16 x 13 + the output), and the stream
WORDS = 214


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process, 0.0 when already built
    log: str        # nvcc's output (ptxas register and shared-memory usage)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.environ.get("CUDA_HOME"), CUDA_HOME]
    for home in candidates:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of nnue_vision_tpu_torch cannot be built on this host"
        )
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    return srcs, digest.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> Built:
    """Compile (once per source hash) and load the kernels' library."""
    srcs, key = _sources()
    lib_path = BUILD_DIR / f"libnnue_kernels_{key}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.is_file():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{key}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
                logs = list(pool.map(
                    lambda so: _run([nvcc, *NVCC_FLAGS, "-c", "-o", str(so[1]),
                                     str(so[0])]),
                    zip(srcs, objs)))
            _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log_path.write_text("".join(logs))
        os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    log = log_path.read_text() if log_path.is_file() else ""
    return Built(lib, lib_path, seconds, log)


def f32(x: float) -> int:
    """A float32 argument's word: its bits in the low 32."""
    return struct.unpack("<I", struct.pack("<f", x))[0]


@functools.lru_cache(maxsize=None)
def _launcher(fn_name: str):
    fn = getattr(load_library().lib, fn_name)
    fn.argtypes, fn.restype = [_P], _I
    return fn


# the current device and its current stream's raw handle, without building
# a torch.cuda.Stream (torch's own bindings where it has them)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda index: torch.cuda.current_stream(index).cuda_stream))
_ARGS = threading.local()  # per thread: the packed argument array


def launch(dev: torch.device, counters: Dict[str, int], kernel: str,
           fn_name: str, args: Sequence[int]) -> None:
    """Call launcher `fn_name` on `dev` with `args` and the current stream
    of `dev`, packed into one int64 array; raise if it reports an error,
    else add one to `counters[kernel]`. A device switch only when `dev` is
    not the current device."""
    fn = _launcher(fn_name)
    index = dev.index
    buf = getattr(_ARGS, "buf", None)
    if buf is None:
        buf = _ARGS.buf = (ctypes.c_int64 * WORDS)()
    if index == _current_device():
        buf[:len(args) + 1] = (*args, _raw_stream(index))
        err = fn(buf)
    else:
        with torch.cuda.device(index):
            buf[:len(args) + 1] = (*args, _raw_stream(index))
            err = fn(buf)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{load_library().lib.nnue_error_string(err).decode()}")
    counters[kernel] += 1
