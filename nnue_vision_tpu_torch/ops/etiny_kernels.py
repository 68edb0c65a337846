"""EtinyNet int8 serving with one Hopper kernel per LB block (K6).

Port of `nnue_vision_tpu/ops/etiny_pallas.py:90-339`. `etiny_forward_kernel`
is the counterpart of `etiny_forward_pallas`: the stem conv, the global pool
and the classifier run as the exact int64 plain code of
`ops/engine_sim.py`, and every LB block is one launch of
`etiny_block_kernel` (`csrc/etiny_block.cu`), which computes the block at
its stride in int32 with C truncating division. The logits equal
`etiny_engine_forward`'s, and the C++ `etinynet_inference` binary's, bit
for bit.

As in the JAX package, a model with a stride-2 dense block (the engine's
dim-preservation quirk, which the serializer never emits) is refused by
`etiny_kernel_params`, and a block whose spatial dims are not powers of
two by `etiny_forward_kernel`, both with ValueError: such models take the
engine sim.

`lb_block` dispatches on the device of its input: a CPU tensor takes the
plain version (`lb_block_reference`, the sim's block), a CUDA tensor the
kernel, which launches or raises. There is no fallback. The plain version
of the whole forward is the sim, `etiny_engine_forward`.
"""

from __future__ import annotations

from typing import Dict

import torch

from nnue_vision_tpu_torch.ops.engine_sim import (
    EtinyBlockCfg,
    EtinySimCfg,
    conv_out_hw,
    etiny_stem,
    etiny_tail,
    lb_block_plain,
)
from nnue_vision_tpu_torch.ops.nnue_kernels import mma_tiles

# Launches since the last reset_launch_counts(); the wrapper adds one where
# it launches the kernel, and nowhere else.
LAUNCHES = {"etiny_block_kernel": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _tiles_shape(n: int, k: int) -> tuple:
    """Shape of `mma_tiles` of an (n, k) weight."""
    return (-(-n // 128), -(-k // 128), 128, 128)


def etiny_kernel_params(sim_params: Dict, cfg: EtinySimCfg) -> Dict:
    """`etiny_sim_params` arrays plus the kernel's layouts per block, built
    once per model: `we` (pw-expand, (mid, in)) and `wp` (pw-project,
    (out, mid)) as `mma_tiles`, K zero padded to a multiple of 128, in the
    operand order of the tensor-core products; `be` int32; `dw` (mid, 3, 3)
    int8. Raises ValueError for a stride-2 dense block."""
    blocks = []
    for blk, bs in zip(sim_params["blocks"], cfg.blocks):
        if bs.is_dense and bs.stride != 1:
            raise ValueError(
                "stride-2 dense block (engine dim-preservation quirk) — "
                "use the XLA engine sim for this model"
            )
        blocks.append({
            **blk,
            "we": mma_tiles(blk["pw_expand_w"]),
            "be": blk["pw_expand_b"].to(torch.int32).contiguous(),
            "dw": blk["dw_w"].contiguous(),
            "wp": mma_tiles(blk["pw_project_w"]),
        })
    return {**sim_params, "blocks": blocks}


def lb_block_reference(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg
                       ) -> torch.Tensor:
    """What etiny_block_kernel computes, in plain torch (the engine sim's
    block): (B, H, W, in) int8 → (B, oh, ow, out) int8."""
    return lb_block_plain(x, blk, bs).to(torch.int8)


def _launch(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg) -> torch.Tensor:
    from nnue_vision_tpu_torch.ops._build import load_library

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"etiny_block_kernel runs on CUDA tensors only (got "
                         f"{dev}); CPU tensors take the plain version")
    b, h, w, cin = x.shape
    mid, cout = blk["dw"].shape[0], blk["pw_project_w"].shape[0]
    if (tuple(blk["we"].shape) != _tiles_shape(mid, cin)
            or tuple(blk["wp"].shape) != _tiles_shape(cout, mid)
            or tuple(blk["dw"].shape) != (mid, 3, 3)
            or tuple(blk["be"].shape) != (mid,)):
        raise ValueError("block weights do not match the input's channels")
    for name, t, dtype in (("x", x, torch.int8), ("we", blk["we"], torch.int8),
                           ("be", blk["be"], torch.int32),
                           ("dw", blk["dw"], torch.int8),
                           ("wp", blk["wp"], torch.int8)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel takes a contiguous, 16-byte aligned "
                f"{dtype} tensor on {dev}; got {t.dtype} on {t.device}")
    oh, ow = conv_out_hw(h, w, bs.stride)
    out = torch.empty((b, oh, ow, cout), dtype=torch.int8, device=dev)
    if b == 0:
        return out
    lib = load_library().lib
    if lib.etiny_block_tile(b, h, w, cin, mid, cout, oh, ow) < 1:
        smem = lib.etiny_block_smem(1, h, w, cin, mid, cout, oh, ow)
        raise ValueError(f"block of {h}x{w}x{mid} needs {smem} bytes of "
                         "shared memory for one image; the card gives a "
                         "block 232448")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.etiny_block_launch(
            x.data_ptr(), b, h, w, cin, mid, cout, bs.stride, oh, ow,
            bs.s_expand, bs.s_dw, bs.s_project, blk["we"].data_ptr(),
            blk["be"].data_ptr(), blk["dw"].data_ptr(), blk["wp"].data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("etiny_block_kernel launch failed: "
                           f"{lib.nnue_error_string(err).decode()}")
    LAUNCHES["etiny_block_kernel"] += 1
    return out


def lb_block(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg) -> torch.Tensor:
    """One LB block at its stride: (B, H, W, in) int8 → (B, oh, ow, out)
    int8, `blk` from `etiny_kernel_params`."""
    if x.device.type == "cpu":
        return lb_block_reference(x, blk, bs)
    return _launch(x.contiguous(), blk, bs)


def etiny_forward_kernel(kparams: Dict, images: torch.Tensor, *,
                         cfg: EtinySimCfg, image_h: int, image_w: int
                         ) -> torch.Tensor:
    """Bit-exact EtinyNet int8 inference, one kernel launch per LB block:
    (B, H, W, 3) float32 normalized images → logits (B, classes) float32,
    `kparams` from `etiny_kernel_params`. Its plain version is the engine
    sim, `etiny_engine_forward`."""
    del image_h, image_w  # read from the images
    x = etiny_stem(kparams, images, cfg).to(torch.int8)
    for blk, bs in zip(kparams["blocks"], cfg.blocks):
        h, w = x.shape[1], x.shape[2]
        if not (_is_pow2(h) and _is_pow2(w)):
            raise ValueError(
                f"block spatial dims {h}x{w} are not powers of two — "
                "use the XLA engine sim for this model"
            )
        # a stride-1 dense block keeps its dims: the engine's quirk is the
        # identity (stride-2 dense blocks were refused at parameter build)
        x = lb_block(x, blk, bs)
    return etiny_tail(kparams, x, cfg)
