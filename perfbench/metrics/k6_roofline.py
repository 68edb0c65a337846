"""K6's share of its roofline (`etiny_block_kernel`, `ops/etiny_kernels.py`):
the least time the card could take for one call's LB stage, every block of
the engine from the stem's output to the final block's (the stage's int8
input read once, its output written once, every block's weights read
once; the stage's multiply-adds ×2 at the int8 rate, the final block's
identity depthwise and diagonal project at one multiply-add a value, as
those inputs need), counting nothing that an implementation may keep on
chip between blocks, over the device time per call of the kernel's
launches in the traced window."""

from perfbench import peaks
from perfbench.reference import etinynet
from perfbench.trace import kernel_time

KERNELS = ("etiny_block_kernel",)


def work(cfg: dict, batch: int):
    """(bytes, operations) of one call's LB stage."""
    t = etinynet.VARIANTS[cfg["variant"]]
    h = (cfg["input_size"] - 1) // 2 + 1
    nbytes = batch * h * h * t["conv_channels"]
    weights = 0
    for cin, mid, out, stride, _, _ in etinynet.blocks(cfg):
        h = (h - 1) // stride + 1
        weights += cin * mid + 4 * mid + 9 * mid + mid * out
    last, fin = etinynet.blocks(cfg)[-1][2], t["final_channels"]
    weights += last * fin + 4 * fin + 9 * fin + fin * fin
    nbytes += weights + batch * h * h * fin
    return nbytes, 2.0 * etinynet.engine_macs(cfg)[1] * batch


def read(ctx):
    sec, n = kernel_time(ctx["trace"], KERNELS)
    if n == 0:
        return None
    nbytes, ops = work(ctx["config"], ctx["traffic"]["batch"])
    bound, _ = peaks.bound_s(nbytes, ops, "int8")
    return bound / (sec / ctx["trace"]["calls"]) * 100
