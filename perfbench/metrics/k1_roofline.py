"""K1's share of its roofline (`nnue_mega_kernel`, `ops/nnue_kernels.py`):
the least time the card could take for one call's int8 forward (the
float32 images read once, every weight read once, the logits written
once; the forward's multiply-adds ×2 at the int8 rate), over the device
time per launch in the traced window."""

from perfbench import peaks
from perfbench.reference import nnue
from perfbench.trace import kernel_time

KERNELS = ("nnue_mega_kernel",)


def work(cfg: dict, batch: int):
    """(bytes, operations) of one call."""
    hw, f = cfg["input_size"], nnue.num_features(cfg)
    ch, l1, l2, l3, nc = (cfg["num_features_per_square"], cfg["l1_size"],
                          cfg["l2_size"], cfg["l3_size"], cfg["num_classes"])
    weights = (ch * 27 + f * l1 * 2 + l2 * l1 + l3 * l2 + nc * l3
               + 4 * (ch + l1 + l2 + l3 + nc))
    nbytes = batch * hw * hw * 3 * 4 + weights + batch * nc * 4
    return nbytes, 2 * nnue.forward_macs(cfg) * batch


def read(ctx):
    sec, n = kernel_time(ctx["trace"], KERNELS)
    if n == 0:
        return None
    nbytes, ops = work(ctx["config"], ctx["traffic"]["batch"])
    bound, _ = peaks.bound_s(nbytes, ops, "int8")
    return bound / (sec / n) * 100
