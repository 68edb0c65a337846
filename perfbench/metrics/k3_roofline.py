"""K3's share of its roofline (`light_pipeline_kernel`,
`ops/input_pipeline.py`): the least time the card could take for one
step's fused input (each gathered image read once, the normalized batch
written once, the step's indices and draws read once; its few operations
a step bound nothing), over the device time per launch in the traced
window."""

from perfbench import peaks
from perfbench.trace import kernel_time

KERNELS = ("light_pipeline_kernel",)


def work(batch: int, hw: int):
    """(bytes, operations) of one launch."""
    image = hw * hw * 3 * 4
    draws = batch * (4 + 2 * 4 + 4 * 4)  # index, (alpha, beta), hole
    return 2 * batch * image + draws, 0.0


def read(ctx):
    sec, n = kernel_time(ctx["trace"], KERNELS)
    if n == 0:
        return None
    nbytes, ops = work(ctx["config"]["recipe"]["batch_size"],
                       ctx["config"]["input_size"])
    bound, _ = peaks.bound_s(nbytes, ops, "float32")
    return bound / (sec / n) * 100
