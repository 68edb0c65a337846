"""K6's share of its roofline over the whole LB stage, for a configuration
whose blocks may take K6's band path: the least time the card could take
for one call's LB stage (its family's `k6_stage_work`: the stage's int8
input read once, its output written once, every block's weights read once;
the stage's multiply-adds ×2 at the int8 rate), over the device time per
call of every kernel the K6 entry launches (`etiny_block_kernel`, on
whole-image tiles or on row bands), so that the count does not depend on
how the stage is cut. Nothing for a family without that count."""

from perfbench import peaks
from perfbench.trace import kernel_time

KERNELS = ("etiny_block_kernel",)


def read(ctx):
    work = getattr(ctx["family"], "k6_stage_work", None)
    sec, n = kernel_time(ctx["trace"], KERNELS)
    if work is None or n == 0:
        return None
    nbytes, ops = work(ctx["config"], ctx["traffic"]["batch"])
    bound, _ = peaks.bound_s(nbytes, ops, "int8")
    return bound / (sec / ctx["trace"]["calls"]) * 100
