"""The whole train step's share of the card's peak, on the host clock: the
untraced window's images/s times 3 × 2 × the forward's multiply-adds per
image (forward and backward, the forward counted from the configuration's
shapes by its family's reference), over the peak of the configuration's
compute dtype (float32 outside the tensor cores for a float32 model, bf16
for a bf16 one). Nothing on the CPU, which has no such peak."""

from perfbench.peaks import OPS_PER_S


def read(ctx):
    if ctx["setup"].device.type != "cuda":
        return None
    cfg = ctx["config"]
    flops = 3 * 2 * ctx["family"].forward_macs(cfg)
    return ctx["window"]["images_per_s"] * flops / OPS_PER_S[cfg["dtype"]] * 100
