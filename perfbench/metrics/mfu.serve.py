"""The whole int8 forward's share of the card's int8 peak, on the host
clock: the untraced window's images/s times 2 × the served forward's
multiply-adds per image (from the configuration's shapes, by its family's
reference: the layers the int8 engine runs), over 1,979 TOP/s. Nothing on
the CPU, which has no such peak."""

from perfbench.peaks import OPS_PER_S


def read(ctx):
    if ctx["setup"].device.type != "cuda":
        return None
    ops = 2 * ctx["family"].serve_macs(ctx["config"])
    return ctx["window"]["images_per_s"] * ops / OPS_PER_S["int8"] * 100
