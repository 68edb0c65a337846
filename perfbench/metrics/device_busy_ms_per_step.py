"""The device's busy time per train step in the traced window: the union
of every kernel, copy and set's interval over the traced steps, in ms.
It leaves out the idle gaps between the chunk graph's nodes, which the
card's launch state stretches by process (PERF.md), so it moves with the
chunk's device work alone; `train_images_per_s` takes the gaps too."""


def read(ctx):
    t = ctx["trace"]
    if not t["kernels"]:
        return None
    return t["busy_s"] / t["steps"] * 1e3
