"""The chunk's host side per train step: the harness's host clock around
each chunk call of the untraced window (the draws, the packing, the copy
of the packed draws and the replay's enqueue; the call returns before the
device has run the chunk), summed and divided by the steps."""


def read(ctx):
    w = ctx["window"]
    return sum(w["host_s"]) / w["steps"] * 1e3
