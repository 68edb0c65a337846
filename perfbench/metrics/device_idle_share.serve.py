"""The share of a call's wall time in which no device operation ran: 1 −
the device's busy seconds per call in the traced window (the union of
every kernel, copy and set's interval) over the wall seconds per call of
the untraced window (tracing slows the host's side of a call; the
kernels' busy time is not inflated)."""


def read(ctx):
    t, w = ctx["trace"], ctx["window"]
    if not t["kernels"]:
        return None
    busy = t["busy_s"] / t["calls"]
    return (1.0 - busy / (w["seconds"] / w["calls"])) * 100
