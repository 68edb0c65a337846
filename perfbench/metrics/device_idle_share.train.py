"""The share of a dispatch's wall time in which no device operation ran:
1 − the device's busy seconds per dispatch in the traced window (the union
of every kernel, copy and set's interval) over the wall seconds per
dispatch of the untraced window. Tracing a graph replay's ~14,000 kernels
slows its launch by about half (PERF.md), so the traced window's own idle
share overstates the untraced one; the kernels' busy time is not
inflated."""


def read(ctx):
    t, w = ctx["trace"], ctx["window"]
    if not t["kernels"]:
        return None
    busy = t["busy_s"] / t["dispatches"]
    return (1.0 - busy / (w["seconds"] / w["dispatches"])) * 100
