"""The serving kernels' wrappers per call, on the host: the program's
`serve.kernels` spans (K1's wrapper, or the K6 wrappers, one a run of
LB blocks in the run plan: their checks, the library lookup and the
launches' enqueue)
summed over the traced window, over its calls, in ms."""

from perfbench.program_spans import span_ns


def read(ctx):
    ns = span_ns(("serve.kernels",))
    return None if ns is None else ns / ctx["trace"]["calls"] / 1e6
