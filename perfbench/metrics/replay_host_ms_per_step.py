"""The chunk graph's replay per train step, on the host: the program's
`chunk.replay` spans (`CUDAGraph.replay()`: the launch of the graph's
nodes, and any wait for room in the launch queue) summed over the traced
window, over its steps, in ms. Nothing where the chunk runs eagerly (the
CPU: no graph)."""

from perfbench.program_spans import span_ns


def read(ctx):
    ns = span_ns(("chunk.replay",))
    return None if ns is None else ns / ctx["trace"]["steps"] / 1e6
