"""The chunk graph's input nodes per train step: of the nodes its capture
added, those of each step's input phase (the gather, K3 or the tier's K4
and K5, and the normalize), summed over the steps by the program at
capture (the `tracing` gauge `chunk_graph_nodes`), over the graph's steps.
With the other phases and the chunk's tail they add up to
`graph_nodes_per_step`. Nothing where the chunk runs eagerly."""

from perfbench.program_spans import gauge

PHASE = "input"


def read(ctx):
    g, nodes = ctx["graph"], gauge("chunk_graph_nodes")
    if not g or not nodes:
        return None
    return nodes[PHASE] / g["steps"]
