"""The chunk graph's quantizer nodes per train step: of the nodes its
capture added, those of the quantizer calls in each step's forward (an
engine-friendly EtinyNet's weight grids, LSQ activations, block-boundary
grids and deployed restore), summed over the steps by the program at
capture (the `tracing` gauge `chunk_graph_nodes`), over the graph's steps.
With the other phases and the chunk's tail they add up to
`graph_nodes_per_step`. Nothing where the chunk runs eagerly, nor where
the program counts no such phase."""

from perfbench.program_spans import gauge

PHASE = "quant"


def read(ctx):
    g, nodes = ctx["graph"], gauge("chunk_graph_nodes")
    if not g or not nodes or PHASE not in nodes:
        return None
    return nodes[PHASE] / g["steps"]
