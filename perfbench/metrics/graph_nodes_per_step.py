"""The chunk graph's nodes per train step: `ChunkGraph.nodes` (the CUDA
driver's count of the captured graph) over its steps. Nothing to read
where the chunk runs eagerly (no graph)."""


def read(ctx):
    g = ctx["graph"]
    return None if not g else g["nodes"] / g["steps"]
