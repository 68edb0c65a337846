"""Host generator calls per train step: the `draw_calls` of the program's
`chunk.draws` spans (its `host_draw_calls` counter's delta over each
chunk's draws) summed over the traced window, over its steps. A count:
it repeats exactly for a tier (70 heavy, 39 medium, 0 none a step; 8 a
fused light chunk)."""

from perfbench.program_spans import span_count


def read(ctx):
    n = span_count("chunk.draws", "draw_calls")
    return None if n is None else n / ctx["trace"]["steps"]
