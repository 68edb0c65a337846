"""The chunk's host draws per train step: the program's `chunk.draws` spans
(every host generator call of a chunk's steps, `data/augment.py` and
`ops/input_pipeline.py` `draw_light_params`) summed over the traced window,
over its steps, in ms. Tracing's own cost inside the span is small: the
draws record no span of their own."""

from perfbench.program_spans import span_ns


def read(ctx):
    ns = span_ns(("chunk.draws",))
    return None if ns is None else ns / ctx["trace"]["steps"] / 1e6
