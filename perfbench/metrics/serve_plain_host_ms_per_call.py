"""The stem and tail of an int8 serving call, on the host: the program's
`serve.stem` and `serve.tail` spans (the EtinyNet's stem kernel wrapper
and its pool + classifier kernel wrapper: their checks and the launches'
enqueue) summed over the traced window, over its calls, in ms. Nothing
for an entry with no stem or tail span (K1)."""

from perfbench.program_spans import span_ns


def read(ctx):
    ns = span_ns(("serve.stem", "serve.tail"))
    return None if ns is None else ns / ctx["trace"]["calls"] / 1e6
