"""The plain ops of an int8 serving call, on the host: the program's
`serve.stem` and `serve.tail` spans (the EtinyNet's exact int64 stem conv,
pool and classifier, enqueued) summed over the traced window, over its
calls, in ms. Nothing for an entry with no plain stem or tail (K1)."""

from perfbench.program_spans import span_ns


def read(ctx):
    ns = span_ns(("serve.stem", "serve.tail"))
    return None if ns is None else ns / ctx["trace"]["calls"] / 1e6
