"""The share of K6's input rows read more than once: 100 × (rows read −
rows) / rows over the traced window's `serve.kernels` spans, whose counts
the program takes from its band plan on the host (`rows`: the image rows
of the K6 launches' inputs, Σ B·H; `rows_read`: the rows their blocks of
threads read, a band's halo rows each time). A fixed count for a
configuration and a batch; 0 where every block takes whole images.
Nothing where the spans carry no such counts, nor on the CPU, where no
block of threads reads anything (the blocks take the plain version)."""


def read(ctx):
    if ctx["setup"].device.type != "cuda":
        return None
    try:
        from nnue_vision_tpu_torch import tracing
    except ImportError:
        return None
    found = [s.counts for s in tracing.spans()
             if s.name == "serve.kernels" and "rows_read" in s.counts]
    rows = sum(c["rows"] for c in found)
    if not rows:
        return None
    return 100.0 * (sum(c["rows_read"] for c in found) - rows) / rows
