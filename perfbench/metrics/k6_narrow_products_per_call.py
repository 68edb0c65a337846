"""K6's products of at most 32 columns per serving call: the
`k6_narrow_products` counts of the traced window's `serve.kernels` spans
summed, over the number of those spans. The program takes the count from
the LB blocks' shapes on the host (each block's pw-expand has `mid`
columns, its pw-project `cout`); such a product takes the warp layout in
which every warp holds columns that exist. Nothing where the spans carry
no such count, nor on the CPU, where the blocks take the plain version
and nothing launches."""


def read(ctx):
    if ctx["setup"].device.type != "cuda":
        return None
    try:
        from nnue_vision_tpu_torch import tracing
    except ImportError:
        return None
    found = [s.counts["k6_narrow_products"] for s in tracing.spans()
             if s.name == "serve.kernels" and "k6_narrow_products" in s.counts]
    return sum(found) / len(found) if found else None
