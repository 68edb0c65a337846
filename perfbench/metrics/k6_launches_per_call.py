"""K6's launches per serving call: the `k6_launches` counts of the traced
window's `serve.kernels` spans summed, over the number of those spans. The
program takes the count from its run plan on the host (one launch per run
of consecutive LB blocks that one launch carries). Nothing where the spans
carry no such count, nor on the CPU, where the blocks take the plain
version and nothing launches."""


def read(ctx):
    if ctx["setup"].device.type != "cuda":
        return None
    try:
        from nnue_vision_tpu_torch import tracing
    except ImportError:
        return None
    found = [s.counts["k6_launches"] for s in tracing.spans()
             if s.name == "serve.kernels" and "k6_launches" in s.counts]
    return sum(found) / len(found) if found else None
