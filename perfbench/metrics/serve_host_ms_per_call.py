"""The serving wrapper's host time per call: the harness's host clock from
a call's submission until the entry returns (its checks, the launches'
enqueue), before the logits' read, averaged over the untraced window."""


def read(ctx):
    h = ctx["window"]["host_s"]
    return sum(h) / len(h) * 1e3
