"""idle_share.denoise: the share of the traced stretch in which no device
operation ran on rank 0, from the union of the operations' intervals, in
percent."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    return (1.0 - trace.busy_seconds(tr) / (tr.window[1] - tr.window[0])) \
        * 100.0
