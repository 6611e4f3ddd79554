"""k2_roofline: K2's least time (``cost/model.k2``) over its traced device
time a call, in percent. K2 is ``layer_tail_row_kernel`` with the
B-projection and scan passes it launches (``tail_hist_bproj_kernel``,
``tail_hist_scan_kernel``), one call per layer a request."""

from benchmark.cost.model import k2
from benchmark.cost.peaks import least_seconds
from benchmark.harness import trace

NAMES = ("layer_tail_row_kernel", "tail_hist_bproj_kernel",
         "tail_hist_scan_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.ops_seconds(tr, lambda n: n in NAMES)
    if t <= 0:
        return None
    per_call = t / (tr.steps * ctx.shape.n_layers)
    c = k2(ctx.shape)
    return least_seconds(c.flops, c.bytes, ctx.device_name) / per_call * 100
