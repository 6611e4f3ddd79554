"""k1_roofline.pathx: K1's least time a call (``cost/pathx.k1``: its bytes
at the memory rate or its FLOPs at the bf16 peak, the larger) over its
traced device time a call, in percent. K1 is the ``k1_*`` kernels of
``ops/cuda/csrc/diag_scan.cu``; a bidirectional layer makes four calls a
step: the forward and the reverse scan, and their two adjoint scans in
the backward (``ops/scan.DiagScanFn``)."""

from benchmark.cost.pathx import k1
from benchmark.cost.peaks import least_seconds
from benchmark.harness import trace

CALLS_PER_LAYER = 4


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.ops_seconds(tr, lambda n: n.startswith("k1_"))
    if t <= 0:
        return None
    per_call = t / (tr.steps * CALLS_PER_LAYER * ctx.shape.n_layers)
    c = k1(ctx.shape)
    return least_seconds(c.flops, c.bytes, ctx.device_name) / per_call * 100
