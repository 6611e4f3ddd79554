"""k6_roofline: K6's least time (``cost/model.k6``: the whole network's
FLOPs at the bf16 peak, or the features and mask at the memory rate) over
its traced device time a call, in percent. K6 is the ``engine_*`` pass
kernels (``ops/cuda/csrc/engine_passes.cuh``), one call a request."""

from benchmark.cost.model import k6
from benchmark.cost.peaks import least_seconds
from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.ops_seconds(tr, lambda n: n.startswith("engine_"))
    if t <= 0:
        return None
    c = k6(ctx.shape)
    return least_seconds(c.flops, c.bytes, ctx.device_name) / (
        t / tr.steps) * 100
