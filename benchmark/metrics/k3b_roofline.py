"""k3b_roofline: K3b's least time (``cost/model.k3b``: its FLOPs at the
bf16 peak or its bytes at the memory rate, the larger) over its traced
device time a call, in percent. K3b is the ``tail_bwd_*`` kernels of
``ops/cuda/csrc/layer_tail_bwd.cu``, one call per layer a step."""

from benchmark.cost.model import k3b
from benchmark.cost.peaks import least_seconds
from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.ops_seconds(tr, lambda n: n.startswith("tail_bwd_"))
    if t <= 0:
        return None
    per_call = t / (tr.steps * ctx.shape.n_layers)
    c = k3b(ctx.shape)
    return least_seconds(c.flops, c.bytes, ctx.device_name) / per_call * 100
