"""comm_ms.dp: device milliseconds a step of the collective kernels (NCCL)
on rank 0, from the trace: the gradient and BatchNorm all-reduces."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.ranks == 1:
        return None
    t = trace.ops_seconds(tr, lambda n: "nccl" in n.lower())
    return t / tr.steps * 1e3 if t > 0 else None
