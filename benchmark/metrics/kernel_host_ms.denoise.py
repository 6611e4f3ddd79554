"""kernel_host_ms.denoise: host milliseconds a request spent inside the
program's ``kernel.*`` spans (the wrappers of ``ops/cuda/``: checks,
packing, scratch and the launches), from the trace."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.span_host_seconds(tr, "kernel.*")
    return t / tr.steps * 1e3 if t > 0 else None
