"""mixer_fwd_ms.pathx: device milliseconds a step of the operations
launched while one of the program's ``mixer.*`` spans was open
(``models/ssm.S5SSM._apply_scan``: ``mixer.bproj``, ``mixer.scan`` with
both directions, ``mixer.cproj``), from the trace: the mixers' share of
the forward. Their adjoints are launched by autograd's thread, outside
these spans, and count in ``bwd_ms.train``."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.span_device_seconds(tr, "mixer.*")
    return t / tr.steps * 1e3 if t > 0 else None
