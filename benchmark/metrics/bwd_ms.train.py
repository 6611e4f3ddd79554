"""bwd_ms.train: device milliseconds a step of the operations launched
while the program's ``train.backward`` span was open (``train/steps.py``:
``loss.backward()``, whose kernels autograd's thread launches), from the
trace."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.span_device_seconds(tr, "train.backward")
    return t / tr.steps * 1e3 if t > 0 else None
