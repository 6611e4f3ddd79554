"""mfu.pathx: the Path-X network's forward FLOPs times 3 a step (forward
and backward; ``cost/pathx.model_forward_flops``) over the step's time in
the traced run's timed stretch, against the card's dense bf16 peak, in
percent: the whole step's share of the peak. Nothing for another
task's shape."""

from benchmark.cost.pathx import Shape, model_forward_flops
from benchmark.cost.peaks import peaks


def read(ctx):
    t = ctx.timed
    if (ctx.device_name == "cpu" or not t["steps"]
            or not isinstance(ctx.shape, Shape)):
        return None
    step_s = t["elapsed"] / t["steps"]
    return 3 * model_forward_flops(ctx.shape) / step_s / peaks(
        ctx.device_name)[0] * 100.0
