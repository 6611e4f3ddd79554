"""mfu.train: the network's forward FLOPs times 3 a step (forward and
backward; ``cost/model.model_forward_flops``, the STFT not counted) over
the step's time in the traced run's timed stretch, against the card's
dense bf16 peak, in percent. On several ranks, one rank's rows and time."""

from benchmark.cost.model import model_forward_flops
from benchmark.cost.peaks import peaks


def read(ctx):
    t = ctx.timed
    if ctx.device_name == "cpu" or not t["steps"]:
        return None
    step_s = t["elapsed"] / t["steps"]
    return 3 * model_forward_flops(ctx.shape) / step_s / peaks(
        ctx.device_name)[0] * 100.0
