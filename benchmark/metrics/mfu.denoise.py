"""mfu.denoise: the network's forward FLOPs a request
(``cost/model.model_forward_flops``, the STFT not counted) over the
request's time in the traced run's timed stretch, against the card's
dense bf16 peak, in percent."""

from benchmark.cost.model import model_forward_flops
from benchmark.cost.peaks import peaks


def read(ctx):
    t = ctx.timed
    if ctx.device_name == "cpu" or not t["steps"]:
        return None
    return model_forward_flops(ctx.shape) / (t["elapsed"] / t["steps"]) \
        / peaks(ctx.device_name)[0] * 100.0
