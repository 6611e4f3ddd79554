"""toy_rows_per_s: sequences a second in the traced run's timed stretch,
from the toy task's own shape."""


def read(ctx):
    t = ctx.timed
    if not t["steps"]:
        return None
    return t["steps"] * ctx.shape.b / t["elapsed"]
