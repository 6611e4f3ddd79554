"""train_clips_per_s: clips trained in the window (every rank's) over the
window's seconds."""


def read(ctx):
    w = ctx.window
    return w["steps"] * ctx.cell["mix"]["batch"] * ctx.ranks / w["elapsed"]
