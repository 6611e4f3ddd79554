"""denoise_clips_per_s: clips denoised in the window over its seconds."""


def read(ctx):
    w = ctx.window
    return w["steps"] * ctx.cell["mix"]["batch"] / w["elapsed"]
