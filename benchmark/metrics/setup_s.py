"""setup_s: seconds from the start of the run's process to the window's
start: imports, inputs and weights, the program's set-up (kernel loads or
builds, calibration), the check's first steps and the warm-up."""


def read(ctx):
    return ctx.setup_s
