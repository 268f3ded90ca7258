"""Set-up: from the process's start to the first timed request (imports,
CUDA, the kernels' build or load, the fit, the cell's inputs, the
warm-up of its shapes). Host clock."""


def read(ctx):
    return ctx.setup_s
