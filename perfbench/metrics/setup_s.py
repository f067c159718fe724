"""Set-up: process start to the first timed call (imports, the CUDA
context, input generation, the data-in step, loading or building the
kernel libraries, warming the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
