"""Kernels launched per intraday pipeline call, from the kernel records of
the traced stretch over its calls."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_calls or not t.kernels():
        return None
    return t.kernel_count() / t.n_calls
