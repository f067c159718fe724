"""Device milliseconds of kernels per event backtest call, summed over the
traced stretch's kernel records over its calls."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_calls or not t.kernels():
        return None
    return t.kernel_us() / t.n_calls / 1e3
