"""The event engine's share of its roofline, in percent: the bytes one call
must move (each input panel read once, each output written once, from the
shapes) over the card's memory rate, over the call's kernel time from the
trace."""

from perfbench.metrics._yardstick import bound_s


def read(ctx):
    t, nbytes = ctx.trace, ctx.work.get("event_bytes")
    if t is None or nbytes is None or not t.n_calls or not t.kernels():
        return None
    least = bound_s(nbytes, 0, ctx.device_kind)
    if least is None:
        return None
    return 100.0 * least / (t.kernel_us() / t.n_calls / 1e6)
