"""The reading that both call-time metrics take."""


def call_ms(ctx):
    """Milliseconds a call: the window's wall over the calls completed in
    it, each call ending with its result on the host."""
    return ctx.window_s / ctx.calls * 1e3 if ctx.calls else None
