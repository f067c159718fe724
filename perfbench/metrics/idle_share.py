"""``idle_share.<layer>``: percent of an untraced call's wall in which no
device operation ran.  The device's busy time a call comes from the
CUDA-only traced stretch; the wall a call takes from the window's calls
before the profiler first ran, which it has not slowed.  Nothing where the
trace holds no device operation."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_calls or not t.device_ops or not ctx.call_s:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.n_calls / 1e6 / ctx.call_s)
