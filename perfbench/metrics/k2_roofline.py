"""K2's share of its roofline, in percent: the least time its work could
take (bytes and operations from the copied ``k2_bound_inputs``, at the
cell's labels shape and the reference's extreme-bin members) over K2's
device time a launch, read from the trace by its kernel symbol.  A grid
call launches K2 once over every J's labels, so a launch is a call's K2
work; dividing by the launches found leaves out a record the profiler
dropped."""

from perfbench.metrics._yardstick import bound_s, k2_bound_inputs

KERNEL = "cohort_tile_kernel"


def read(ctx):
    t, k2 = ctx.trace, ctx.work.get("k2")
    if t is None or k2 is None or not t.kernel_count(KERNEL):
        return None
    nbytes, ops = k2_bound_inputs(k2["labels_shape"], k2["members"],
                                  k2["ret_itemsize"], k2["H"])
    least = bound_s(nbytes, ops, ctx.device_kind)
    if least is None:
        return None
    return 100.0 * least / (t.kernel_us(KERNEL) / t.kernel_count(KERNEL) / 1e6)
