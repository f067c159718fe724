"""Clean twin: every clock need routed through the documented helpers."""

from datetime import datetime, timezone

from csmom_tpu_torch.utils.deadline import mono_now_s, wall_now_s


def timed(fn):
    t0 = mono_now_s()
    fn()
    return mono_now_s() - t0


def stamp():
    # identity stamps take an explicit timezone (argful: allowed)
    return datetime.now(timezone.utc).isoformat(), wall_now_s()
