"""Known-bad fixture: shard functions whose host-sync escapes hide one
call hop away — the per-file tracer-hygiene rule stays silent on THIS
file (every escape lives in util.py/donated.py)."""

from csmom_tpu_torch.parallel.compat import shard_map

from .util import log_panel, refresh_state


# a shard's function (handed to shard_map by build below)
def score(panel):
    log_panel(panel)
    return panel * 2.0


# another shard's function
def step(state):
    return refresh_state(state)


def build(mesh):
    return (shard_map(score, mesh=mesh, in_specs=(), out_specs=()),
            shard_map(step, mesh=mesh, in_specs=(), out_specs=()))
