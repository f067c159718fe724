"""Clean twin: the shard functions call a pure helper."""

from csmom_tpu_torch.parallel.compat import shard_map

from .util import scale_panel


# a shard's function (handed to shard_map by build below)
def score(panel):
    return scale_panel(panel)


# another shard's function
def step(state):
    return scale_panel(state)


def build(mesh):
    return (shard_map(score, mesh=mesh, in_specs=(), out_specs=()),
            shard_map(step, mesh=mesh, in_specs=(), out_specs=()))
