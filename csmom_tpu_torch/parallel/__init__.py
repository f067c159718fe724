"""Meshes and the sharded engines (the exports of :mod:`csmom_tpu.parallel`).

One process drives every shard of a mesh
(:mod:`csmom_tpu_torch.parallel.compat`): the asset axis splits the
monthly, banded and grid engines (an all_gather for the rank, psums of
the kernels' partial sums), a ``grid`` axis splits J cells, the sample
axis the bootstrap, and a ``time`` axis the event engines and the online
ridge (blocked scans with small carries).

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "time_sharded_online_ridge_scores": "csmom_tpu_torch.parallel.online_ridge",
    "make_mesh": "csmom_tpu_torch.parallel.mesh",
    "auto_mesh": "csmom_tpu_torch.parallel.mesh",
    "make_hybrid_mesh": "csmom_tpu_torch.parallel.mesh",
    "mesh_topology": "csmom_tpu_torch.parallel.mesh",
    "distributed_init": "csmom_tpu_torch.parallel.mesh",
    "sharded_banded_backtest": "csmom_tpu_torch.parallel.collectives",
    "time_sharded_hysteresis_backtest": "csmom_tpu_torch.parallel.event_time",
    "sharded_monthly_spread_backtest": "csmom_tpu_torch.parallel.collectives",
    "sharded_jk_grid_backtest": "csmom_tpu_torch.parallel.collectives",
    "sharded_block_bootstrap": "csmom_tpu_torch.parallel.bootstrap",
    "sharded_event_backtest": "csmom_tpu_torch.parallel.event",
    "time_sharded_event_backtest": "csmom_tpu_torch.parallel.event_time",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.parallel' has no attribute {name!r}")
