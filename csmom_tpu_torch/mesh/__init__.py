"""Sharding as a subsystem: placement tables, shard helpers, the sharded
variants of the registry's engines and device-slice pinning (the exports
of :mod:`csmom_tpu.mesh`).

- :mod:`~csmom_tpu_torch.mesh.rules`: the partition-rule tables (regex
  on a leaf name -> :class:`~csmom_tpu_torch.parallel.compat.P`) and the
  named meshes they resolve on;
- :mod:`~csmom_tpu_torch.mesh.shard`: placing inputs, gathering results
  and wrapping a local function with ``shard_map``;
- :mod:`~csmom_tpu_torch.mesh.variants`: the sharded variants that
  :meth:`csmom_tpu_torch.registry.core.EngineSpec.sharded` resolves
  (the serve endpoints' sharded micro-batch scorers, the grid, monthly,
  event, histrank, online-ridge and stream-signal engines);
- :mod:`~csmom_tpu_torch.mesh.pinning`: stdlib-only device-slice
  arithmetic, which the serving pool pins its mesh workers with.

Importing the package loads neither torch nor pandas.
"""

from csmom_tpu_torch.mesh.pinning import (
    DEVICE_SLICE_ENV,
    parse_device_slice,
    shards_for,
    slice_for_slot,
)

__all__ = [
    "DEVICE_SLICE_ENV",
    "parse_device_slice",
    "shards_for",
    "slice_for_slot",
]
