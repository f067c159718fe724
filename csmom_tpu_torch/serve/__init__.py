"""The serving tier: admission -> coalesce -> dispatch on the card.

Counterpart of ``csmom_tpu.serve``.  The in-process half:

- :mod:`~csmom_tpu_torch.serve.buckets`: the closed grid of dispatch
  shapes (profiles ``serve`` and ``serve-smoke``);
- :mod:`~csmom_tpu_torch.serve.slo`: SLO classes, budgets and quotas;
- :mod:`~csmom_tpu_torch.serve.queue`: the bounded admission queue and
  its closed books;
- :mod:`~csmom_tpu_torch.serve.cache`: the version-keyed result cache
  and in-flight coalescing;
- :mod:`~csmom_tpu_torch.serve.batcher`: adaptive micro-batching onto
  the bucket grid;
- :mod:`~csmom_tpu_torch.serve.engine`: ``TorchEngine`` (the registered
  batch scorers on the card), ``MeshTorchEngine`` (their sharded
  scorers over a mesh of cards or of logical shards) and the numpy
  ``StubEngine``;
- :mod:`~csmom_tpu_torch.serve.service`: ``SignalService``;
- :mod:`~csmom_tpu_torch.serve.loadgen`: the seeded open-loop load
  generator and its ``GPU_SERVE_<run>.json``,
  ``GPU_SERVE_MESH_<run>.json``, ``GPU_SERVE_POOL_<run>.json`` and
  ``GPU_SERVE_FABRIC_<run>.json`` artifacts.

The multi-process pool over it:

- :mod:`~csmom_tpu_torch.serve.proto`: the wire protocol (framed JSON and
  raw arrays, byte for byte the reference's) and its multiplexed
  channels;
- :mod:`~csmom_tpu_torch.serve.health`: liveness, readiness, the cache
  version and the cold-build check;
- :mod:`~csmom_tpu_torch.serve.worker`: one ``SignalService`` behind a
  socket, a process of its own;
- :mod:`~csmom_tpu_torch.serve.supervisor`: spawn, probe, restart and
  roll the workers;
- :mod:`~csmom_tpu_torch.serve.router`: admission, hedged dispatch and
  closed books across the processes, in the caller's process or as a
  router-replica process of its own (``RouterServer``).

The fabric over the pool, and the fleet's elastic tier:

- :mod:`~csmom_tpu_torch.serve.fabric`: the routes file every replica
  reads, its publisher, the router-replica supervisor and the client
  tier (``FabricClient``) with failover and closed client books;
- :mod:`~csmom_tpu_torch.serve.fleet`: hot spares promoted into a dead
  worker's slot, the prefork parent that forks them warm, and the
  demand-driven autoscaler (``FleetController``); its observatory is
  :mod:`csmom_tpu_torch.obs.fleet`.

The names resolve on first use, and nothing here imports torch at import
time: the stub workers, the router replicas, the supervisors and the
fabric client never load it.
"""

from __future__ import annotations

_LAZY = {
    "serve_endpoints": "csmom_tpu_torch.registry",
    "BucketSpec": "csmom_tpu_torch.serve.buckets",
    "bucket_spec": "csmom_tpu_torch.serve.buckets",
    "FabricClient": "csmom_tpu_torch.serve.fabric",
    "FabricClientConfig": "csmom_tpu_torch.serve.fabric",
    "RouterSupervisor": "csmom_tpu_torch.serve.fabric",
    "build_fabric": "csmom_tpu_torch.serve.fabric",
    "stop_fabric": "csmom_tpu_torch.serve.fabric",
    "AutoscalerPolicy": "csmom_tpu_torch.serve.fleet",
    "FleetConfig": "csmom_tpu_torch.serve.fleet",
    "FleetController": "csmom_tpu_torch.serve.fleet",
    "PreforkServer": "csmom_tpu_torch.serve.fleet",
    "Router": "csmom_tpu_torch.serve.router",
    "RouterConfig": "csmom_tpu_torch.serve.router",
    "RouterServer": "csmom_tpu_torch.serve.router",
    "PoolConfig": "csmom_tpu_torch.serve.supervisor",
    "PoolSupervisor": "csmom_tpu_torch.serve.supervisor",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.serve' has no attribute {name!r}")
