"""The in-process serving tier: admission -> coalesce -> dispatch on the card.

Counterpart of ``csmom_tpu.serve``'s in-process half:

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
  batch scorers on the card) and the numpy ``StubEngine``;
- :mod:`~csmom_tpu_torch.serve.service`: ``SignalService``;
- :mod:`~csmom_tpu_torch.serve.loadgen`: the seeded open-loop load
  generator and its ``GPU_SERVE_<run>.json``,
  ``GPU_SERVE_POOL_<run>.json`` and ``GPU_SERVE_FABRIC_<run>.json``
  artifacts.

and the multi-process pool over it:

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
  router-replica process of its own (``RouterServer``);

and the fabric over the pool:

- :mod:`~csmom_tpu_torch.serve.fabric`: the routes file every replica
  reads, its publisher, the router-replica supervisor and the client
  tier (``FabricClient``) with failover and closed client books.

The fleet's elastic tier and its observatory are not ported yet
(ROADMAP.md, Queue 1 item 6f).  Nothing here imports torch at import
time: the stub workers, the router replicas, the supervisors and the
fabric client never load it.
"""

from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.buckets import BucketSpec, bucket_spec
from csmom_tpu_torch.serve.fabric import (
    FabricClient,
    FabricClientConfig,
    RouterSupervisor,
    build_fabric,
    stop_fabric,
)
from csmom_tpu_torch.serve.router import Router, RouterConfig, RouterServer
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor

__all__ = ["BucketSpec", "FabricClient", "FabricClientConfig", "PoolConfig",
           "PoolSupervisor", "Router", "RouterConfig", "RouterServer",
           "RouterSupervisor", "bucket_spec", "build_fabric",
           "serve_endpoints", "stop_fabric"]
