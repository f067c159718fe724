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
  generator and its ``GPU_SERVE_<run>.json`` and
  ``GPU_SERVE_POOL_<run>.json`` artifacts.

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
  closed books across the processes.

The fabric (the router as replicated processes) and the fleet are not
ported yet (ROADMAP.md, Queue 1 item 6c).  Nothing here imports torch
at import time: the stub workers and the supervisor never load it.
"""

from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.buckets import BucketSpec, bucket_spec
from csmom_tpu_torch.serve.router import Router, RouterConfig
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor

__all__ = ["BucketSpec", "PoolConfig", "PoolSupervisor", "Router",
           "RouterConfig", "bucket_spec", "serve_endpoints"]
