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
  generator and its ``GPU_SERVE_<run>.json`` artifact.

The multi-process pool, the router, the fabric and the fleet are not
ported yet (ROADMAP.md, Queue 1).
"""

from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.buckets import BucketSpec, bucket_spec

__all__ = ["BucketSpec", "bucket_spec", "serve_endpoints"]
