"""Known-bad fixture: host-sync escapes inside a shard's function."""

import time

import numpy as np
from csmom_tpu_torch.parallel.compat import shard_map

_CALLS = 0


def score(values, mask):
    global _CALLS
    _CALLS = _CALLS + 1          # mutable-global write the shards share
    print("scoring batch")       # host I/O once a dispatch
    t0 = time.monotonic()        # clock read once a dispatch
    host = np.asarray(values)    # a copy of a shard to the host
    lead = float(mask)           # a host sync on a shard
    tail = values.item()         # device->host sync
    return host.sum() + lead + tail + t0


scorer = shard_map(score, mesh=None, in_specs=(), out_specs=())
