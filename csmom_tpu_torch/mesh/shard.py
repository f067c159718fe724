"""Shard and gather helpers, and the ``shard_map`` wrapper the variants
build on.

Counterpart of :mod:`csmom_tpu.mesh.shard`.  The port has no global
sharded array: :func:`~csmom_tpu_torch.parallel.compat.shard_map`
slices its inputs per call and assembles its outputs on the mesh's
first device, so placing an input is moving it there, and gathering is
a copy to the host.

With ``collective_free`` a one-shard mesh skips the wrapper and
:func:`sharded_call` returns the function itself, the literal
single-device program; on more shards they run one after another on
the caller's thread (``shard_map(..., collective_free=True)``), with no
thread started per call.
"""

from __future__ import annotations

__all__ = ["gather", "mesh_size", "shard_args", "sharded_call"]


def mesh_size(mesh) -> int:
    import math

    return math.prod(mesh.shape.values())


def shard_args(mesh, specs, *arrays):
    """Inputs of a sharded call on the mesh's first device (tensors),
    each checked against its spec: every split dimension must divide
    over its shards."""
    import math

    import torch

    from csmom_tpu_torch.parallel.compat import _names

    if len(specs) != len(arrays):
        raise ValueError(f"{len(specs)} specs for {len(arrays)} arrays")
    home = mesh.device_list[0]
    out = []
    for a, s in zip(arrays, specs):
        t = torch.as_tensor(a)
        for d, entry in enumerate(s):
            n = math.prod(mesh.shape[name] for name in _names(entry))
            if t.shape[d] % n:
                raise ValueError(f"dimension {d} of size {t.shape[d]} does "
                                 f"not divide over {n} shards")
        out.append(t.to(home))
    return tuple(out)


def gather(x):
    """A host numpy copy of a result."""
    import numpy as np
    import torch

    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sharded_call(fn, mesh, in_specs, out_specs, *, collective_free: bool = False):
    """``shard_map(fn)`` on ``mesh``.  With ``collective_free`` (the
    caller's word that ``fn`` uses no collective or axis query) a
    one-shard mesh returns ``fn`` itself, and more shards run in order
    on the caller's thread."""
    from csmom_tpu_torch.parallel.compat import shard_map

    if collective_free and mesh_size(mesh) == 1:
        return fn
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     collective_free=collective_free)
