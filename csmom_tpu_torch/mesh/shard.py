"""Shard and gather helpers, and the ``shard_map`` wrapper the variants
build on.

Counterpart of :mod:`csmom_tpu.mesh.shard`.  The port has no global
sharded array: :func:`~csmom_tpu_torch.parallel.compat.shard_map`
slices its inputs per call and assembles its outputs on the mesh's
first device, so placing an input is moving it there, and gathering is
a copy to the host.  On a mesh over several processes, placing an input
keeps only this process's blocks
(:class:`~csmom_tpu_torch.parallel.compat.LocalBlocks`), and gathering
gives every process the same whole array, as the reference's
``gather_outputs`` does.

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
    """Inputs of a sharded call, each checked against its spec (every
    split dimension must divide over its shards): tensors on the mesh's
    first device, or, on a mesh over several processes, each a
    :class:`~csmom_tpu_torch.parallel.compat.LocalBlocks` holding only
    this process's shards' blocks, each on its shard's device."""
    import math

    import torch

    from csmom_tpu_torch.parallel.compat import LocalBlocks, _names, _Run, _split

    if len(specs) != len(arrays):
        raise ValueError(f"{len(specs)} specs for {len(arrays)} arrays")
    run = _Run(mesh, collective_free=True) if mesh.n_processes > 1 else None
    out = []
    for a, s in zip(arrays, specs):
        t = torch.as_tensor(a)
        for d, entry in enumerate(s):
            n = math.prod(mesh.shape[name] for name in _names(entry))
            if t.shape[d] % n:
                raise ValueError(f"dimension {d} of size {t.shape[d]} does "
                                 f"not divide over {n} shards")
        if run is None:
            out.append(t.to(mesh.home))
        else:
            out.append(LocalBlocks({k: _split(t, s, run, k, mesh.device_list[k])
                                    for k in run.local}, t.shape, s))
    return tuple(out)


def gather(x, mesh=None):
    """A host numpy copy of a result, or of a
    :class:`~csmom_tpu_torch.parallel.compat.LocalBlocks` on ``mesh``
    (every process's blocks, assembled: the same whole array on each)."""
    import numpy as np
    import torch

    from csmom_tpu_torch.parallel.compat import LocalBlocks, _assemble, _Run

    if isinstance(x, LocalBlocks):
        if mesh is None:
            raise ValueError("gathering LocalBlocks needs their mesh")
        from csmom_tpu_torch.parallel.mesh import process_allgather

        run = _Run(mesh, collective_free=True)
        leaves = [None] * mesh.size
        for theirs in process_allgather({k: b.detach().cpu()
                                         for k, b in x.blocks.items()}):
            for k, b in theirs.items():
                leaves[k] = b
        x = _assemble(x.spec, leaves, run)
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
