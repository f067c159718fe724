"""``shard_map`` on a single controller: one thread per shard.

Counterpart of :mod:`csmom_tpu.parallel.compat`, whose ``shard_map``
runs a local function once per device of a mesh inside one compiled
program and returns global arrays.  The port keeps that model in eager
torch: one Python process drives every shard of a
:class:`~csmom_tpu_torch.parallel.mesh.Mesh`.

- :func:`shard_map` runs ``local_fn`` once per shard, one thread each.
  A thread gets its shard's slices of the inputs (per ``in_specs``),
  moved to its device and made contiguous, and runs under
  ``torch.cuda.device`` of that device, since the CUDA runtime launches
  on the thread's current device.
- Inside ``local_fn`` the reference's collectives are functions of this
  module: :func:`psum`, :func:`all_gather`, :func:`ppermute`,
  :func:`axis_index` and :func:`axis_size`.  A collective deposits the
  shard's value in a slot, waits at a barrier of every shard, then
  combines its group's slots **in shard order** on the thread's own
  device, so every replica is bit-identical and a run repeats bit for
  bit.  Shards run the same collectives in the same order (SPMD), so the
  k-th collective of one shard meets the k-th of every other.
- The outputs are assembled per ``out_specs`` on the mesh's first
  device: a replicated output is the first shard's copy, a sharded one
  the concatenation of the shards' blocks in mesh order.

A shard that raises aborts the barrier, so the others stop at their
next collective; the caller then gets that shard's own exception, after
every thread has ended.  A barrier that waits longer than
:data:`BARRIER_TIMEOUT_S` breaks the same way.

``shard_map(..., collective_free=True)`` is the caller's word that
``local_fn`` calls no collective: its shards never meet, so they run
one after another on the caller's thread, each still under
``torch.cuda.device`` of its device (kernel launches are asynchronous,
so shards on distinct cards still overlap), with no thread started and
no barrier; a collective called there raises.  The sharded serve
endpoints take this path on every micro-batch.

A spec is :class:`~csmom_tpu_torch.mesh.rules.P` (``PartitionSpec``):
one entry per leading dimension, each a mesh axis name, a tuple of names
(split over their product, the first the major one) or ``None`` (not
split); dimensions past the spec are not split.  ``out_specs`` is a tree of specs (tuples,
lists, dicts and dataclass instances) matching ``local_fn``'s result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import numpy as np
import torch

from csmom_tpu_torch.mesh.rules import P, PartitionSpec

__all__ = ["BARRIER_TIMEOUT_S", "P", "PartitionSpec", "all_gather",
           "axis_index", "axis_size", "ppermute", "psum", "shard_map"]

# the longest any shard waits at a collective for the others
BARRIER_TIMEOUT_S = 900.0


def _names(entry) -> tuple:
    """The mesh axis names of one spec entry (``None`` -> none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class _Run:
    """The state one :func:`shard_map` call shares between its shards."""

    def __init__(self, mesh, collective_free: bool = False):
        self.mesh = mesh
        self.coords = [dict(zip(mesh.axis_names, np.unravel_index(k, mesh.devices.shape)))
                       for k in range(mesh.size)]
        self.barrier = (None if collective_free else
                        threading.Barrier(mesh.size, timeout=BARRIER_TIMEOUT_S))
        self.slots: dict = {}
        self.lock = threading.Lock()
        self._groups: dict = {}

    def group(self, k: int, names: tuple) -> list:
        """Shard ``k``'s group along ``names``: the shards that agree with
        it on every other axis, ordered by their index along ``names``."""
        key = (k, names)
        if key not in self._groups:
            mine = self.coords[k]
            members = [j for j, c in enumerate(self.coords)
                       if all(c[a] == mine[a] for a in self.mesh.axis_names
                              if a not in names)]
            members.sort(key=lambda j: self.index(j, names))
            self._groups[key] = members
        return self._groups[key]

    def index(self, k: int, names: tuple) -> int:
        """Shard ``k``'s index along ``names`` (mixed radix, the first
        name the major digit)."""
        i = 0
        for a in names:
            i = i * self.mesh.shape[a] + int(self.coords[k][a])
        return i


class _Shard:
    def __init__(self, run: _Run, k: int, device: torch.device):
        self.run, self.k, self.device, self.seq = run, k, device, 0


_LOCAL = threading.local()


def _shard() -> _Shard:
    ctx = getattr(_LOCAL, "shard", None)
    if ctx is None:
        raise RuntimeError("a collective was called outside shard_map")
    return ctx


def _axis(axis_name) -> tuple:
    names = _names(axis_name)
    mesh = _shard().run.mesh
    for a in names:
        if a not in mesh.shape:
            raise ValueError(f"mesh has axes {mesh.axis_names}, no {a!r}")
    return names


def _exchange(value, axis_name):
    """Deposit ``value``, wait for every shard, return ``(group's values
    in shard order, this shard's index in the group)``."""
    ctx = _shard()
    names = _axis(axis_name)
    run, seq = ctx.run, ctx.seq
    if run.barrier is None:
        raise RuntimeError("a collective was called in a collective-free "
                           "shard_map")
    ctx.seq += 1
    with run.lock:
        run.slots.setdefault(seq, {})[ctx.k] = value
    run.barrier.wait()
    members = run.group(ctx.k, names)
    vals = [run.slots[seq][j] for j in members]
    if ctx.k == 0:
        # every shard has read slot seq - 1 before it deposited into seq
        with run.lock:
            run.slots.pop(seq - 1, None)
    return vals, members.index(ctx.k)


def _to_mine(v):
    return v.to(_shard().device, non_blocking=True) if torch.is_tensor(v) else v


def axis_index(axis_name) -> int:
    """This shard's index along ``axis_name`` (a name or a tuple)."""
    ctx = _shard()
    return ctx.run.index(ctx.k, _axis(axis_name))


def axis_size(axis_name) -> int:
    mesh = _shard().run.mesh
    return math.prod(mesh.shape[a] for a in _axis(axis_name))


def psum(x, axis_name):
    """The sum of ``x`` over the group along ``axis_name``, added in
    shard order on this shard's device."""
    vals, _ = _exchange(x, axis_name)
    acc = _to_mine(vals[0])
    for v in vals[1:]:
        acc = acc + _to_mine(v)
    return acc


def all_gather(x, axis_name, dim: int = 0, tiled: bool = False):
    """The group's ``x`` in shard order: stacked on a new dimension
    ``dim``, or concatenated along ``dim`` when ``tiled``."""
    vals, _ = _exchange(x, axis_name)
    vals = [_to_mine(v) for v in vals]
    return torch.cat(vals, dim=dim) if tiled else torch.stack(vals, dim=dim)


def ppermute(x, axis_name, perm):
    """``perm`` is ``[(source, destination), ...]`` of indices along
    ``axis_name``: a shard receives its source's ``x``, or zeros when no
    pair names it as a destination."""
    vals, i = _exchange(x, axis_name)
    src = [s for s, d in perm if d == i]
    return _to_mine(vals[src[0]]) if src else torch.zeros_like(x)


# -- the tree of specs ---------------------------------------------------


def _map_spec_tree(spec, results, leaf):
    """Walk ``spec`` (a tree of :class:`P`) and the shards' ``results``
    (one tree each) together; ``leaf(spec, [values])`` at each leaf."""
    if isinstance(spec, P):
        return leaf(spec, results)
    if dataclasses.is_dataclass(spec) and not isinstance(spec, type):
        return dataclasses.replace(spec, **{
            f.name: _map_spec_tree(getattr(spec, f.name),
                                   [getattr(r, f.name) for r in results], leaf)
            for f in dataclasses.fields(spec)})
    if isinstance(spec, (tuple, list)):
        if any(len(r) != len(spec) for r in results):
            raise ValueError(f"out_specs has {len(spec)} entries, the result "
                             f"{len(results[0])}")
        out = [_map_spec_tree(s, [r[i] for r in results], leaf)
               for i, s in enumerate(spec)]
        return tuple(out) if isinstance(spec, tuple) else out
    if isinstance(spec, dict):
        return {k: _map_spec_tree(s, [r[k] for r in results], leaf)
                for k, s in spec.items()}
    raise TypeError(f"out_specs leaf {spec!r} is not a P")


def _split(x, spec: P, run: _Run, k: int, device):
    """Shard ``k``'s block of the input ``x`` on ``device``."""
    if x is None or not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
        if any(_names(e) for e in spec):
            raise TypeError(f"a sharded input must be an array, got {type(x)}")
        return x
    x = torch.as_tensor(x)
    mesh = run.mesh
    for d, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        n = math.prod(mesh.shape[a] for a in names)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"divide over {n} shards of {names}")
        size = x.shape[d] // n
        x = x.narrow(d, run.index(k, names) * size, size)
    return x.to(device, non_blocking=True).contiguous()


def _assemble(spec: P, leaves: list, run: _Run):
    """One output from the shards' blocks, on the mesh's first device."""
    mesh = run.mesh
    home = mesh.device_list[0]
    used = {a for e in spec for a in _names(e)}
    if not used:
        v = leaves[0]
        return v.to(home) if torch.is_tensor(v) else v
    dims = [d for d, e in enumerate(spec) if _names(e)]
    blocks = {}
    for k, leaf in enumerate(leaves):
        # replicated along the axes the spec does not name: the first copy
        if any(run.coords[k][a] for a in mesh.axis_names if a not in used):
            continue
        blocks[tuple(run.index(k, _names(spec[d])) for d in dims)] = leaf
    sizes = [math.prod(mesh.shape[a] for a in _names(spec[d])) for d in dims]

    def cat(prefix: tuple):
        if len(prefix) == len(dims):
            return blocks[prefix].to(home)
        return torch.cat([cat(prefix + (i,)) for i in range(sizes[len(prefix)])],
                         dim=dims[len(prefix)])

    return cat(())


def shard_map(local_fn, *, mesh, in_specs, out_specs, collective_free: bool = False):
    """``local_fn`` mapped over ``mesh``: ``fn(*args)`` runs it once per
    shard (see the module docstring) and returns its assembled outputs.
    ``in_specs`` has one :class:`P` per positional argument; non-array
    arguments (``None``, numbers) pass to every shard as they are.
    With ``collective_free`` the shards run in order on the caller's
    thread.  Nothing checks that a replicated output is replicated (the
    reference's ``check_vma``)."""
    in_specs = tuple(in_specs)

    def run_fn(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        run = _Run(mesh, collective_free)
        n = mesh.size
        results: list = [None] * n
        errors: list = [None] * n

        def body(k):
            dev = mesh.device_list[k]
            outer = getattr(_LOCAL, "shard", None)
            _LOCAL.shard = _Shard(run, k, dev)
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    local = [_split(a, s, run, k, dev) for a, s in zip(args, in_specs)]
                    results[k] = local_fn(*local)
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors[k] = e
                if run.barrier is not None:
                    run.barrier.abort()
            finally:
                _LOCAL.shard = outer

        if n == 1 or collective_free:
            for k in range(n):
                body(k)
                if errors[k] is not None:
                    break
        else:
            threads = [threading.Thread(target=body, args=(k,), daemon=True,
                                        name=f"shard_map-{k}") for k in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        if first is not None:
            raise first
        broken = next((e for e in errors if e is not None), None)
        if broken is not None:
            raise TimeoutError(
                f"a shard of {mesh} waited over {BARRIER_TIMEOUT_S} s at a "
                "collective") from broken
        return _map_spec_tree(out_specs, results,
                              lambda s, leaves: _assemble(s, leaves, run))

    return run_fn

