"""Meshes: named arrays of torch devices, and the helpers that build them.

Counterpart of :mod:`csmom_tpu.parallel.mesh`.  A :class:`Mesh` is an
array of ``torch.device``\\ s with named axes (``("grid", "assets")``,
``("time",)``, ``("assets", "time")``), driven through
:func:`csmom_tpu_torch.parallel.compat.shard_map`.  Each entry is one
logical shard, and a device may appear more than once: eight shards on
``cuda:0`` run the sharded engines on one card, eight on the CPU run
them in the CPU tests, and on a host with several cards the same code
spreads over distinct devices (cross-card copies are peer copies).

A mesh may span several processes (:func:`distributed_init`): each entry
then also names the process that owns it (``Mesh(..., processes=)``),
each process drives its own shards as a single controller, and only the
collectives whose groups span processes cross between them.

Layout principle (the reference's): the asset axis is the one with
collectives, so it stays within one host; grid cells and bootstrap
resamples are collective-free and may span hosts (:func:`make_hybrid_mesh`).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import os
import socket

import numpy as np
import torch

__all__ = ["Mesh", "auto_mesh", "backend", "distributed_init",
           "distributed_shutdown", "global_devices", "make_hybrid_mesh",
           "make_mesh", "mesh_topology", "pad_assets", "pick_backend",
           "process_allgather", "process_count", "process_index",
           "visible_devices"]


class Mesh:
    """Devices on named axes: ``Mesh(devices, axis_names)`` with
    ``devices`` a nested list (or array) of devices or device strings of
    one dimension per name.  ``shape`` maps each name to its size, in
    order; equal meshes hash alike, so callables cached per mesh are
    shared.

    ``processes`` (nested like ``devices``) names the process that owns
    each entry; by default every entry is this process's.  A process
    runs only its own entries (``local_shards``), and its outputs land
    on the first of them (``home``)."""

    def __init__(self, devices, axis_names, processes=None):
        given = np.array(devices, dtype=object)
        flat = [torch.device(d) for d in given.reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(given.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 self.devices.shape))
        self.device_list = tuple(flat)
        self.size = len(flat)
        me = process_index()
        if processes is None:
            self.processes = (me,) * self.size
        else:
            procs = np.array(processes, dtype=object)
            if procs.shape != given.shape:
                raise ValueError(f"processes of shape {procs.shape} for "
                                 f"devices of shape {given.shape}")
            self.processes = tuple(int(p) for p in procs.reshape(-1))
        self.local_shards = tuple(k for k, p in enumerate(self.processes)
                                  if p == me)
        if not self.local_shards:
            raise ValueError(f"the mesh holds no shard of process {me}")
        self.home = self.device_list[self.local_shards[0]]
        self.n_processes = len(set(self.processes))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.device_list), self.processes)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.device_list})
        procs = (f"; {self.n_processes} processes" if self.n_processes > 1
                 else "")
        return f"Mesh({shape}; {', '.join(devs)}{procs})"


def visible_devices() -> list:
    """Every visible CUDA device; raises without one, naming the CPU
    meshes (``auto_mesh(n, device="cpu")``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible for a mesh; pass devices=[...] or "
            "build logical CPU shards with auto_mesh(n, device='cpu')")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, grid_axis: int = 1, axis_names=("grid", "assets")) -> Mesh:
    """A 2-D mesh from a flat device list (default: the visible cards,
    or every process's devices in a joined run): ``grid_axis`` rows for
    parameter-grid parallelism, the rest of each row for the second
    axis.  ``grid_axis=1`` is a pure asset mesh."""
    processes = None
    if devices is None:
        devices, processes = global_devices()
    devices = list(devices)
    n = len(devices)
    if n % grid_axis != 0:
        raise ValueError(f"{n} devices not divisible by grid_axis={grid_axis}")

    def rows(xs):
        return [xs[i * (n // grid_axis):(i + 1) * (n // grid_axis)]
                for i in range(grid_axis)]

    return Mesh(rows(devices), axis_names,
                None if processes is None else rows(list(processes)))


def auto_mesh(n_devices: int | None = None, prefer_grid: bool = False,
              device=None) -> Mesh:
    """A mesh over ``n_devices`` shards; a grid axis of 2 when
    ``prefer_grid`` and the count is even.

    ``device=None`` or ``"cuda"``: the first ``n_devices`` visible cards
    (all of them by default).  A single device (``"cpu"``, ``"cuda:0"``):
    ``n_devices`` logical shards on it (1 by default).
    """
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        devices = visible_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    else:
        devices = [dev] * (n_devices or 1)
    grid = 2 if (prefer_grid and len(devices) % 2 == 0 and len(devices) > 1) else 1
    return make_mesh(devices, grid_axis=grid)


# the environment of a launcher that meant a run over several processes:
# the reference's variables and torch's
_COORDINATOR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                     "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR")
_WORLD_SIZE_VARS = ("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
                    "WORLD_SIZE", "JAX_NUM_PROCESSES")
_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID", "RANK",
              "JAX_PROCESS_ID")
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class _Joined:
    """This process's place in a joined run: its rank, the world size,
    the process group's backend, and every process's devices."""

    rank: int
    world: int
    backend: str
    devices: tuple      # per process: a tuple of device strings


_JOINED = None


def process_index() -> int:
    """This process's rank in the joined run (0 when not joined)."""
    return 0 if _JOINED is None else _JOINED.rank


def process_count() -> int:
    """The joined run's world size (1 when not joined)."""
    return 1 if _JOINED is None else _JOINED.world


def backend():
    """The joined run's process-group backend, ``None`` when not joined."""
    return None if _JOINED is None else _JOINED.backend


def global_devices():
    """``(devices, processes)``: every process's devices in rank order and
    the rank owning each, in a joined run; the visible cards and ``None``
    otherwise (which raises without a card)."""
    if _JOINED is None:
        return visible_devices(), None
    devices, processes = [], []
    for rank, devs in enumerate(_JOINED.devices):
        devices += [torch.device(d) for d in devs]
        processes += [rank] * len(devs)
    return devices, processes


def _cluster_env_present() -> bool:
    """Did the environment intend a run over several processes?  Only a
    coordinator address, more than one TPU host name or a world size
    over 1 says so (a single-host image may set these to one host)."""
    if any(os.environ.get(v) for v in _COORDINATOR_VARS):
        return True
    hosts = [h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",")
             if h.strip()]
    if len(hosts) > 1:
        return True
    for v in _WORLD_SIZE_VARS:
        try:
            if int(os.environ.get(v, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def _from_env(names) -> int | None:
    for v in names:
        if os.environ.get(v, "").strip():
            return int(os.environ[v])
    return None


def _coordinator_from_env() -> str | None:
    for v in _COORDINATOR_VARS[:3]:
        if os.environ.get(v):
            return os.environ[v]
    if os.environ.get("MASTER_ADDR"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def pick_backend(peers, requested: str | None = None) -> str:
    """The process-group backend for ``peers`` (one ``(host, device
    strings)`` a process): ``gloo`` when any process's shards are CPU
    devices or two processes share a card, ``nccl`` when every process
    owns cards of its own.  NCCL refuses two ranks on one card, so asking
    for it there (or for CPU shards) raises."""
    cpu = any(torch.device(d).type != "cuda" for _, devs in peers for d in devs)
    owner: dict = {}
    shared = False
    for rank, (host, devs) in enumerate(peers):
        for d in {str(torch.device(d)) for d in devs}:
            if owner.setdefault((host, d), rank) != rank:
                shared = True
    if requested is None:
        return "gloo" if cpu or shared else "nccl"
    if requested not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {requested!r}")
    if requested == "nccl" and (cpu or shared):
        raise ValueError(
            "backend 'nccl' needs every process on cards of its own: "
            + ("a process's shards are CPU devices" if cpu else
               "two processes share a card, which NCCL refuses")
            + "; use 'gloo'")
    return requested


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, devices=None,
                     backend: str | None = None) -> bool:
    """Join a run over several processes, as the reference's
    ``jax.distributed.initialize`` does.

    ``False`` for a plain single-process run (no coordinator given and
    none in the environment), and when this process has already joined
    (or a launcher initialized ``torch.distributed``).  Otherwise the
    process meets the others at a ``tcp://`` rendezvous on
    ``coordinator_address`` (``host:port``; else the reference's
    variables or torch's ``MASTER_ADDR``/``MASTER_PORT``), with its rank
    and the world size from the arguments or the environment (torch's
    ``RANK``/``WORLD_SIZE``, MPI's, SLURM's), publishes ``devices`` (its
    local shards; default: the visible cards, which raises without one,
    naming ``devices=['cpu']``), picks the backend (:func:`pick_backend`,
    or ``backend`` when given and allowed), joins
    ``torch.distributed.init_process_group`` with a timeout of
    :data:`~csmom_tpu_torch.parallel.compat.BARRIER_TIMEOUT_S` and
    returns ``True``.  Real failures propagate."""
    global _JOINED
    import torch.distributed as dist

    if _JOINED is not None or (dist.is_available() and dist.is_initialized()):
        return False
    if coordinator_address is None and num_processes in (None, 1) \
            and not _cluster_env_present():
        return False
    address = coordinator_address or _coordinator_from_env()
    world = num_processes if num_processes is not None else _from_env(_WORLD_SIZE_VARS)
    rank = process_id if process_id is not None else _from_env(_RANK_VARS)
    missing = [name for name, v in (("coordinator_address", address),
                                    ("num_processes", world),
                                    ("process_id", rank)) if v is None]
    if missing:
        raise ValueError(f"a run over several processes needs {missing}: pass "
                         "them or set MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a world of {world}")
    if devices is None:
        try:
            devices = visible_devices()
        except RuntimeError:
            raise RuntimeError(
                "no CUDA device is visible to join a run; pass "
                "devices=['cpu'] (logical CPU shards) to run on the CPU") from None
    devices = [str(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("a process joins with at least one device")
    from csmom_tpu_torch.parallel import compat

    timeout = datetime.timedelta(seconds=compat.BARRIER_TIMEOUT_S)
    store, rank, world = next(dist.rendezvous(
        f"tcp://{address}?rank={rank}&world_size={world}", timeout=timeout))
    store.set(f"csmom/peer/{rank}", json.dumps([socket.gethostname(), devices]))
    peers = [tuple(json.loads(store.get(f"csmom/peer/{r}")))
             for r in range(world)]
    chosen = pick_backend(peers, backend)
    bound = {}
    if chosen == "nccl":
        # NCCL's communicator lives on one card: the first of this
        # process's devices (process_allgather runs there, from any thread)
        torch.cuda.set_device(torch.device(devices[0]))
        bound = {"device_id": torch.device(devices[0])}
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world,
                            timeout=timeout, **bound)
    _JOINED = _Joined(rank=rank, world=world, backend=chosen,
                      devices=tuple(tuple(d) for _, d in peers))
    return True


def distributed_shutdown() -> None:
    """Leave the joined run (destroy its process group); a no-op when
    this process has not joined."""
    global _JOINED
    if _JOINED is None:
        return
    import torch.distributed as dist

    _JOINED = None
    if dist.is_initialized():
        dist.destroy_process_group()


def process_allgather(obj) -> list:
    """Every process's ``obj``, in rank order (one collective of the
    joined run's group; ``[obj]`` when not joined).  Tensors in ``obj``
    travel as they are pickled: callers move them to host memory.

    Over ``nccl`` the pickled bytes cross on the card the group was bound
    to at the join, whatever card the calling thread's shard runs on, so
    every collective of a process uses one communicator."""
    if _JOINED is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * _JOINED.world
    if _JOINED.backend == "nccl":
        with torch.cuda.device(torch.device(_JOINED.devices[_JOINED.rank][0])):
            dist.all_gather_object(out, obj)
    else:
        dist.all_gather_object(out, obj)
    return out


def _group_by_host(devices, n_hosts: int | None, processes=None) -> list:
    """A flat device list in per-host rows.  With ``processes`` naming
    more than one owner, each row is one process's devices (``n_hosts``
    must agree); otherwise an explicit ``n_hosts`` splits the list evenly
    to emulate a topology (the reference's CPU-mesh test path)."""
    if processes is not None and len(set(processes)) > 1:
        by_proc = collections.defaultdict(list)
        for d, p in zip(devices, processes):
            by_proc[p].append(d)
        rows = [by_proc[p] for p in sorted(by_proc)]
        sizes = {len(r) for r in rows}
        if len(sizes) != 1:
            raise ValueError(f"uneven devices per host: {sorted(sizes)}")
        if n_hosts is not None and n_hosts != len(rows):
            raise ValueError(f"n_hosts={n_hosts} but {len(rows)} processes present")
        return rows
    n = len(devices)
    n_hosts = n_hosts or 1
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by n_hosts={n_hosts}")
    per = n // n_hosts
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_hosts)]


def make_hybrid_mesh(devices=None, n_hosts: int | None = None,
                     axis_names=("grid", "assets"), processes=None) -> Mesh:
    """A 2-D mesh whose first axis spans hosts (the collective-free axis)
    and whose second stays within one (the asset axis).  In a joined run
    ``devices=None`` takes every process's devices, one row a process."""
    if devices is None:
        devices, processes = global_devices()
    rows = _group_by_host(list(devices), n_hosts, processes)
    owners = (None if processes is None
              else _group_by_host(list(processes), n_hosts, processes))
    return Mesh(rows, axis_names, owners)


def mesh_topology(mesh: Mesh) -> dict:
    """Each axis's size and whether it crosses hosts: an axis crosses
    when one of its groups holds shards of several processes, and then
    its entry also names the joined run's backend."""
    procs = np.array(mesh.processes, dtype=np.int64).reshape(mesh.devices.shape)
    out = {}
    for ax, name in enumerate(mesh.axis_names):
        cols = np.moveaxis(procs, ax, -1).reshape(-1, procs.shape[ax])
        crosses = bool(any(len(set(c.tolist())) > 1 for c in cols))
        out[name] = {"size": int(mesh.shape[name]), "crosses_hosts": crosses}
        if crosses:
            out[name]["backend"] = backend()
    return out


def pad_assets(values, mask, n_shards: int):
    """Pad the leading asset axis of host arrays to a multiple of the
    shard count with masked-out NaN rows, which every engine treats as
    never-observed assets: ``(values, mask, A_original)``."""
    A = values.shape[0]
    pad = (-A) % n_shards
    if pad == 0:
        return values, mask, A
    vp = np.concatenate([values, np.full((pad,) + values.shape[1:], np.nan, values.dtype)])
    mp = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
    return vp, mp, A
