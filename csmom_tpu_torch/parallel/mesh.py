"""Meshes: named arrays of torch devices, and the helpers that build them.

Counterpart of :mod:`csmom_tpu.parallel.mesh`.  A :class:`Mesh` is an
array of ``torch.device``\\ s with named axes (``("grid", "assets")``,
``("time",)``, ``("assets", "time")``), driven by one process through
:func:`csmom_tpu_torch.parallel.compat.shard_map`.  Each entry is one
logical shard, and a device may appear more than once: eight shards on
``cuda:0`` run the sharded engines on one card, eight on the CPU run
them in the CPU tests, and on a host with several cards the same code
spreads over distinct devices (cross-card copies are peer copies).

Layout principle (the reference's): the asset axis is the one with
collectives, so it stays within one host; grid cells and bootstrap
resamples are collective-free and may span hosts.  Meshes over several
hosts (``torch.distributed``) are not ported: :func:`distributed_init`
returns ``False`` for a plain run and raises for a coordinator.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

__all__ = ["Mesh", "auto_mesh", "distributed_init", "make_hybrid_mesh",
           "make_mesh", "mesh_topology", "pad_assets", "visible_devices"]


class Mesh:
    """Devices on named axes: ``Mesh(devices, axis_names)`` with
    ``devices`` a nested list (or array) of devices or device strings of
    one dimension per name.  ``shape`` maps each name to its size, in
    order; equal meshes hash alike, so callables cached per mesh are
    shared."""

    def __init__(self, devices, axis_names):
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

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.device_list))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.device_list})
        return f"Mesh({shape}; {', '.join(devs)})"


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
    """A 2-D mesh from a flat device list (default: the visible cards):
    ``grid_axis`` rows for parameter-grid parallelism, the rest of each
    row for the second axis.  ``grid_axis=1`` is a pure asset mesh."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if n % grid_axis != 0:
        raise ValueError(f"{n} devices not divisible by grid_axis={grid_axis}")
    rows = [devices[i * (n // grid_axis):(i + 1) * (n // grid_axis)]
            for i in range(grid_axis)]
    return Mesh(rows, axis_names)


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


# the environment of a launcher that meant a run over several processes
_COORDINATOR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                     "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR")
_WORLD_SIZE_VARS = ("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
                    "WORLD_SIZE")


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


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a run over several hosts.  ``False`` for a plain
    single-process run (no coordinator given and none in the
    environment), as in the reference.  Meshes over several processes
    (``torch.distributed``) are not ported: given a coordinator or a
    cluster environment, this raises ``NotImplementedError``."""
    if coordinator_address is None and num_processes in (None, 1) \
            and not _cluster_env_present():
        return False
    raise NotImplementedError(
        "meshes over several hosts (torch.distributed) are not ported yet "
        "(ROADMAP.md, Queue 1 item 7c); one process drives every shard of a "
        "mesh on this host")


def _group_by_host(devices, n_hosts: int | None) -> list:
    """A flat device list in per-host rows.  Every device of this
    process is on one host, so an explicit ``n_hosts`` splits the list
    evenly to emulate a topology (the reference's CPU-mesh test path)."""
    n = len(devices)
    n_hosts = n_hosts or 1
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by n_hosts={n_hosts}")
    per = n // n_hosts
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_hosts)]


def make_hybrid_mesh(devices=None, n_hosts: int | None = None,
                     axis_names=("grid", "assets")) -> Mesh:
    """A 2-D mesh whose first axis spans hosts (the collective-free axis)
    and whose second stays within one (the asset axis)."""
    devices = visible_devices() if devices is None else list(devices)
    return Mesh(_group_by_host(devices, n_hosts), axis_names)


def mesh_topology(mesh: Mesh) -> dict:
    """Each axis's size and whether it crosses hosts (never, here: one
    process drives every shard)."""
    return {name: {"size": int(mesh.shape[name]), "crosses_hosts": False}
            for name in mesh.axis_names}


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
