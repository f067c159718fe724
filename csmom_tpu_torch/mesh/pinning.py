"""Device-slice pinning arithmetic — stdlib-only, shared across processes.

A copy of :mod:`csmom_tpu.mesh.pinning` (the port imports nothing of the
JAX package), used by the serving pool (``PoolConfig.devices_per_worker``)
and the worker's ``--device-slice``.

The pool's pinning contract: a worker slot owns a FIXED
contiguous slice of the process's device list, ``slot * per : slot *
per + per``.  The slice is a function of the slot alone, so a
replacement worker spawned into the same slot re-pins the same devices
by construction — the supervisor does not track slices, it derives
them, and the rehearsal only has to check the derivation was honored
(the spawn events and ready reports both carry the slice string).

The slice crosses the process boundary as an env var
(:data:`DEVICE_SLICE_ENV`, value ``"<start>:<count>"``) because the
worker must know its slice BEFORE it builds an engine, and because env
inheritance is the same channel the fault plans already ride.

Everything here is integer arithmetic on strings — no torch, no numpy —
so the torch-free supervisor, the stub-engine rehearse tier, and
``serve/health.py`` can all import it for free.
"""

from __future__ import annotations

__all__ = [
    "DEVICE_SLICE_ENV",
    "parse_device_slice",
    "shards_for",
    "slice_for_slot",
]

# worker processes read their pinned slice from here ("<start>:<count>");
# set by the supervisor at spawn, re-set identically at every respawn of
# the same slot
DEVICE_SLICE_ENV = "CSMOM_MESH_DEVICE_SLICE"


def slice_for_slot(slot: int, devices_per_worker: int) -> str:
    """The canonical slice string for one worker slot."""
    if slot < 0 or devices_per_worker <= 0:
        raise ValueError(
            f"need slot >= 0 and devices_per_worker > 0, got "
            f"slot={slot}, devices_per_worker={devices_per_worker}")
    return f"{slot * devices_per_worker}:{devices_per_worker}"


def parse_device_slice(value: str) -> tuple:
    """``"<start>:<count>"`` -> ``(start, count)``; raises on garbage so
    a mis-plumbed env var fails at worker startup, not mid-dispatch."""
    try:
        start_s, _, count_s = value.partition(":")
        start, count = int(start_s), int(count_s)
    except (AttributeError, ValueError):
        raise ValueError(
            f"bad device slice {value!r}: expected '<start>:<count>', "
            "e.g. '4:2'") from None
    if start < 0 or count <= 0:
        raise ValueError(
            f"bad device slice {value!r}: start must be >= 0 and count "
            "> 0")
    return start, count


def shards_for(n: int, max_shards: int) -> int:
    """Largest shard count <= ``max_shards`` that divides ``n`` evenly.

    The mesh layer never pads a serve bucket axis (padding would change
    the dispatched shape set the warmup contract closed over), so an
    axis of length ``n`` on ``d`` devices shards ``shards_for(n, d)``
    ways — 1 when nothing divides, which IS the single-device
    degenerate path.
    """
    if n <= 0 or max_shards <= 0:
        return 1
    for d in range(min(n, max_shards), 0, -1):
        if n % d == 0:
            return d
    return 1
