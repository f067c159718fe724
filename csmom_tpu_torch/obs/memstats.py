"""Per-shape device memory from the CUDA caching allocator.

Counterpart of ``csmom_tpu.obs.memstats``.  The reference reads XLA's
``memory_analysis()`` of each compiled shape; eager torch compiles no
shape, so the port measures one warm call of each warm-up entry
(:mod:`csmom_tpu_torch.compile.aot`) with the caching allocator:

- ``argument_size_in_bytes``: the inputs' ``nbytes``;
- ``output_size_in_bytes``: the outputs' ``nbytes``;
- ``peak_memory_in_bytes``: ``torch.cuda.max_memory_allocated()`` over
  the call, with the peak reset once the inputs are resident, less the
  allocator's count before the inputs were made; it is the stats'
  ``peak_bytes`` (``peak_source`` names it);
- ``temp_size_in_bytes``: the peak less arguments and outputs, never
  below 0.

Fields torch cannot account (``alias_size_in_bytes``,
``generated_code_size_in_bytes``) are left out, never zeroed, as the
reference leaves out what a backend does not report.  On the CPU there
is no allocator to read: :func:`measure` returns a reason string, as the
reference's capture does when a backend gives no analysis.

Captured stats land in the warm-up record and report and in the
process-wide table here, which :func:`csmom_tpu_torch.obs.metrics.snapshot`
puts under ``"memory"`` in the reference's form (entry name -> bytes
dict or reason).  Stdlib-only at import.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = [
    "BYTE_FIELDS",
    "capture",
    "measure",
    "nbytes",
    "peak_bytes",
    "record",
    "reset",
    "snapshot",
]

# the byte fields persisted, in report order (all ints)
BYTE_FIELDS = (
    "argument_size_in_bytes",
    "output_size_in_bytes",
    "temp_size_in_bytes",
)
_PEAK_FIELD = "peak_memory_in_bytes"

_LOCK = threading.Lock()
_REGISTRY: dict = {}  # entry name -> bytes dict (or capture-failure reason)


def nbytes(obj) -> int:
    """Total ``nbytes`` of the tensors in ``obj`` (tensors, tuples, lists,
    dicts and dataclasses, nested; each tensor counted once)."""
    import torch

    seen: set = set()

    def walk(o) -> int:
        if isinstance(o, torch.Tensor):
            if id(o) in seen:
                return 0
            seen.add(id(o))
            return o.nbytes
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return sum(walk(getattr(o, f.name)) for f in dataclasses.fields(o))
        if isinstance(o, (tuple, list)):
            return sum(walk(v) for v in o)
        if isinstance(o, dict):
            return sum(walk(v) for v in o.values())
        return 0

    return walk(obj)


def measure(call, args, baseline: int | None):
    """Run ``call()`` once and read the allocator around it.

    ``args`` are the call's resident inputs and ``baseline`` the
    allocator's ``memory_allocated()`` before they were made (None on
    the CPU).  Returns ``(out, stats)``: the bytes dict on the card, a
    reason string on the CPU.
    """
    import torch

    if baseline is None:
        return call(), ("not available: a CPU call has no caching "
                        "allocator to read")
    # the inputs' bytes before the call: a donated call consumes them
    arg_b = nbytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - baseline
    out_b = nbytes(out)
    return out, {
        "argument_size_in_bytes": arg_b,
        "output_size_in_bytes": out_b,
        "temp_size_in_bytes": max(0, peak - arg_b - out_b),
        _PEAK_FIELD: peak,
        "peak_bytes": peak,
        "peak_source": _PEAK_FIELD,
    }


def record(name: str, stats: dict | str) -> None:
    """Register one shape's stats in the process-wide table (last write
    wins: warming a shape again measures it again)."""
    with _LOCK:
        _REGISTRY[name] = stats


def capture(name: str, stats: dict | str, platform: str | None = None) -> dict | str:
    """Register one entry's :func:`measure` stats, stamped with the
    ``platform`` the bytes belong to; returns what was recorded."""
    if isinstance(stats, dict):
        stats = dict(stats)
        if platform:
            stats["platform"] = platform
    record(name, stats)
    return stats


def peak_bytes(stats) -> int | None:
    """The comparable scalar of one entry (None for failure reasons)."""
    if isinstance(stats, dict) and isinstance(stats.get("peak_bytes"), int):
        return stats["peak_bytes"]
    return None


def snapshot() -> dict:
    """All captured shapes: ``{entry_name: bytes_dict_or_reason}``."""
    with _LOCK:
        return dict(_REGISTRY)


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()
