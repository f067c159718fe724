"""Run telemetry of the serving tier: spans, a metrics registry, traces,
and the fleet observatory.

Counterpart of the parts of ``csmom_tpu.obs`` the serving tier uses:

- :mod:`~csmom_tpu_torch.obs.spans`: nestable, thread-safe spans emitted
  as a JSON-lines event stream;
- :mod:`~csmom_tpu_torch.obs.metrics`: a process-wide registry of
  counters, gauges and histograms, with the allocator's memory and the
  kernel-build count in its snapshots;
- :mod:`~csmom_tpu_torch.obs.trace`: per-request stage clocks and
  closed trace books;
- :mod:`~csmom_tpu_torch.obs.memstats`: the device memory of each
  warm-up entry, read from the CUDA caching allocator;
- :mod:`~csmom_tpu_torch.obs.fleet`: the fleet observatory, every pool
  or fabric process streaming its metrics to one aggregator, and the
  ``GPU_FLEET_<run>.json`` artifact (demand book, lifecycle walls, the
  kill-window capacity account);
- :mod:`~csmom_tpu_torch.obs.timeline`: a run's event stream assembled
  into its phase timeline, the ``GPU_TELEMETRY_<run>.json`` sidecar.

Zero-cost when disarmed: with no collector armed, ``span()`` returns a
shared no-op singleton and ``metric.inc()`` is one global load and
compare.  Arming is explicit (:func:`~csmom_tpu_torch.obs.spans.arm`) or
by environment (``CSMOM_TELEMETRY``, ``CSMOM_FLEET``).  The names
resolve on first use, so importing the package loads neither torch nor
pandas.
"""

from __future__ import annotations

_SUBMODULES = ("fleet", "memstats", "metrics", "spans", "timeline", "trace")

_LAZY = {
    "arm": "csmom_tpu_torch.obs.spans",
    "arm_from_env": "csmom_tpu_torch.obs.spans",
    "arm_policy": "csmom_tpu_torch.obs.spans",
    "armed": "csmom_tpu_torch.obs.spans",
    "disarm": "csmom_tpu_torch.obs.spans",
    "point": "csmom_tpu_torch.obs.spans",
    "span": "csmom_tpu_torch.obs.spans",
}

__all__ = sorted((*_LAZY, *_SUBMODULES))


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"csmom_tpu_torch.obs.{name}")
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.obs' has no attribute {name!r}")
