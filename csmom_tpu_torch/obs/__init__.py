"""Run telemetry of the serving tier: spans, a metrics registry, traces.

Counterpart of the parts of ``csmom_tpu.obs`` the in-process service
uses:

- :mod:`~csmom_tpu_torch.obs.spans`: nestable, thread-safe spans emitted
  as a JSON-lines event stream;
- :mod:`~csmom_tpu_torch.obs.metrics`: a process-wide registry of
  counters, gauges and histograms, with the allocator's memory and the
  kernel-build count in its snapshots;
- :mod:`~csmom_tpu_torch.obs.trace`: per-request stage clocks and
  closed trace books.

Zero-cost when disarmed: with no collector armed, ``span()`` returns a
shared no-op singleton and ``metric.inc()`` is one global load and
compare.  Arming is explicit (:func:`~csmom_tpu_torch.obs.spans.arm`) or
by environment (``CSMOM_TELEMETRY``).
"""

from csmom_tpu_torch.obs import metrics, spans, trace
from csmom_tpu_torch.obs.spans import (
    arm,
    arm_from_env,
    arm_policy,
    armed,
    disarm,
    point,
    span,
)

__all__ = [
    "arm",
    "arm_from_env",
    "arm_policy",
    "armed",
    "disarm",
    "metrics",
    "point",
    "span",
    "spans",
    "trace",
]
