"""Deterministic fault injection for the serving tier.

Counterpart of ``csmom_tpu.chaos``: the plan format and the checkpoint
runtime, copied, and the serve artifact's validator.

- :mod:`~csmom_tpu_torch.chaos.plan`: seeded, serializable fault plans
  (``CSMOM_FAULT_PLAN``, a path to a TOML file or inline TOML);
- :mod:`~csmom_tpu_torch.chaos.inject`: the ``checkpoint("name")`` hooks
  the queue, the cache, the batcher and the service call; no-ops unless
  a plan or telemetry is armed;
- :mod:`~csmom_tpu_torch.chaos.invariants`: the ``serve`` artifact's
  schema and closed-book rules.
"""

from csmom_tpu_torch.chaos.inject import checkpoint  # noqa: F401
from csmom_tpu_torch.chaos.plan import Fault, FaultPlan  # noqa: F401
