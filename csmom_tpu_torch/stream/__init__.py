"""Live-panel streaming: ring buffer, watermark ingest, incremental
signals, and the event-time replay harness.

Counterpart of ``csmom_tpu.stream``.  The data-plane modules (``ring``,
``ingest``, ``incremental``) are numpy and stdlib only, so importing this
package loads neither torch nor pandas; the torch reconcile of a replay
(:mod:`csmom_tpu_torch.stream.replay`, ``engine="torch"``) imports torch
only when it runs.
"""

from csmom_tpu_torch.stream.incremental import (
    IncrementalMomentum,
    IncrementalTurnover,
    full_momentum_np,
    full_turnover_np,
)
from csmom_tpu_torch.stream.ingest import StreamIngestor, Tick, WatermarkPolicy
from csmom_tpu_torch.stream.ring import LiveRing, RingSnapshot

__all__ = [
    "IncrementalMomentum",
    "IncrementalTurnover",
    "LiveRing",
    "RingSnapshot",
    "StreamIngestor",
    "Tick",
    "WatermarkPolicy",
    "full_momentum_np",
    "full_turnover_np",
]
