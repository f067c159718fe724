"""Backtest engines.  The event engine's entry points are exported here,
as the JAX package exports them; the monthly, grid and research engines
are imported from their modules."""

from csmom_tpu_torch.backtest.event import (
    CostAttribution,
    EventResult,
    cost_attribution,
    event_backtest,
    hysteresis_event_backtest,
    threshold_sweep,
    trades_dataframe,
)

__all__ = [
    "CostAttribution",
    "EventResult",
    "cost_attribution",
    "event_backtest",
    "hysteresis_event_backtest",
    "threshold_sweep",
    "trades_dataframe",
]
