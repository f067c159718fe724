"""Asset-sharded event backtests: the intraday engines over the asset axis.

Counterpart of :mod:`csmom_tpu.parallel.event`.  The event engine is
per asset except its cross-asset sums: signed order flow per bar (the
cash ledger), the marked book (portfolio value), the bar count and the
trade counters.  Each is a psum of a ``[T]`` vector or a scalar, so
splitting the minute panel's asset axis costs a few small collectives a
call.  Limit fills are keyed by the global (asset, bar) cell, so a
replicated ``fill_key`` draws the single-device fills on any shard
count.  The hysteresis engine shards the same way.
"""

from __future__ import annotations

from functools import partial

from csmom_tpu_torch.backtest.event import (
    EventResult,
    event_backtest,
    hysteresis_event_backtest,
)
from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.parallel.compat import shard_map

__all__ = ["sharded_event_backtest", "sharded_hysteresis_backtest"]


def _asset_specs(axis_name):
    """The engines' in and out specs with assets split over ``axis_name``."""
    a2, a1 = P(axis_name, None), P(axis_name)
    out = EventResult(
        pnl=P(), bar_mask=P(), portfolio_value=P(), cash=P(),
        positions=a2, trade_side=a2, exec_price=a2, impact=a1,
        total_pnl=P(), n_trades=P(), n_buys=P(), n_sells=P(),
        net_notional=P(),
    )
    return (a2, a2, a2, a1, a1), out


def _sharded(engine, price, valid, score, adv, vol, mesh, axis_name, kwargs):
    A = price.shape[0]
    n_shards = mesh.shape[axis_name]
    if A % n_shards:
        raise ValueError(f"A={A} not divisible by {n_shards} shards; "
                         "pad_assets first")
    in_specs, out_specs = _asset_specs(axis_name)
    return shard_map(partial(engine, axis_name=axis_name, **kwargs), mesh=mesh,
                     in_specs=in_specs, out_specs=out_specs)(
        price, valid, score, adv, vol)


def sharded_event_backtest(price, valid, score, adv, vol, mesh,
                           axis_name: str = "assets", **kwargs) -> EventResult:
    """:func:`~csmom_tpu_torch.backtest.event.event_backtest` with the
    asset axis split over ``mesh[axis_name]`` (A divisible by its size:
    pad with dead lanes, ``valid=False`` everywhere, which never trade
    or mark).  ``kwargs`` are the engine's (latency, limit orders with a
    replicated ``fill_key``)."""
    return _sharded(event_backtest, price, valid, score, adv, vol, mesh,
                    axis_name, kwargs)


def sharded_hysteresis_backtest(price, valid, score, adv, vol, mesh,
                                axis_name: str = "assets",
                                **kwargs) -> EventResult:
    """:func:`~csmom_tpu_torch.backtest.event.hysteresis_event_backtest`
    with the asset axis split over ``mesh[axis_name]``."""
    return _sharded(hysteresis_event_backtest, price, valid, score, adv, vol,
                    mesh, axis_name, kwargs)
