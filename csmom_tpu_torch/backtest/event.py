"""Event-driven intraday backtest as a vectorized panel program.

Counterpart of :mod:`csmom_tpu.backtest.event`.  With one fixed order size
per asset, every quantity is a prefix sum over the ``[A, T]`` minute grid:

- order side     = thresholded score (strict inequalities)
- fill price     = ``price * (1 + side*(spread/2 + impact_a))``, the
                   square-root impact constant per asset
- position book  = ``cumsum`` of signed trades along time
- cash ledger    = ``cash0 - cumsum`` of signed fill notional
- mark-to-market = forward-filled last observed price (a running max of
                   observed row indices, ``cummax``)
- PnL            = first difference of portfolio value over bar timestamps

Scans map onto torch's: the forward fills are ``cummax``, the latency
rule's reverse running minimum is a flip, ``cummin`` and a flip back, and
``take_along_axis`` is ``gather``.  Delayed fills settle with a
deterministic segmented sum (:func:`_scatter_settle`), never float
atomics, so a latency run repeats bit for bit on the card.  Integer
outputs keep the reference's types: positions int32, trade sides int8,
counts int32.

Donation: :func:`event_backtest_donated` and
``hysteresis_event_backtest(donate_panels=True)`` consume ``price``,
``valid`` and ``score`` (:mod:`csmom_tpu_torch.utils.donation`).  Both
engines take the three panels in a list that the body empties at its
start, so the body holds the only references a donated call leaves:
``score`` goes once the trade sides (or the hysteresis targets) are
decided, ``valid`` once the bar mask and the forward-fill indices are
taken, and ``price`` after the mark's gather.  A plain call runs the
same body, its panels kept alive by the caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch import random
from csmom_tpu_torch.costs.impact import square_root_impact
from csmom_tpu_torch.utils.donation import consume

DEFAULT_ADV = 100_000.0  # fallback ADV shares
DEFAULT_VOL = 0.02       # fallback daily vol


@dataclasses.dataclass(frozen=True)
class EventResult:
    pnl: torch.Tensor          # f[T] per-bar portfolio value change (0 where no bar)
    bar_mask: torch.Tensor     # bool[T] minutes with >=1 event row
    portfolio_value: torch.Tensor  # f[T]
    cash: torch.Tensor         # f[T] cash path
    positions: torch.Tensor    # i32[A, T] share positions
    trade_side: torch.Tensor   # i8[A, T] signed trade UNITS: +1/-1/0 in the
                               # threshold engine, ±2 for a hysteresis flip
    exec_price: torch.Tensor   # f[A, T] fill price where traded
    impact: torch.Tensor       # f[A] per-asset impact fraction
    total_pnl: torch.Tensor    # f[] sum of pnl
    n_trades: torch.Tensor     # i32
    n_buys: torch.Tensor       # i32
    n_sells: torch.Tensor      # i32
    net_notional: torch.Tensor # f[] sum of signed fill notional


def _like(x, ref, dtype=None):
    """``x`` (array or tensor) as a tensor on ``ref``'s device."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=ref.device, dtype=dtype)


def counter_uniform(key, shape, a_offset, t_offset, dtype):
    """Uniform draws that are a pure function of (key, global panel cell):
    ``u[i, j] = uniform(fold_in(fold_in(key, a_offset + i), t_offset + j))``,
    so a draw never depends on how the panel is partitioned or padded.
    Both grids of keys are folded in one call each."""
    A_l, T_l = shape
    key = torch.as_tensor(key)
    gi = a_offset + torch.arange(A_l, dtype=torch.int64, device=key.device)
    gj = t_offset + torch.arange(T_l, dtype=torch.int64, device=key.device)
    row_keys = random.fold_in(key, gi)                         # [A, 2]
    cell_keys = random.fold_in(row_keys[:, None, :], gj[None, :])  # [A, T, 2]
    return random.uniform_per_key(cell_keys, dtype)


def limit_fill_probability(adv, size_shares, aggressiveness, dtype):
    """Limit-fill probability ``(0.2 + 0.7*agg) * (1 - 0.5*min(1,
    size/ADV))`` per asset (the reference's ``simulate_limit_fill``)."""
    adv = adv.to(dtype)
    size = torch.full_like(adv, float(size_shares))
    return (0.2 + 0.7 * aggressiveness) * (
        1.0 - 0.5 * torch.clamp(size / torch.clamp(adv, min=1.0), max=1.0))


def limit_fill_price(exec_base, aggressiveness, spread):
    """Limit fill price ``price * (1 - 0.5*agg*spread)`` (side-independent
    improvement)."""
    return exec_base * (1.0 - 0.5 * aggressiveness * spread)


def threshold_sides(valid, score, threshold):
    """Order sides from thresholded scores: +1/-1 when |score| > threshold
    strictly, at valid event rows only; int32."""
    one = torch.ones((), dtype=torch.int32, device=score.device)
    return torch.where(valid & (score > threshold), one,
                       torch.where(valid & (score < -threshold), -one, 0 * one))


def market_fill_prices(exec_base, side, traded, impact, spread):
    """Market-order fill prices: ``price * (1 + side*(spread/2 + impact))``
    where traded, 0 elsewhere."""
    return torch.where(
        traded, exec_base * (1.0 + side * (spread / 2.0 + impact[:, None])), 0.0)


def _settlement_fill_idx(valid, latency_bars: int):
    """The latency fill rule: first valid row at or after decision +
    latency, per asset (a reverse running min over the event mask).
    Shared by :func:`event_backtest` and :func:`cost_attribution`.
    Returns int64 ``[A, T]``; T marks "no such row"."""
    T = valid.shape[1]
    t_idx = torch.arange(T, dtype=torch.int64, device=valid.device)
    nxt = torch.where(valid, t_idx[None, :], T)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, (1,)), dim=1).values, (1,))
    target = torch.clamp(t_idx + latency_bars, 0, T - 1)
    return nxt[:, target]


def _apply_latency(price, valid, units, latency_bars: int):
    """Delayed-fill plumbing for both engines: ``(kept_units, fill_idx,
    exec_base)``.  Decisions with no settlement row (first valid row >=
    decision + latency) are dropped; ``exec_base`` is the settlement-bar
    price gathered onto the decision cells.  Latency 0 is the identity."""
    A, T = price.shape
    t_idx = torch.arange(T, dtype=torch.int64, device=price.device)
    if latency_bars <= 0:
        return units, t_idx[None, :].expand(A, T), torch.nan_to_num(price)
    fill_idx = _settlement_fill_idx(valid, latency_bars)
    fillable = ((units != 0)
                & (t_idx[None, :] + latency_bars <= T - 1)
                & (fill_idx < T))
    units = torch.where(fillable, units, 0)
    fill_idx = torch.clamp(fill_idx, 0, T - 1)
    exec_base = torch.gather(torch.nan_to_num(price), 1, fill_idx)
    return units, fill_idx, exec_base


def _segment_add(values, fill_idx, live, latency_bars: int, n_out=None):
    """``out[a, s] = sum of values[a, t] over t with fill_idx[a, t] == s``
    for ``s < n_out`` (default T), adding in t order from 0, as a
    sequential scatter-add does, with no atomics.  ``fill_idx`` does not
    decrease along t, so each settlement row's contributions are one run
    of cells; at most ``latency_bars`` of them are ``live`` (the nonzero
    decisions lie within L rows of the run's first), so the sum is L
    rounds of gather-add-write over the runs' k-th live cells."""
    A, T = values.shape
    n_out = T if n_out is None else n_out
    live_i = live.to(torch.int64)
    before = torch.cumsum(live_i, 1) - live_i               # live cells before t
    first = torch.searchsorted(fill_idx.contiguous(), fill_idx.contiguous())
    rank = before - torch.gather(before, 1, first)          # k of cell t in its run
    out = torch.zeros((A, n_out + 1), dtype=values.dtype, device=values.device)
    for k in range(latency_bars):
        take = live & (rank == k)
        idx = torch.where(take, fill_idx, n_out)            # others: spill column
        out.scatter_(1, idx, torch.gather(out, 1, idx) + torch.where(take, values, 0))
    return out[:, :n_out]


def _scatter_settle(shares, fill, fill_idx, latency_bars: int, dtype):
    """Decided shares/notional onto their settlement rows (the identity at
    latency 0).  Shared by both engines."""
    notional = fill * shares.to(dtype)
    if latency_bars <= 0:
        return shares, notional
    live = shares != 0
    return (_segment_add(shares, fill_idx, live, latency_bars),
            _segment_add(notional, fill_idx, live, latency_bars))


def event_backtest(
    price,
    valid,
    score,
    adv,
    vol,
    size_shares: int = 50,
    threshold: float = 1e-5,
    cash0: float = 1_000_000.0,
    spread: float = 0.001,
    latency_bars: int = 0,
    order_type: str = "market",
    aggressiveness: float = 0.5,
    fill_key=None,
    axis_name=None,
) -> EventResult:
    """Run the event backtest over a dense minute panel.

    Args:
      price: f[A, T] minute prices at event rows (NaN elsewhere).
      valid: bool[A, T] event rows (only these can trade or refresh the mark).
      score: f[A, T] model scores at event rows.
      adv: f[A] average daily volume (fallbacks pre-applied).
      vol: f[A] daily return volatility (fallbacks pre-applied).
      size_shares: fixed order size.
      threshold: trade when |score| > threshold, strictly.
      latency_bars: order-to-fill delay in bars.  With L > 0 an order
        decided at row t executes at the asset's first event row >= t+L,
        at that row's price; orders with no such row are dropped.  The
        trade log keeps decision timestamps; positions and cash move at
        fill time.
      order_type: 'market' or 'limit' (fill probability ``(0.2 +
        0.7*agg) * (1 - 0.5*min(1, size/ADV))`` per order from
        :func:`counter_uniform` on ``fill_key``, price ``price * (1 -
        0.5*agg*spread)``, unfilled orders dropped).
      aggressiveness: limit-order aggressiveness in [0, 1].
      fill_key: a :mod:`csmom_tpu_torch.random` key, required for limits.
      axis_name: inside :func:`~csmom_tpu_torch.parallel.compat.shard_map`
        with the asset axis split, the mesh axis over which the
        cross-asset sums (order flow, marks, bar counts, trade counts)
        are psummed, and whose shard index offsets the limit draws'
        asset counter; None (one device) leaves the engine as it is.  A
        sharded call takes no donation (:func:`event_backtest_donated`
        has no ``axis_name``).
    """
    return _event_body([price, valid, score], adv, vol, size_shares, threshold,
                       cash0, spread, latency_bars, order_type, aggressiveness,
                       fill_key, axis_name)


def event_backtest_donated(
    price,
    valid,
    score,
    adv,
    vol,
    size_shares: int = 50,
    threshold: float = 1e-5,
    cash0: float = 1_000_000.0,
    spread: float = 0.001,
    latency_bars: int = 0,
    order_type: str = "market",
    aggressiveness: float = 0.5,
    fill_key=None,
) -> EventResult:
    """:func:`event_backtest` with ``price``, ``valid`` and ``score``
    donated (the reference's ``donate_argnums=(0, 1, 2)``): the caller's
    three tensors are consumed and left empty, and the body releases each
    after its last use (see the module docstring).  The outputs are those
    of :func:`event_backtest` on the same inputs."""
    return _event_body(list(consume(price, valid, score)), adv, vol,
                       size_shares, threshold, cash0, spread, latency_bars,
                       order_type, aggressiveness, fill_key, None)


def _event_body(panels, adv, vol, size_shares, threshold, cash0, spread,
                latency_bars, order_type, aggressiveness, fill_key, axis_name):
    """The threshold engine on ``panels = [price, valid, score]``, a list
    this body empties so that it holds the panels' last references."""
    price, valid, score = panels
    panels.clear()
    A, T = price.shape
    dtype = price.dtype
    score = _like(score, price, dtype)
    adv, vol = _like(adv, price), _like(vol, price)
    allsum, a_offset = _asset_axis(axis_name, A)

    side = threshold_sides(valid, score, threshold)
    del score

    if order_type == "limit":
        if fill_key is None:
            raise ValueError("order_type='limit' requires fill_key")
        p_fill = limit_fill_probability(adv, size_shares, aggressiveness, dtype)
        # keyed by the global (asset, bar) cell: a sharded call draws the
        # single-device fills
        u = counter_uniform(_like(fill_key, price), (A, T), a_offset, 0, dtype)
        side = torch.where(u < p_fill[:, None], side, 0)
    elif order_type != "market":
        raise ValueError(f"unknown order_type {order_type!r}")

    impact = square_root_impact(
        torch.tensor(float(size_shares), dtype=dtype, device=price.device),
        adv.to(dtype), vol.to(dtype))

    side, fill_idx, exec_base = _apply_latency(price, valid, side, latency_bars)
    traded = side != 0

    if order_type == "limit":
        fill = torch.where(traded, limit_fill_price(exec_base, aggressiveness, spread), 0.0)
    else:
        fill = market_fill_prices(exec_base, side, traded, impact, spread)

    shares = side * size_shares                       # i32[A, T] at decision rows
    shares_settle, notional_settle = _scatter_settle(
        shares, fill, fill_idx, latency_bars, dtype)
    held = [price, valid]
    del price, valid
    return _settle_mark_and_wrap(held, shares_settle, notional_settle,
                                 side, fill, traded, impact, cash0, allsum)


def _identity(x):
    return x


def _asset_axis(axis_name, A: int):
    """``(allsum, asset offset)`` of a shard of an asset-sharded call:
    the psum over ``axis_name`` and this shard's first global asset;
    the identity and 0 on one device."""
    if axis_name is None:
        return _identity, 0
    from csmom_tpu_torch.parallel.compat import axis_index, psum

    return (lambda x: psum(x, axis_name)), axis_index(axis_name) * A


def _settle_mark_and_wrap(panels, shares_settle, notional_settle,
                          side, fill, traded, impact, cash0, allsum=_identity):
    """Shared tail of both engines: settled shares/notional -> positions,
    cash, forward-filled marks, portfolio value, per-bar PnL, counts.
    ``panels = [price, valid]``, a list this tail empties (see
    :func:`_event_body`); ``allsum`` sums a cross-asset partial over the
    asset shards."""
    price, valid = panels
    panels.clear()
    A, T = price.shape
    dtype = price.dtype
    t_idx = torch.arange(T, dtype=torch.int64, device=price.device)

    positions = torch.cumsum(shares_settle, dim=1, dtype=torch.int32)
    flow = allsum(torch.sum(notional_settle, dim=0))  # signed notional per bar
    cash = cash0 - torch.cumsum(flow, dim=0)

    # forward-filled mark price: last observed row price at or before t
    last_obs = torch.cummax(torch.where(valid, t_idx[None, :], -1), dim=1).values
    # bars with an event row, for the per-bar PnL below
    bar_mask = allsum(torch.sum(valid, dim=0)) > 0
    del valid
    mark = torch.gather(torch.nan_to_num(price), 1, torch.clamp(last_obs, 0, T - 1))
    del price
    mark = torch.where(last_obs >= 0, mark, 0.0)     # pre-history marks at 0

    pv = cash + allsum(torch.sum(positions.to(dtype) * mark, dim=0))

    # per-bar PnL over bar timestamps only; the first bar's is 0
    last_bar = torch.cummax(torch.where(bar_mask, t_idx, -1), dim=0).values
    prev_bar = torch.roll(last_bar, 1)
    prev_bar[0] = -1
    prev_bar = torch.where(bar_mask, prev_bar, -1)
    pv_prev = torch.where(prev_bar >= 0, pv[torch.clamp(prev_bar, 0, T - 1)], pv)
    pnl = torch.where(bar_mask & (prev_bar >= 0), pv - pv_prev, 0.0)

    i32 = torch.int32
    return EventResult(
        pnl=pnl,
        bar_mask=bar_mask,
        portfolio_value=pv,
        cash=cash,
        positions=positions,
        trade_side=side.to(torch.int8),
        exec_price=fill,
        impact=impact,
        total_pnl=torch.sum(pnl),
        n_trades=allsum(torch.sum(traded, dtype=i32)),
        n_buys=allsum(torch.sum(side > 0, dtype=i32)),
        n_sells=allsum(torch.sum(side < 0, dtype=i32)),
        net_notional=torch.sum(flow),
    )


def hysteresis_event_backtest(
    price,
    valid,
    score,
    adv,
    vol,
    threshold_hi: float = 1e-4,
    threshold_lo: float = 1e-5,
    size_shares: int = 50,
    cash0: float = 1_000_000.0,
    spread: float = 0.001,
    latency_bars: int = 0,
    axis_name=None,
    donate_panels: bool = False,
) -> EventResult:
    """Event backtest with a Schmitt-trigger position state per asset:
    enter long (+1 unit) when ``score > threshold_hi``, short (-1) when
    ``score < -threshold_hi``, go flat when ``|score| < threshold_lo``,
    and otherwise hold.  Trades happen only on state changes (a flip
    trades 2x ``size_shares`` as one ±2-unit fill), so positions stay
    within one unit per asset.  The state at t is decided by the most
    recent of {enter-long, enter-short, exit} at or before t: three
    ``cummax`` scans and a comparison.  ``threshold_lo <= threshold_hi``
    is checked on the host.  With ``latency_bars > 0`` each trade settles
    at the next valid row >= decision + latency (the threshold engine's
    rule); unfillable tail decisions are dropped.  ``axis_name``: as in
    :func:`event_backtest`.  ``donate_panels`` consumes ``price``,
    ``valid`` and ``score`` as :func:`event_backtest_donated` does; a
    sharded call (``axis_name``) takes no donation.
    """
    if float(threshold_lo) > float(threshold_hi):
        raise ValueError(
            f"threshold_lo={threshold_lo} > threshold_hi={threshold_hi}: "
            "the exit threshold must not exceed the entry threshold"
        )
    if donate_panels and axis_name is not None:
        raise ValueError("a sharded call (axis_name) takes no donation")
    if donate_panels:
        price, valid, score = consume(price, valid, score)
    panels = [price, valid, score]
    del price, valid, score
    return _hysteresis_body(panels, adv, vol, threshold_hi, threshold_lo,
                            size_shares, cash0, spread, latency_bars, axis_name)


def _hysteresis_body(panels, adv, vol, threshold_hi, threshold_lo, size_shares,
                     cash0, spread, latency_bars, axis_name):
    """The hysteresis engine on ``panels = [price, valid, score]``, a list
    this body empties (see :func:`_event_body`)."""
    price, valid, score = panels
    panels.clear()
    A, T = price.shape
    dtype = price.dtype
    score = _like(score, price, dtype)
    adv, vol = _like(adv, price), _like(vol, price)
    t_idx = torch.arange(T, dtype=torch.int64, device=price.device)

    def last_idx(ev):
        return torch.cummax(torch.where(ev, t_idx[None, :], -1), dim=1).values

    e_long = valid & (score > threshold_hi)
    e_short = valid & (score < -threshold_hi)
    e_exit = valid & (torch.abs(score) < threshold_lo)
    del score  # the panels' first to go: the scans below are the widest step
    iL, iS, iX = last_idx(e_long), last_idx(e_short), last_idx(e_exit)
    one = torch.ones((), dtype=torch.int32, device=price.device)
    target = torch.where((iL > iS) & (iL > iX), one,
                         torch.where((iS > iL) & (iS > iX), -one, 0 * one))
    prev_target = torch.nn.functional.pad(target, (1, 0))[:, :T]
    delta = target - prev_target                    # i32[A, T], in {-2..2}

    delta, fill_idx, exec_base = _apply_latency(price, valid, delta, latency_bars)

    sgn = torch.sign(delta)                         # fill-price direction
    traded = sgn != 0
    impact = square_root_impact(
        torch.tensor(float(size_shares), dtype=dtype, device=price.device),
        adv.to(dtype), vol.to(dtype))
    fill = market_fill_prices(exec_base, sgn, traded, impact, spread)
    shares = delta * size_shares
    shares_settle, notional_settle = _scatter_settle(
        shares, fill, fill_idx, latency_bars, dtype)
    held = [price, valid]
    del price, valid
    # the stored side is the signed unit count (flips are ±2), so cost
    # attribution and the trade log see the true size; the fill price
    # uses only the direction
    return _settle_mark_and_wrap(held, shares_settle, notional_settle,
                                 delta, fill, traded, impact, cash0,
                                 _asset_axis(axis_name, A)[0])


def trades_dataframe(result: EventResult, tickers, times, score, size_shares: int = 50):
    """The reference's trade log (``results/trades.csv`` schema:
    datetime,ticker,size,price,impact,score — sorted by datetime then
    ticker).  Host-side.  Latency runs: rows are decision bars, ``price``
    the delayed fill."""
    import pandas as pd

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    side = host(result.trade_side)
    fill = host(result.exec_price)
    imp = host(result.impact)
    score = host(score)
    a_idx, t_idx = np.nonzero(side)
    order = np.lexsort((np.asarray(tickers, dtype=object)[a_idx], t_idx))
    a_idx, t_idx = a_idx[order], t_idx[order]
    return pd.DataFrame(
        {
            "datetime": np.asarray(times)[t_idx],
            "ticker": np.asarray(tickers, dtype=object)[a_idx],
            "size": side[a_idx, t_idx].astype(int) * size_shares,
            "price": fill[a_idx, t_idx],
            "impact": imp[a_idx],
            "score": score[a_idx, t_idx],
        }
    )


@dataclasses.dataclass(frozen=True)
class CostAttribution:
    """Execution-cost decomposition of an event backtest (all scalars):
    ``total = delay + spread + impact + residual``, with ``residual`` ~0
    for market orders and ``delay_cost`` 0 at latency 0."""

    gross_pnl: torch.Tensor      # f[] PnL had every fill been at decision mid
    net_pnl: torch.Tensor        # f[] realized PnL (== EventResult.total_pnl)
    total_cost: torch.Tensor     # f[] gross - net (implementation shortfall)
    delay_cost: torch.Tensor     # f[] decision->settlement mid drift leg
    spread_cost: torch.Tensor    # f[] half-spread leg of the fill formula
    impact_cost: torch.Tensor    # f[] sqrt-impact leg
    residual: torch.Tensor       # f[] total - delay - spread - impact
    gross_notional: torch.Tensor # f[] sum of |size| * decision mid over fills
    cost_bps: torch.Tensor       # f[] total_cost / gross_notional * 1e4


def cost_attribution(result: EventResult, price, size_shares: int = 50,
                     spread: float = 0.001,
                     latency_bars: int = 0, valid=None) -> CostAttribution:
    """Decompose an :class:`EventResult` into gross PnL and cost legs.

    ``price`` is the mid panel the backtest ran on; ``size_shares``,
    ``spread`` and ``latency_bars`` echo its arguments.  With a delay the
    shortfall against the decision-bar mid splits into the drift leg
    (decision mid -> settlement mid) and execution legs against the
    settlement-bar mid; ``valid`` (the backtest's event mask) is then
    required to recompute the settlement bars.
    """
    side = result.trade_side.to(price.dtype)   # signed units (flips ±2)
    units = torch.abs(side)
    traded = result.trade_side != 0
    mid = torch.where(traded, torch.nan_to_num(price), 0.0)
    fill = torch.where(traded, torch.nan_to_num(result.exec_price), 0.0)
    sz = torch.tensor(size_shares, dtype=price.dtype, device=price.device)

    if latency_bars > 0:
        if valid is None:
            raise ValueError(
                "cost_attribution with latency_bars > 0 needs the "
                "backtest's `valid` mask to recompute settlement bars"
            )
        T = price.shape[1]
        fill_idx = torch.clamp(_settlement_fill_idx(valid, latency_bars), 0, T - 1)
        settle_mid = torch.gather(torch.nan_to_num(price), 1, fill_idx)
        settle_mid = torch.where(traded, settle_mid, 0.0)
    else:
        settle_mid = mid

    total_cost = torch.sum((fill - mid) * side) * sz
    delay_cost = torch.sum((settle_mid - mid) * side) * sz
    spread_cost = torch.sum(settle_mid * units) * (spread / 2.0) * sz
    impact_cost = torch.sum(settle_mid * result.impact[:, None] * units) * sz

    gross_notional = torch.sum(mid * units) * sz
    net = result.total_pnl
    return CostAttribution(
        gross_pnl=net + total_cost,
        net_pnl=net,
        total_cost=total_cost,
        delay_cost=delay_cost,
        spread_cost=spread_cost,
        impact_cost=impact_cost,
        residual=total_cost - delay_cost - spread_cost - impact_cost,
        gross_notional=gross_notional,
        cost_bps=torch.where(gross_notional > 0,
                             total_cost / gross_notional * 1e4, torch.nan),
    )


def threshold_sweep(price, valid, score, adv, vol, thresholds, **kwargs):
    """Event backtest at every score threshold.

    The reference vmaps the engine over the thresholds; here the engine
    runs once per threshold, so each point is exactly the single-threshold
    backtest and the peak memory stays one engine's.

    Args:
      thresholds: f[N] thresholds.
      **kwargs: forwarded to :func:`event_backtest` (anything but
        ``threshold``).

    Returns ``(total_pnl f[N], n_trades i32[N], cost_bps f[N])``, the
    cost per threshold from :func:`cost_attribution` (NaN where nothing
    traded).
    """
    size_shares = kwargs.get("size_shares", 50)
    spread = kwargs.get("spread", 0.001)
    latency_bars = kwargs.get("latency_bars", 0)
    kwargs = {k: v for k, v in kwargs.items() if k != "threshold"}
    ths = _like(thresholds, price, price.dtype).reshape(-1)
    pnl, trades, bps = [], [], []
    for i in range(ths.shape[0]):
        r = event_backtest(price, valid, score, adv, vol, threshold=ths[i], **kwargs)
        tca = cost_attribution(r, price, size_shares=size_shares, spread=spread,
                               latency_bars=latency_bars, valid=valid)
        pnl.append(r.total_pnl)
        trades.append(r.n_trades)
        bps.append(tca.cost_bps)
    return torch.stack(pnl), torch.stack(trades), torch.stack(bps)
