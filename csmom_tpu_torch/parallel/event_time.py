"""Sequence-parallel event backtests: the minute axis split over a mesh axis.

Counterpart of :mod:`csmom_tpu.parallel.event_time`.  The event engine's
only time-serial steps are prefix operations: the position book and the
cash ledger are cumulative sums, the mark is the last observed price (a
running max of row indices), and PnL differences portfolio value at
consecutive bars.  Each becomes a blocked scan: a shard takes the
prefix over its time block, exchanges one small carry per block (an
all_gather over the ``time`` axis) and adds the exclusive prefix of the
earlier blocks' carries.  With an ``assets`` axis beside it the
cross-asset sums also psum over assets, as in
:mod:`csmom_tpu_torch.parallel.event`.

Carries of an ``[A, T]`` panel on an ``(assets=a, time=t)`` mesh:

- positions: ``i32[A/a]`` block trade sums, gathered ``[t, A/a]``;
- cash: one block flow sum;
- marks: ``(bool[A/a], f[A/a])``, the last price observed in a block;
- portfolio value: ``(bool, f)``, the block's last bar's value;
- trade counters: psums.

Nothing grows with T.  Integer state (positions, sides, counts) equals
the single-device engines'; blocked sums reassociate floats, so they
agree to tight tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.backtest.event import (
    EventResult,
    _like,
    _segment_add,
    counter_uniform,
    limit_fill_price,
    limit_fill_probability,
    market_fill_prices,
    threshold_sides,
)
from csmom_tpu_torch.costs.impact import square_root_impact
from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.parallel.compat import (
    all_gather,
    axis_index,
    ppermute,
    psum,
    shard_map,
)

__all__ = ["pad_time", "time_sharded_event_backtest",
           "time_sharded_hysteresis_backtest"]

# "no such row" of the global first-event indices (int64)
_BIG = 2 ** 62


def pad_time(price, valid, score, n_shards: int):
    """Pad the time axis of host arrays to a multiple of the shard count
    with NaN minutes that are not events (no bar, no trade, no mark):
    ``(price, valid, score, T_original)``; results over the original
    columns are unchanged."""
    T = price.shape[1]
    pad = (-T) % n_shards
    if pad == 0:
        return price, valid, score, T
    ppad = np.full(price.shape[:1] + (pad,), np.nan, dtype=price.dtype)
    spad = np.zeros(score.shape[:1] + (pad,), dtype=score.dtype)
    mpad = np.zeros(valid.shape[:1] + (pad,), dtype=bool)
    return (np.concatenate([price, ppad], axis=1),
            np.concatenate([valid, mpad], axis=1),
            np.concatenate([score, spad], axis=1), T)


def _exclusive_prefix_sum(block_total, axis_name: str):
    """The sum of ``block_total`` over every earlier block along
    ``axis_name`` (zeros for the first)."""
    g = all_gather(block_total, axis_name)               # [nb, ...]
    i = axis_index(axis_name)
    if i == 0:
        return torch.zeros_like(block_total)
    return g[:i].sum(dim=0, dtype=g.dtype)


def _carry_from_left(has_blk, val_blk, axis_name: str):
    """The value of the rightmost earlier block that has one, per
    element: ``(exists, value)``, the exclusive prefix of a "take the
    right operand if set" monoid."""
    has_g = all_gather(has_blk, axis_name)               # [nb, X]
    val_g = all_gather(val_blk, axis_name)
    i = axis_index(axis_name)
    nb = has_g.shape[0]
    idx = torch.arange(nb, device=has_g.device)
    cand = torch.where(has_g & (idx[:, None] < i), idx[:, None], -1)
    jbest = cand.max(dim=0).values                       # [X]
    val = torch.gather(val_g, 0, jbest.clamp(0, nb - 1)[None, :])[0]
    return jbest >= 0, val


def _latency_settle(price, valid, side, impact, spread, size_shares: int,
                    latency_bars: int, time_axis: str, nt: int, limit=None):
    """Latency fills under time sharding, by a halo exchange.

    Single-device rule: an order decided at row t fills at the asset's
    first event row >= t + L at that row's price, else it is dropped.
    Sharded, the fill row lies

    1. in this block: a local segmented sum;
    2. in the next block: the neighbour's next-event indices and prices
       come left by one ppermute, and the settled (shares, notional)
       buffer goes right by another;
    3. two or more blocks ahead: every such order of one (block, asset)
       fills at one row (the asset's first event in the blocks from
       this one + 2) at one price, so they travel as per-asset totals in
       one all_gather of ``[n_blocks, A_l]`` and each block adds those
       whose row is its own.

    Needs ``L <= `` the block length.  Cases 1 and 2 settle with
    :func:`~csmom_tpu_torch.backtest.event._segment_add` (no atomics),
    over one index that runs through this block's rows and then the
    next block's.  ``limit`` is the limit price's aggressiveness (its
    side-independent price), None for market orders.  Returns ``(side,
    fill, settle_shares, settle_notional)``: dropped orders zeroed, the
    fill price on the decision cells, the settlements on fill rows.
    """
    A_l, T_l = price.shape
    dev = price.device
    L = latency_bars
    blk = axis_index(time_axis)
    t_loc = torch.arange(T_l, dtype=torch.int64, device=dev)
    pz = torch.nan_to_num(price)

    # each slot's first event at or after it in this block (T_l: none)
    nxt = torch.where(valid, t_loc[None, :], T_l)
    nxt_loc = torch.flip(torch.cummin(torch.flip(nxt, (1,)), dim=1).values, (1,))

    # each block's first event and its price -> the far carry [nt, A_l]
    first_idx = nxt_loc[:, 0]
    has_first = first_idx < T_l
    first_price = torch.gather(pz, 1, first_idx.clamp(0, T_l - 1)[:, None])[:, 0]
    g_idx = all_gather(torch.where(has_first, blk * T_l + first_idx, _BIG), time_axis)
    g_price = all_gather(torch.where(has_first, first_price, 0.0), time_axis)
    later = (torch.arange(nt, device=dev) >= blk + 2)[:, None]
    fut_idx, fut_arg = torch.where(later, g_idx, _BIG).min(dim=0)    # [A_l]
    fut_price = torch.gather(g_price, 0, fut_arg[None, :])[0]

    # the right halo: block blk+1's next-event indices and prices
    perm_left = [(i, i - 1) for i in range(1, nt)]
    nxt_r = ppermute(nxt_loc, time_axis, perm_left)
    price_r = ppermute(pz, time_axis, perm_left)
    halo_ok = blk < nt - 1

    # each decision's fill row and price
    tgt_loc = t_loc + L
    nxt1 = nxt_loc[:, tgt_loc.clamp(0, T_l - 1)]                    # [A_l, T_l]
    case1 = (tgt_loc <= T_l - 1)[None, :] & (nxt1 < T_l)
    nxt2 = nxt_r[:, (tgt_loc - T_l).clamp(0, T_l - 1)]
    case2 = ~case1 & halo_ok & (nxt2 < T_l)
    case3 = ~case1 & ~case2 & (fut_idx < _BIG)[:, None]
    side = torch.where(case1 | case2 | case3, side, 0)              # drop unfilled
    traded = side != 0
    price1 = torch.gather(pz, 1, nxt1.clamp(0, T_l - 1))
    price2 = torch.gather(price_r, 1, nxt2.clamp(0, T_l - 1))
    exec_base = torch.where(case1, price1,
                            torch.where(case2, price2, fut_price[:, None]))
    if limit is None:
        fill = market_fill_prices(exec_base, side, traded, impact, spread)
    else:
        fill = torch.where(traded, limit_fill_price(exec_base, limit, spread), 0.0)
    shares = side * size_shares
    notional = fill * shares.to(price.dtype)

    # cases 1 and 2: rows of this block, then of the next one (a
    # non-decreasing index along t), summed without atomics
    row = torch.where(case1, nxt1, torch.where(case2, T_l + nxt2, 2 * T_l))
    near = traded & (case1 | case2)
    sh12 = _segment_add(shares, row, near, L, n_out=2 * T_l)
    no12 = _segment_add(notional, row, near, L, n_out=2 * T_l)
    perm_right = [(i, i + 1) for i in range(nt - 1)]
    settle_sh = sh12[:, :T_l] + ppermute(sh12[:, T_l:], time_axis, perm_right)
    settle_no = no12[:, :T_l] + ppermute(no12[:, T_l:], time_axis, perm_right)

    # case 3: per-asset totals, added at their row in its block
    far = case3 & traded
    gf_sh = all_gather(torch.where(far, shares, 0).sum(dim=1, dtype=shares.dtype),
                       time_axis)                                   # [nt, A_l]
    gf_no = all_gather(torch.where(far, notional, 0.0).sum(dim=1), time_axis)
    gf_row = all_gather(fut_idx, time_axis)
    mine = (gf_row >= blk * T_l) & (gf_row < (blk + 1) * T_l)
    row_loc = torch.where(mine, gf_row - blk * T_l, T_l)            # T_l: spill
    for j in range(nt):  # one source block at a time
        at = row_loc[j][:, None]
        settle_sh = settle_sh + torch.zeros(
            (A_l, T_l + 1), dtype=settle_sh.dtype, device=dev).scatter_(
            1, at, torch.where(mine[j], gf_sh[j], 0)[:, None])[:, :T_l]
        settle_no = settle_no + torch.zeros(
            (A_l, T_l + 1), dtype=settle_no.dtype, device=dev).scatter_(
            1, at, torch.where(mine[j], gf_no[j], 0.0)[:, None])[:, :T_l]
    return side, fill, settle_sh, settle_no


def _validate_time_layout(mesh, A: int, T: int, time_axis: str, asset_axis) -> int:
    """The time-sharded engines' layout checks; returns the time-shard
    count."""
    if time_axis not in mesh.shape:
        raise ValueError(
            f"mesh has axes {tuple(mesh.shape)}, no {time_axis!r}; build it "
            "with make_mesh(devices, grid_axis=a, axis_names=('assets', 'time'))")
    nt = mesh.shape[time_axis]
    if T % nt:
        raise ValueError(f"T={T} not divisible by {nt} time shards; pad_time first")
    if asset_axis is not None:
        na = mesh.shape[asset_axis]
        if A % na:
            raise ValueError(f"A={A} not divisible by {na} asset shards; "
                             "pad_assets first")
    return nt


def _blocked_settle_tail(price, valid, shares_settle, notional_settle, side,
                         fill, traded, impact, cash0, asum, time_axis: str):
    """The blocked form of the engines' accounting tail
    (``backtest.event._settle_mark_and_wrap``): each global prefix is a
    block prefix plus one small carry, the cumsums by
    :func:`_exclusive_prefix_sum`, the mark and the previous bar's value
    by :func:`_carry_from_left`.  Shared by both time-sharded engines."""
    A_l, T_l = price.shape
    dtype = price.dtype
    dev = price.device
    t_loc = torch.arange(T_l, dtype=torch.int64, device=dev)

    pos_local = torch.cumsum(shares_settle, dim=1, dtype=torch.int32)
    positions = pos_local + _exclusive_prefix_sum(pos_local[:, -1], time_axis)[:, None]

    flow = asum(torch.sum(notional_settle, dim=0))               # [T_l]
    cum_flow = torch.cumsum(flow, dim=0)
    cash = cash0 - (cum_flow + _exclusive_prefix_sum(cum_flow[-1], time_axis))

    pz = torch.nan_to_num(price)
    last_obs = torch.cummax(torch.where(valid, t_loc[None, :], -1), dim=1).values
    mark_local = torch.gather(pz, 1, last_obs.clamp(0, T_l - 1))
    blk_has = last_obs[:, -1] >= 0
    blk_price = mark_local[:, -1]
    prev_has, prev_price = _carry_from_left(
        blk_has, torch.where(blk_has, blk_price, 0.0), time_axis)
    mark = torch.where(last_obs >= 0, mark_local,
                       torch.where(prev_has[:, None], prev_price[:, None], 0.0))

    pv = cash + asum(torch.sum(positions.to(dtype) * mark, dim=0))

    bar_mask = asum(torch.sum(valid, dim=0)) > 0
    last_bar = torch.cummax(torch.where(bar_mask, t_loc, -1), dim=0).values
    prev_bar = torch.roll(last_bar, 1)
    prev_bar[0] = -1
    prev_bar = torch.where(bar_mask, prev_bar, -1)
    pv_prev = pv[prev_bar.clamp(0, T_l - 1)]
    blk_has_bar = last_bar[-1:] >= 0
    blk_pv = torch.where(blk_has_bar, pv[last_bar[-1:].clamp(0, T_l - 1)], 0.0)
    carry_has, carry_pv = _carry_from_left(blk_has_bar, blk_pv, time_axis)
    pnl = torch.where(
        bar_mask,
        torch.where(prev_bar >= 0, pv - pv_prev,
                    torch.where(carry_has[0], pv - carry_pv[0], 0.0)),
        0.0)

    def tsum(x):
        return psum(x, time_axis)

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
        total_pnl=tsum(torch.sum(pnl)),
        n_trades=tsum(asum(torch.sum(traded, dtype=i32))),
        n_buys=tsum(asum(torch.sum(side > 0, dtype=i32))),
        n_sells=tsum(asum(torch.sum(side < 0, dtype=i32))),
        net_notional=tsum(torch.sum(flow)),
    )


def _specs(time_axis: str, asset_axis):
    a = asset_axis  # None: the asset axis is whole on every shard
    in5 = (P(a, time_axis), P(a, time_axis), P(a, time_axis), P(a), P(a))
    out = EventResult(
        pnl=P(time_axis), bar_mask=P(time_axis), portfolio_value=P(time_axis),
        cash=P(time_axis), positions=P(a, time_axis), trade_side=P(a, time_axis),
        exec_price=P(a, time_axis), impact=P(a), total_pnl=P(), n_trades=P(),
        n_buys=P(), n_sells=P(), net_notional=P(),
    )
    return in5, out


def _size_tensor(size_shares: int, price, mesh):
    """The order size as a 0-d tensor of the panel's type on this
    process's first shard's device: uploaded once a call, and handed to
    every shard replicated (``P()``), not uploaded by each shard's
    function."""
    return torch.tensor(float(size_shares), dtype=torch.as_tensor(price).dtype,
                        device=mesh.home)


def _asum(asset_axis):
    if asset_axis is None:
        return lambda x: x
    return lambda x: psum(x, asset_axis)


def time_sharded_event_backtest(price, valid, score, adv, vol, mesh,
                                time_axis: str = "time", asset_axis=None,
                                size_shares: int = 50, threshold: float = 1e-5,
                                cash0: float = 1_000_000.0, spread: float = 0.001,
                                latency_bars: int = 0, order_type: str = "market",
                                aggressiveness: float = 0.5,
                                fill_key=None) -> EventResult:
    """:func:`~csmom_tpu_torch.backtest.event.event_backtest` with the
    minute axis split over ``mesh[time_axis]`` (and the assets over
    ``mesh[asset_axis]`` when given).

    T must divide by the time-shard count (:func:`pad_time`) and A by the
    asset-shard count (:func:`~csmom_tpu_torch.parallel.mesh.pad_assets`);
    build a 2-D mesh with ``make_mesh(devices, grid_axis=a,
    axis_names=("assets", "time"))``.  Latency fills need ``latency_bars
    <= T // n_time_shards`` (:func:`_latency_settle`'s halo).  Limit
    fills are keyed by the global (asset, bar) cell, so a replicated
    ``fill_key`` draws the single-device fills on any layout.  The
    result is on the mesh's first device.
    """
    if order_type == "limit":
        if fill_key is None:
            raise ValueError("order_type='limit' requires fill_key")
    elif order_type != "market":
        raise ValueError(f"unknown order_type {order_type!r}")
    A, T = price.shape
    nt = _validate_time_layout(mesh, A, T, time_axis, asset_axis)
    if latency_bars < 0 or latency_bars > T // nt:
        raise ValueError(
            f"latency_bars={latency_bars} exceeds the time-block length "
            f"{T // nt}; a fill target would skip past the halo neighbour: "
            "use fewer time shards or the asset-sharded engine")
    asum = _asum(asset_axis)
    size_t = _size_tensor(size_shares, price, mesh)
    key = None if fill_key is None else _like(fill_key, size_t)

    def local_fn(price, valid, score, adv, vol, fill_key, size_t):
        A_l, T_l = price.shape
        dtype = price.dtype
        side = threshold_sides(valid, score.to(dtype), threshold)
        if order_type == "limit":
            p_fill = limit_fill_probability(adv, size_shares, aggressiveness, dtype)
            a_off = axis_index(asset_axis) * A_l if asset_axis else 0
            t_off = axis_index(time_axis) * T_l
            u = counter_uniform(fill_key, (A_l, T_l), a_off, t_off, dtype)
            side = torch.where(u < p_fill[:, None], side, 0)
        impact = square_root_impact(size_t, adv.to(dtype), vol.to(dtype))
        limit = aggressiveness if order_type == "limit" else None
        if latency_bars > 0:
            side, fill, shares_settle, notional_settle = _latency_settle(
                price, valid, side, impact, spread, size_shares, latency_bars,
                time_axis, nt, limit)
        else:
            traded = side != 0
            exec_base = torch.nan_to_num(price)
            if limit is None:
                fill = market_fill_prices(exec_base, side, traded, impact, spread)
            else:
                fill = torch.where(traded, limit_fill_price(exec_base, limit, spread), 0.0)
            shares_settle = side * size_shares
            notional_settle = fill * shares_settle.to(dtype)
        return _blocked_settle_tail(price, valid, shares_settle, notional_settle,
                                    side, fill, side != 0, impact, cash0, asum,
                                    time_axis)

    in5, out = _specs(time_axis, asset_axis)
    return shard_map(local_fn, mesh=mesh, in_specs=in5 + (P(), P()),
                     out_specs=out)(price, valid, score, adv, vol, key, size_t)


def time_sharded_hysteresis_backtest(price, valid, score, adv, vol, mesh,
                                     time_axis: str = "time", asset_axis=None,
                                     threshold_hi: float = 1e-4,
                                     threshold_lo: float = 1e-5,
                                     size_shares: int = 50,
                                     cash0: float = 1_000_000.0,
                                     spread: float = 0.001) -> EventResult:
    """The Schmitt-trigger engine
    (:func:`~csmom_tpu_torch.backtest.event.hysteresis_event_backtest`,
    latency 0) with the minute axis split.  Its state is three "last
    event index" prefixes, so each is a block cummax over global bar ids
    plus one rightmost-earlier-block carry (:func:`_carry_from_left`),
    and the state entering a block is resolved from the carries alone.
    """
    if float(threshold_lo) > float(threshold_hi):
        raise ValueError(
            f"threshold_lo={threshold_lo} > threshold_hi={threshold_hi}: "
            "the exit threshold must not exceed the entry threshold")
    A, T = price.shape
    _validate_time_layout(mesh, A, T, time_axis, asset_axis)
    asum = _asum(asset_axis)
    size_t = _size_tensor(size_shares, price, mesh)

    def local_fn(price, valid, score, adv, vol, size_t):
        A_l, T_l = price.shape
        dtype = price.dtype
        dev = price.device
        score = score.to(dtype)
        t_glob = axis_index(time_axis) * T_l + torch.arange(T_l, dtype=torch.int64,
                                                            device=dev)

        def last_idx(ev):
            loc = torch.cummax(torch.where(ev, t_glob[None, :], -1), dim=1).values
            has = loc[:, -1] >= 0
            prev_has, prev_val = _carry_from_left(
                has, torch.where(has, loc[:, -1], 0), time_axis)
            prev = torch.where(prev_has, prev_val, -1)
            return torch.maximum(loc, prev[:, None]), prev

        iL, pL = last_idx(valid & (score > threshold_hi))
        iS, pS = last_idx(valid & (score < -threshold_hi))
        iX, pX = last_idx(valid & (torch.abs(score) < threshold_lo))
        one = torch.ones((), dtype=torch.int32, device=dev)

        def resolve(l, s, x):
            return torch.where((l > s) & (l > x), one,
                               torch.where((s > l) & (s > x), -one, 0 * one))

        target = resolve(iL, iS, iX)
        boundary = resolve(pL, pS, pX)          # the state entering the block
        prev_target = torch.cat([boundary[:, None], target[:, :-1]], dim=1)
        delta = target - prev_target
        sgn = torch.sign(delta)
        traded = sgn != 0
        impact = square_root_impact(size_t, adv.to(dtype), vol.to(dtype))
        fill = market_fill_prices(torch.nan_to_num(price), sgn, traded, impact,
                                  spread)
        shares = delta * size_shares
        # the stored side is the signed unit count (flips are ±2)
        return _blocked_settle_tail(price, valid, shares, fill * shares.to(dtype),
                                    delta, fill, traded, impact, cash0, asum,
                                    time_axis)

    in5, out = _specs(time_axis, asset_axis)
    return shard_map(local_fn, mesh=mesh, in_specs=in5 + (P(),), out_specs=out)(
        price, valid, score, adv, vol, size_t)
