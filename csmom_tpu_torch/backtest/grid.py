"""Jegadeesh–Titman J x K strategy grid.

Counterpart of :mod:`csmom_tpu.backtest.grid`.  Every J is a batch index,
never a loop:

- formation signals for all J: one :func:`momentum_dynamic` call on the
  tensor of Js -> ``[nJ, A, M]``;
- decile labels for all J: one batched ranking over ``[nJ, M, A]`` rows;
- cohort forward returns ``R[j, s, h]`` (cohort formed at s under J_j, its
  spread h months later): kernel K2
  (:func:`csmom_tpu_torch.ops.kernels.cohort_partial_sums`), one launch
  for every J;
- the K axis: a cumulative mean over h gathered at each K, so every
  (J, K) cell shares the cohort tensor;
- costs: every cell's exact overlapping-book turnover from one shared
  prefix sum over the ``[nJ, A, M]`` formation weights
  (:func:`grid_net_of_costs`), and any cost level re-priced from one
  unit-cost run (:func:`grid_net_from_unit`, :func:`grid_break_even_bps`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum_dynamic,
    monthly_returns,
)


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Full J x K grid outputs; axes [nJ, nK, ...], time axis = holding month."""

    spreads: torch.Tensor       # f[nJ, nK, M] portfolio spread in month m
    spread_valid: torch.Tensor  # bool[nJ, nK, M] (all K cohorts live)
    mean_spread: torch.Tensor   # f[nJ, nK]
    ann_sharpe: torch.Tensor    # f[nJ, nK]
    tstat: torch.Tensor         # f[nJ, nK] iid t-stat
    tstat_nw: torch.Tensor      # f[nJ, nK] Newey–West t-stat, lag = K
    Js: torch.Tensor | None = None    # i64[nJ] formation lookbacks
    Ks: torch.Tensor | None = None    # i64[nK] holding periods
    skip: torch.Tensor | None = None  # i64[] skip months
    n_bins: int | None = None
    mode: str | None = None


def _cohort_partial_sums(labels, ret, ret_valid, n_bins: int, max_hold: int,
                         impl: str = "kernel"):
    """Sums/counts for each cohort x horizon over the asset axis.

    ``labels`` is ``[..., A, M]``; returns ``(sums f[..., 2, M, H],
    counts f[..., 2, M, H])``, side 0 = bottom decile, side 1 = top.

    - ``"kernel"``: K2 (its plain version for CPU tensors);
    - ``"plain"``: the rolled-panel form (the reference's ``"xla"``);
    - ``"matmul"``: the whole formation x measurement-month cross table as
      one matrix product (membership^T @ returns, membership^T @ validity),
      then the band of columns s+1..s+H; sums agree with the other forms
      to rounding, not bitwise;
    - ``"matmul_bf16"``: the same with bfloat16 operands and float32
      accumulation.  Counts stay exact (0/1 operands, float32 sums up to
      2**24); return sums carry bfloat16's input rounding.  On the card
      the product takes bf16 operands with a float32 output
      (``torch.mm(..., out_dtype=torch.float32)``, which raises where the
      installed torch lacks it); on the CPU, which has no such product,
      the bf16-rounded operands are multiplied in float32.
    """
    if impl in ("matmul", "matmul_bf16"):
        return _cohort_partial_sums_matmul(labels, ret, ret_valid, n_bins,
                                           max_hold, bf16=impl == "matmul_bf16")
    if impl == "plain":
        return kernels.cohort_partial_sums_plain(ret, ret_valid, labels,
                                                 n_bins, max_hold)
    if impl != "kernel":
        raise ValueError(f"unknown impl {impl!r}: use 'kernel', 'plain', "
                         "'matmul' or 'matmul_bf16'")
    A, M = labels.shape[-2:]
    lead = labels.shape[:-2]
    sums, counts = kernels.cohort_partial_sums(
        ret, ret_valid, labels.reshape(-1, A, M), n_bins, max_hold)
    H = sums.shape[-1]
    return sums.reshape(*lead, 2, M, H), counts.reshape(*lead, 2, M, H)


def _cohort_partial_sums_matmul(labels, ret, ret_valid, n_bins: int,
                                max_hold: int, bf16: bool):
    """The cross-table form: one ``[(..., 2, M), A] @ [A, M]`` product for
    every J and side at once, then the diagonal band gather."""
    A, M = ret.shape
    lead = labels.shape[:-2]
    rf = torch.where(ret_valid, torch.nan_to_num(ret), 0.0)
    count_dtype = torch.promote_types(rf.dtype, torch.float32)
    mem = torch.stack([labels == 0, labels == n_bins - 1], dim=-3)   # [..., 2, A, M]
    mem_t = mem.transpose(-1, -2).reshape(-1, A)                     # [(..., 2, M), A]
    if bf16:
        lhs = mem_t.to(torch.bfloat16)
        rb, vb = rf.to(torch.bfloat16), ret_valid.to(torch.bfloat16)
        if lhs.is_cuda:
            full_sums = torch.mm(lhs, rb, out_dtype=torch.float32)
            full_cnts = torch.mm(lhs, vb, out_dtype=torch.float32)
        else:
            full_sums = torch.mm(lhs.to(torch.float32), rb.to(torch.float32))
            full_cnts = torch.mm(lhs.to(torch.float32), vb.to(torch.float32))
        full_sums, full_cnts = full_sums.to(count_dtype), full_cnts.to(count_dtype)
    else:
        full_sums = torch.mm(mem_t.to(rf.dtype), rf)
        full_cnts = torch.mm(mem_t.to(count_dtype), ret_valid.to(count_dtype))
    dev = ret.device
    col = torch.arange(M, device=dev)[:, None] + torch.arange(1, max_hold + 1,
                                                              device=dev)[None, :]
    keep = col < M                                                   # [M, H]
    rows = torch.arange(M, device=dev)[:, None]
    colc = col.clamp(0, M - 1)
    sums = full_sums.reshape(*lead, 2, M, M)[..., rows, colc]        # [..., 2, M, H]
    counts = full_cnts.reshape(*lead, 2, M, M)[..., rows, colc]
    return torch.where(keep, sums, 0.0), torch.where(keep, counts, 0.0)


def _finalize_cohorts(sums, counts):
    """Partials -> ``(R f[..., M, H], R_valid bool[..., M, H])``."""
    means = sums / counts.clamp(min=1.0)
    ok = counts > 0
    R = means[..., 1, :, :] - means[..., 0, :, :]
    R_valid = ok[..., 1, :, :] & ok[..., 0, :, :]
    return R, R_valid


def _holding_month_spreads(R, R_valid, Ks):
    """Cohort tensor -> per-(J, K) overlap-averaged spreads by holding month.

    Re-indexes cohorts by holding month (``D[j, m, h] = R[j, m-(h+1), h]``),
    prefix-sums over the horizon axis and gathers each K (the JT 1/K
    overlap).  A month is live only when all K cohorts exist.

    Args: R f[nJ, M, H]; R_valid bool[nJ, M, H]; Ks i64[nK].
    Returns (spreads f[nJ, nK, M] NaN-filled, live bool[nJ, nK, M]).
    """
    nJ, M, H = R.shape
    dev = R.device
    src = torch.arange(M, device=dev)[:, None] - (torch.arange(H, device=dev)[None, :] + 1)
    in_range = src >= 0
    src_c = src.clamp(0, M - 1)
    h_idx = torch.arange(H, device=dev)[None, :].expand(M, H)
    D = R[:, src_c, h_idx]
    D_valid = R_valid[:, src_c, h_idx] & in_range[None]

    csum = torch.cumsum(torch.where(D_valid, D, 0.0), dim=2)
    cvalid = torch.cumsum(D_valid.to(torch.int32), dim=2)

    k_idx = (Ks - 1).clamp(0, H - 1)
    spreads = csum[:, :, k_idx] / Ks.clamp(min=1)[None, None, :]
    live = cvalid[:, :, k_idx] == Ks[None, None, :]
    spreads = spreads.permute(0, 2, 1)                     # [nJ, nK, M]
    live = live.permute(0, 2, 1).contiguous()
    return torch.where(live, spreads, torch.nan), live


def validate_grid_args(Ks, max_hold):
    """The horizon bound must cover max(Ks); defaults to max(Ks)."""
    k_max = int(np.max(Ks.cpu().numpy() if torch.is_tensor(Ks) else np.asarray(Ks)))
    if max_hold is None:
        return k_max
    if k_max > max_hold:
        raise ValueError(
            f"max(Ks)={k_max} exceeds max_hold={max_hold}; raise max_hold "
            "(the cohort-horizon bound) to cover every K"
        )
    return max_hold


def jk_grid_backtest(
    prices,
    mask,
    Js,
    Ks,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    max_hold: int | None = None,
    freq: int = 12,
    impl: str = "kernel",
) -> GridResult:
    """Run the full J x K momentum grid on the panel's device.

    Args:
      prices: f[A, M] month-end price tensor; mask: bool[A, M].
      Js: formation lookbacks ``[nJ]``; Ks: holding periods ``[nK]``.
      skip: months skipped between formation window and holding.
      n_bins: quantile bins; mode: 'qcut' (parity), 'rank' or 'hist'
        (the labels of 'rank' without a sort).
      max_hold: horizon bound H (defaults to max(Ks)); K2 takes H <= 128.
      impl: 'kernel' (CUDA kernel K2 on the card), 'plain', 'matmul' or
        'matmul_bf16' (see :func:`_cohort_partial_sums`).
    """
    max_hold = validate_grid_args(Ks, max_hold)
    dev = prices.device
    Js = torch.as_tensor(Js, device=dev).to(torch.int64)
    Ks = torch.as_tensor(Ks, device=dev).to(torch.int64)
    ret, ret_valid = monthly_returns(prices, mask)

    mom, mom_valid = momentum_dynamic(prices, mask, Js, skip)   # [nJ, A, M]
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    R, R_valid = _finalize_cohorts(
        *_cohort_partial_sums(labels, ret, ret_valid, n_bins, max_hold,
                              impl=impl))
    spreads, spread_valid = _holding_month_spreads(R, R_valid, Ks)

    return GridResult(
        spreads=spreads,
        spread_valid=spread_valid,
        mean_spread=masked_mean(spreads, spread_valid),
        ann_sharpe=sharpe(spreads, spread_valid, freq_per_year=freq),
        tstat=t_stat(spreads, spread_valid),
        tstat_nw=nw_t_stat(spreads, spread_valid, lags=Ks[None, :],
                           max_lag=max_hold),
        Js=Js,
        Ks=Ks,
        skip=torch.tensor(skip, device=dev),
        n_bins=n_bins,
        mode=mode,
    )


def _require_build_params(grid: GridResult, what: str):
    if grid.Js is None or grid.Ks is None or grid.skip is None \
            or grid.n_bins is None or grid.mode is None:
        raise ValueError(
            f"{what} needs the GridResult's build parameters "
            "(Js/Ks/skip/n_bins/mode), but this result carries none: it was "
            "not produced by jk_grid_backtest, so its axes need not be a "
            "(formation, holding) grid and spread netting is undefined for it"
        )


def _netted(net, valid, Js, Ks_c: tuple, skip, n_bins: int, mode: str,
            freq: int) -> GridResult:
    """A GridResult of the netted spreads ``net`` with the gross grid's
    validity, parameters and HAC bandwidth (lag = K)."""
    Ks = torch.as_tensor(Ks_c, device=net.device)
    return GridResult(
        spreads=net,
        spread_valid=valid,
        mean_spread=masked_mean(net, valid),
        ann_sharpe=sharpe(net, valid, freq_per_year=freq),
        tstat=t_stat(net, valid),
        tstat_nw=nw_t_stat(net, valid, lags=Ks[None, :], max_lag=max(Ks_c)),
        Js=Js,
        Ks=Ks,
        skip=skip,
        n_bins=n_bins,
        mode=mode,
    )


def _grid_net_core_impl(prices, mask, Js, spreads, spread_valid, half_spread,
                        Ks_c: tuple, skip: int, n_bins: int, mode: str):
    """The per-cell net planes ``f[nJ, nK, M]`` of the netting pass: each
    J's books and turnover cost from its own labels, so a slice of the Js
    nets on its own (the sharded netting pass splits them)."""
    M = prices.shape[1]
    mom, mom_valid = momentum_dynamic(prices, mask, Js, skip)   # [nJ, A, M]
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    # long_short_weights reads only the two extreme bins' counts
    counts = torch.zeros((labels.shape[0], n_bins, M), dtype=torch.int32,
                         device=labels.device)
    counts[:, 0] = (labels == 0).sum(dim=1)
    counts[:, n_bins - 1] = (labels == n_bins - 1).sum(dim=1)
    w_f = long_short_weights(labels, counts, n_bins, dtype=spreads.dtype)

    # one prefix sum serves every K's trailing window
    c = torch.cumsum(w_f, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    t1 = torch.arange(M, device=w_f.device) + 1
    costs = []
    for K in Ks_c:
        S = c[..., 1:] - c[..., (t1 - K).clamp(min=0)]
        # book held in month m = mean of the cohorts formed at m-K .. m-1
        w_pf = torch.nn.functional.pad(S, (1, 0))[..., :M] / K
        costs.append(turnover_cost(w_pf, half_spread))               # [nJ, M]
    cost = torch.stack(costs, dim=1)                                 # [nJ, nK, M]
    return torch.where(spread_valid, spreads - cost, torch.nan)


def _grid_net_core(prices, mask, Js, spreads, spread_valid, half_spread,
                   Ks_c: tuple, skip: int, n_bins: int, mode: str,
                   freq: int) -> GridResult:
    """The netting pass of :func:`grid_net_of_costs` on a gross grid's
    ``spreads``/``spread_valid`` (``[nJ, nK, M]``), with the grid's
    parameters given explicitly (counterpart of the reference's
    ``_grid_net_core``, its ``--tc-bps`` pass, with the same signature).
    ``Js`` is a tensor of the lookbacks; ``Ks_c`` a tuple of the holding
    periods."""
    net = _grid_net_core_impl(prices, mask, Js, spreads, spread_valid,
                              half_spread, Ks_c, skip, n_bins, mode)
    return _netted(net, spread_valid, Js, Ks_c,
                   torch.tensor(skip, device=net.device), n_bins, mode, freq)


def grid_net_of_costs(prices, mask, grid: GridResult,
                      half_spread: float = 0.0005, freq: int = 12) -> GridResult:
    """Cost-netted J x K grid with the exact overlapping-portfolio turnover.

    The month-m (J, K) book is the 1/K average of the K most recent
    formation cohorts' equal-weight long-short books (cohorts formed at
    m-K .. m-1, the alignment of :func:`_holding_month_spreads`): a K-window
    rolling mean of the formation weights, taken for every K from one
    prefix sum over the ``[nJ, A, M]`` weights.  The month-over-month L1
    weight change is the traded turnover, and ``half_spread`` per unit of
    it nets the spread.

    The formation labels are recomputed from the parameters the result
    carries (``Js/Ks/skip/n_bins/mode``), as the reference does
    (``momentum_dynamic`` and ``decile_assign_panel``, with no listing
    filter); ``prices``/``mask`` must be the panel the grid was built from.
    Raises on a result that carries no parameters.  Host-side: the carried
    Ks and skip are read back to the host.

    Returns a :class:`GridResult` of the netted spreads (same validity and
    parameters).
    """
    _require_build_params(grid, "grid_net_of_costs")
    return _grid_net_core(prices, mask, grid.Js, grid.spreads, grid.spread_valid,
                          half_spread, Ks_c=tuple(int(k) for k in grid.Ks.tolist()),
                          skip=int(grid.skip), n_bins=grid.n_bins, mode=grid.mode,
                          freq=freq)


def grid_break_even_bps(prices, mask, grid: GridResult,
                        unit: GridResult | None = None):
    """Per-cell break-even half-spread in bps: the gross mean spread per
    unit of mean monthly turnover, ``mean(gross) / mean(turnover) * 1e4``
    (the cost is linear in the half-spread, so one unit-cost run prices
    every level).  Pass ``unit`` (a ``grid_net_of_costs(..., half_spread=
    1.0)`` result) to reuse it.  Returns ``(be_bps f[nJ, nK],
    mean_turnover f[nJ, nK])``; zero turnover gives +/-inf.
    """
    if unit is None:
        unit = grid_net_of_costs(prices, mask, grid, half_spread=1.0)
    mean_turn = masked_mean(grid.spreads - unit.spreads, grid.spread_valid)
    return grid.mean_spread / mean_turn * 1e4, mean_turn


def grid_net_from_unit(grid: GridResult, unit: GridResult, half_spread: float,
                       freq: int = 12) -> GridResult:
    """Re-price a netted grid at any cost level from one unit-cost run
    (``unit = grid_net_of_costs(..., half_spread=1.0)``): the unit cost per
    month is ``grid.spreads - unit.spreads``, scaled elementwise, with the
    statistics re-assembled; equal to ``grid_net_of_costs(...,
    half_spread)`` up to rounding."""
    _require_build_params(grid, "grid_net_from_unit")
    cost_unit = grid.spreads - unit.spreads
    net = torch.where(grid.spread_valid, grid.spreads - half_spread * cost_unit,
                      torch.nan)
    return _netted(net, grid.spread_valid, grid.Js,
                   tuple(int(k) for k in grid.Ks.tolist()), grid.skip,
                   grid.n_bins, grid.mode, freq)
