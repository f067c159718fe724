"""Sharded backtest engines: ``shard_map`` with all_gather and psum over the
asset axis.

Counterpart of :mod:`csmom_tpu.parallel.collectives`, with the same
communication pattern:

- the signal kernels (returns, momentum) run shard-locally: they are
  per-asset;
- the cross-sectional rank is the one global step: each shard
  all_gathers the ``[A_l, M]`` formation signal into the whole
  cross-section, ranks it and keeps its own rows (or, in mode
  ``rank_hist``, finds the same labels by radix histograms whose traffic
  does not grow with A);
- the aggregation is shard-local partial sums, one psum over the
  ``assets`` axis, then the division: kernel K1 once per asset shard in
  the monthly engine, kernel K2 once per (grid shard, asset shard) in
  the grid;
- the parameter grid splits over an optional ``grid`` axis with no
  communication.

Labels, counts and validity equal the single-device engines'; a psum of
partials adds in another order than one pass over every asset, so float
sums may differ in their last bits.  Each shard hands the kernels
contiguous ``[A_l, M]`` inputs, so their launch plans are planned for
``A_l`` assets.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.backtest.grid import (
    GridResult,
    _cohort_partial_sums,
    _finalize_cohorts,
    _holding_month_spreads,
    validate_grid_args,
)
from csmom_tpu_torch.backtest.monthly import decile_means, decile_partial_sums
from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.parallel.compat import all_gather, axis_index, psum, shard_map
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum,
    momentum_dynamic,
    monthly_returns,
)

__all__ = ["grid_shard_fn", "sharded_banded_backtest",
           "sharded_jk_grid_backtest", "sharded_monthly_spread_backtest"]


def _local_slice(full, axis_name: str, n_local: int, dim: int = -2):
    """This shard's rows of a gathered array, contiguous."""
    i = axis_index(axis_name)
    return full.narrow(dim, i * n_local, n_local).contiguous()


def _ranked_labels_local(mom_l, momv_l, n_bins: int, mode: str,
                         axis_name: str = "assets"):
    """The distributed cross-sectional rank of ``[..., A_l, M]`` signals:
    ``(this shard's labels i32[..., A_l, M], effective bins)``.

    ``qcut``/``rank``/``hist``: gather, rank the whole cross-section,
    take this shard's rows.  ``rank_hist``: rank-mode labels by
    radix-histogram boundary selection
    (:mod:`csmom_tpu_torch.parallel.histrank`).
    """
    if mode == "rank_hist":
        from csmom_tpu_torch.parallel.histrank import histogram_rank_labels

        labels = histogram_rank_labels(mom_l, momv_l, n_bins, axis_name)
        n = psum(momv_l.sum(dim=-2, dtype=torch.int32), axis_name)
        return labels, n.clamp(max=n_bins)
    mom_f = all_gather(mom_l, axis_name, dim=-2, tiled=True)
    momv_f = all_gather(momv_l, axis_name, dim=-2, tiled=True)
    labels_f, n_eff = decile_assign_panel(mom_f, momv_f, n_bins=n_bins, mode=mode)
    return _local_slice(labels_f, axis_name, mom_l.shape[-2]), n_eff


def _formation_local(pv, mv, lookback, skip: int, n_bins: int, mode: str):
    """One shard's ``(ret, ret_valid, labels)``: the single-device
    formation (``backtest.monthly.formation_labels``) with the rank
    distributed."""
    ret_l, retv_l = monthly_returns(pv, mv)
    mom_l, momv_l = momentum(pv, mv, lookback=lookback, skip=skip)
    # the single-device delisting rule, shard-locally exact: the time
    # axis is whole on every shard
    momv_l = momv_l & formation_listed_mask(mv, skip)
    mom_l = torch.where(momv_l, mom_l, torch.nan)
    labels_l, _ = _ranked_labels_local(mom_l, momv_l, n_bins, mode)
    return ret_l, retv_l, labels_l


def sharded_monthly_spread_backtest(prices, mask, mesh, lookback: int = 12,
                                    skip: int = 1, n_bins: int = 10,
                                    mode: str = "qcut", freq: int = 12,
                                    impl: str = "kernel"):
    """The asset-sharded monthly decile backtest.

    ``prices``/``mask`` are ``[A, M]`` with A divisible by the mesh's
    asset-shard count (:func:`csmom_tpu_torch.parallel.mesh.pad_assets`).
    K1 runs once per asset shard (``impl="kernel"``; its plain version
    on CPU tensors or with ``impl="plain"``).  Returns ``(spread f[M],
    spread_valid bool[M], mean, sharpe, tstat)`` on the mesh's first
    device.
    """
    def local_fn(pv, mv):
        ret_l, retv_l, labels_l = _formation_local(pv, mv, lookback, skip,
                                                   n_bins, mode)
        next_ret = torch.roll(ret_l, -1, dims=1)
        next_valid = torch.roll(retv_l, -1, dims=1)
        next_valid[:, -1] = False
        next_valid &= labels_l >= 0
        sums, counts = decile_partial_sums(next_ret, next_valid, labels_l,
                                           n_bins, impl=impl)
        sums = psum(sums, "assets")
        counts = psum(counts, "assets")
        means = decile_means(sums, counts)
        valid = (counts[n_bins - 1] > 0) & (counts[0] > 0)
        spread = torch.where(valid, means[n_bins - 1] - means[0], torch.nan)
        return spread, valid

    spec_in = P("assets", None)
    spread, valid = shard_map(local_fn, mesh=mesh, in_specs=(spec_in, spec_in),
                              out_specs=(P(), P()))(prices, mask)
    return (spread, valid, masked_mean(spread, valid),
            sharpe(spread, valid, freq_per_year=freq), t_stat(spread, valid))


def sharded_banded_backtest(prices, mask, mesh, lookback: int = 12,
                            skip: int = 1, n_bins: int = 10, mode: str = "qcut",
                            band: int = 1, freq: int = 12):
    """The asset-sharded hysteresis-banded backtest
    (:mod:`csmom_tpu_torch.backtest.banded`).

    The band recursion is per asset, so the books form shard-locally;
    distribution adds the shared rank and one psum of the four per-month
    book partials.  Returns ``(spread f[M], spread_valid bool[M], mean,
    sharpe, tstat_nw)`` on the mesh's first device.
    """
    from csmom_tpu_torch.backtest.banded import (
        banded_books,
        book_partials,
        finalize_book_spread,
        validate_band,
    )

    validate_band(band, n_bins)

    def local_fn(pv, mv):
        ret_l, retv_l, labels_l = _formation_local(pv, mv, lookback, skip,
                                                   n_bins, mode)
        long_l, short_l = banded_books(labels_l, n_bins, band)
        partials = psum(book_partials(long_l, short_l, ret_l, retv_l), "assets")
        spread, valid, _, _ = finalize_book_spread(partials)
        return spread, valid

    spec_in = P("assets", None)
    spread, valid = shard_map(local_fn, mesh=mesh, in_specs=(spec_in, spec_in),
                              out_specs=(P(), P()))(prices, mask)
    return (spread, valid, masked_mean(spread, valid),
            sharpe(spread, valid, freq_per_year=freq), nw_t_stat(spread, valid))


@lru_cache(maxsize=32)
def grid_shard_fn(mesh, skip: int, n_bins: int, mode: str, max_hold: int,
                  impl: str):
    """The sharded grid's spread computation for one (mesh, parameters),
    cached so every caller (the engine, the ``bench-mesh`` warm-up) runs
    one callable.

    Returns ``fn(prices, mask, Js, Ks) -> (spreads f[nJ, nK, M], live
    bool[nJ, nK, M])``: prices/mask split over ``assets``, Js over
    ``grid``, Ks replicated.  K2 (``impl="kernel"``) runs once per shard
    for the shard's Js and assets.
    """
    H = max_hold

    def local_fn(prices, mask, Js, Ks):
        ret_l, retv_l = monthly_returns(prices, mask)
        mom_l, momv_l = momentum_dynamic(prices, mask, Js, skip)  # [nJ_l, A_l, M]
        momv_l = momv_l & formation_listed_mask(mask, skip)
        mom_l = torch.where(momv_l, mom_l, torch.nan)
        labels_l, _ = _ranked_labels_local(mom_l, momv_l, n_bins, mode)
        sums, counts = _cohort_partial_sums(labels_l, ret_l, retv_l, n_bins, H,
                                            impl=impl)            # [nJ_l, 2, M, H]
        sums = psum(sums, "assets")
        counts = psum(counts, "assets")
        return _holding_month_spreads(*_finalize_cohorts(sums, counts), Ks)

    return shard_map(local_fn, mesh=mesh,
                     in_specs=(P("assets", None), P("assets", None), P("grid"), P()),
                     out_specs=(P("grid", None, None), P("grid", None, None)))


def _int64(x):
    return (x.to(torch.int64) if torch.is_tensor(x)
            else torch.as_tensor(np.asarray(x), dtype=torch.int64))


def sharded_jk_grid_backtest(prices, mask, Js, Ks, mesh, skip: int = 1,
                             n_bins: int = 10, mode: str = "qcut",
                             max_hold: int | None = None, freq: int = 12,
                             impl: str = "kernel") -> GridResult:
    """The J x K grid over a ``("grid", "assets")`` mesh.

    J cells split over ``grid`` (nJ divisible by its size), assets over
    ``assets``.  Returns the single-device engine's
    :class:`~csmom_tpu_torch.backtest.grid.GridResult` (every field on
    the mesh's first device, the Newey–West t-stat at lag K included),
    so the two are interchangeable.  ``impl`` takes every value
    :func:`~csmom_tpu_torch.backtest.grid.jk_grid_backtest` takes;
    ``mode`` also takes ``rank_hist``.
    """
    max_hold = validate_grid_args(Ks, max_hold)
    Js, Ks = _int64(Js), _int64(Ks)
    spreads, live = grid_shard_fn(mesh, skip, n_bins, mode, max_hold,
                                  impl)(prices, mask, Js, Ks)
    home = spreads.device
    Ks = Ks.to(home)
    return GridResult(
        spreads=spreads,
        spread_valid=live,
        mean_spread=masked_mean(spreads, live),
        ann_sharpe=sharpe(spreads, live, freq_per_year=freq),
        tstat=t_stat(spreads, live),
        tstat_nw=nw_t_stat(spreads, live, lags=Ks[None, :], max_lag=max_hold),
        Js=Js.to(home),
        Ks=Ks,
        skip=torch.tensor(skip, device=home),
        n_bins=n_bins,
        mode=mode,
    )
