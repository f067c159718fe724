"""Builtin engine registrations: the five serve endpoints.

Counterpart of ``csmom_tpu.registry.builtin``'s serve registrations, in
the same order and with the same ``output``, ``summary_fields`` and
``panel_family``: ``momentum``, ``turnover``, ``backtest``,
``low_volatility`` and ``zscore_combo``.  The numpy stubs are the
reference's, copied.

Each ``batch_fn(params)`` returns a scorer of the whole micro-batch,
``fn(values f[B, A, M], mask bool[B, A, M])``, where the reference's
returns one request's scorer for ``jax.vmap``.  The scorers run on the
tensors' device with no loop over B, so the kernels they launch do not
launch more often for a larger batch:

- time-axis steps (returns, momentum, rolling windows) act on each
  asset row's months, ``[B*A, M]``, so no request reads another's
  months;
- cross-sectional steps (ranking, z-scores, K1's sums over assets) act
  on each (request, month) column; ``backtest`` runs
  :func:`~csmom_tpu_torch.backtest.monthly.monthly_spread_backtest`'s
  steps on the batch, launching K1 once on ``[A, B*M]``.

Padded rows and padded assets are all-masked and score as the reference
scores them (NaN, or the summary of an empty spread series).
"""

from __future__ import annotations

import numpy as np

from csmom_tpu_torch.registry.core import REGISTRY, EngineSpec, ServeSurface

# days constant the turnover stub shares with signals.turnover's ADV proxy
_TRADING_DAYS_PER_MONTH = 21.0


def _nanmean(a, axis: int):
    """All-NaN-slice-safe nanmean (np.nanmean warns on empty slices; a
    padded stub batch is full of them by design)."""
    ok = np.isfinite(a)
    c = ok.sum(axis=axis)
    s = np.where(ok, a, 0.0).sum(axis=axis)
    return np.where(c > 0, s / np.maximum(c, 1), np.nan)


def _xs_z_np(score, valid):
    """Cross-sectional z-score over the asset axis of f[B, A] (the stub
    mirror of ``strategy.base.xs_zscore`` at the last formation date)."""
    v = valid & np.isfinite(score)
    n = np.maximum(v.sum(axis=1, keepdims=True), 1)
    x = np.where(v, np.nan_to_num(score), 0.0)
    mu = x.sum(axis=1, keepdims=True) / n
    sd = np.sqrt(np.where(v, (x - mu) ** 2, 0.0).sum(axis=1,
                                                     keepdims=True) / n)
    z = np.where(sd > 0, (x - mu) / np.where(sd == 0, 1.0, sd), 0.0)
    return np.where(v, z, 0.0)


def _last(score, valid):
    """The last formation month's score, NaN where it is invalid."""
    import torch

    return torch.where(valid[..., -1], score[..., -1], torch.nan)


def _momentum_batch(params):
    from csmom_tpu_torch.signals.momentum import momentum

    lookback, skip = params["lookback"], params["skip"]

    def fn(values, mask):
        return _last(*momentum(values, mask, lookback=lookback, skip=skip))

    return fn


def _momentum_stub(params):
    lookback, skip = params["lookback"], params["skip"]

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        end = v[:, :, -1 - skip]
        start = v[:, :, -1 - skip - lookback]
        with np.errstate(divide="ignore", invalid="ignore"):
            return end / start - 1.0

    return fn


def _turnover_batch(params):
    import torch

    from csmom_tpu_torch.signals.turnover import turnover_features

    lookback = params["lookback"]

    def fn(values, mask):
        # no shares outstanding in a request: turnover of unit shares
        shares = torch.ones(values.shape[-2], dtype=values.dtype,
                            device=values.device)
        return _last(*turnover_features(values, mask, shares,
                                        lookback=lookback)["turn_avg"])

    return fn


def _turnover_stub(params):
    lookback = params["lookback"]

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        return (_nanmean(v[:, :, -lookback:], -1)
                / _TRADING_DAYS_PER_MONTH)

    return fn


def _backtest_batch(params):
    import torch

    from csmom_tpu_torch.analytics.stats import masked_mean, sharpe
    from csmom_tpu_torch.backtest.monthly import formation_labels, next_month_spread

    lookback, skip = params["lookback"], params["skip"]
    n_bins, mode = params["n_bins"], params["mode"]

    def fn(values, mask):
        # monthly_spread_backtest's steps, its statistics cut to the two
        # the endpoint returns; K1 once for the batch
        ret, ret_valid, labels = formation_labels(values, mask, lookback, skip,
                                                  n_bins, mode)
        spread, ok, _, _ = next_month_spread(ret, ret_valid, labels, n_bins)
        return torch.stack([masked_mean(spread, ok),
                            sharpe(spread, ok, freq_per_year=12)], dim=-1)

    return fn


def _backtest_stub(params):
    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        with np.errstate(divide="ignore", invalid="ignore"):
            ret = v[:, :, 1:] / v[:, :, :-1] - 1.0
        mean = _nanmean(_nanmean(ret, 1), -1)
        return np.stack([np.nan_to_num(mean), np.zeros_like(mean)], axis=-1)

    return fn


def _strategy_last_column(make_strategy_instance):
    """The strategy -> serve-endpoint adapter: score the batch through
    ``Strategy.signal`` (whose steps take ``[B, A, M]``) and serve the
    last formation column.  The strategy is built once per (endpoint,
    params)."""

    def batch(params):
        strat = make_strategy_instance(params)

        def fn(values, mask):
            return _last(*strat.signal(values, mask))

        return fn

    return batch


def _low_volatility_stub(params):
    window = 36  # the registered endpoint's canonical LowVolatility()

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        with np.errstate(divide="ignore", invalid="ignore"):
            ret = v[:, :, 1:] / v[:, :, :-1] - 1.0
        w = ret[:, :, -window:]
        ok = np.isfinite(w)
        n = ok.sum(-1)
        x = np.where(ok, w, 0.0)
        mean = x.sum(-1) / np.maximum(n, 1)
        var = (np.where(ok, (x - mean[..., None]) ** 2, 0.0).sum(-1)
               / np.maximum(n - 1, 1))
        return np.where(n >= 2, -np.sqrt(var), np.nan)

    return fn


def _zscore_combo_stub(params):
    mom_stub = _momentum_stub(params)

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        mom = mom_stub(values, mask)
        with np.errstate(divide="ignore", invalid="ignore"):
            rev = -(v[:, :, -1] / v[:, :, -2] - 1.0)
        valid = np.isfinite(mom) & np.isfinite(rev)
        z = 0.5 * _xs_z_np(mom, valid) + 0.5 * _xs_z_np(rev, valid)
        return np.where(valid, z, np.nan)

    return fn


def _mk_low_volatility(params):
    from csmom_tpu_torch.strategy.builtin import LowVolatility

    return LowVolatility()


def _mk_zscore_combo(params):
    from csmom_tpu_torch.strategy.builtin import ZScoreCombo

    # equal-weight momentum + short-term reversal, both z-scored per date
    return ZScoreCombo("momentum:0.5,reversal:0.5")


REGISTRY.register(EngineSpec(
    name="momentum", kind="serve",
    description="compounded (J, skip) price momentum at the last "
                "formation date (the reference's signal)",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(batch_fn=_momentum_batch, stub_fn=_momentum_stub,
                       panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="turnover", kind="serve",
    description="trailing-lookback average turnover proxy (monthly "
                "share volume / ADV denominator)",
    axes="values f[B,A,M] monthly volumes, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(batch_fn=_turnover_batch, stub_fn=_turnover_stub,
                       panel_family="volume"),
))

REGISTRY.register(EngineSpec(
    name="backtest", kind="serve",
    description="full monthly decile spread backtest per request panel "
                "-> (mean_spread, ann_sharpe)",
    axes="values f[B,A,M], mask bool[B,A,M] -> f[B,2]",
    serve=ServeSurface(batch_fn=_backtest_batch, stub_fn=_backtest_stub,
                       output="summary",
                       summary_fields=("mean_spread", "ann_sharpe"),
                       panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="low_volatility", kind="serve",
    description="Blitz-van Vliet volatility effect: negated trailing "
                "36m return volatility, through the strategy adapter",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(
        batch_fn=_strategy_last_column(_mk_low_volatility),
        stub_fn=_low_volatility_stub, panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="zscore_combo", kind="serve",
    description="equal-weight z-scored momentum + short-term reversal "
                "combo, through the strategy adapter",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(
        batch_fn=_strategy_last_column(_mk_zscore_combo),
        stub_fn=_zscore_combo_stub, panel_family="price"),
))
