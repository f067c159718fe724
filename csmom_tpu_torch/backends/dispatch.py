"""Host-side entry points: a month-end :class:`Panel` in, a report of host
arrays out.

Counterpart of :func:`csmom_tpu.backends.dispatch.run_monthly` (the card
engine, the pandas engine, strategy plugins and sector-neutral ranking)
plus :func:`run_grid`, its J x K twin.  The card engine runs on
``device="cuda"`` unless the caller passes ``device="cpu"``, and raises
when no card is present.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.panel.panel import Panel, to_tensors
from csmom_tpu_torch.workloads import GRID_JS, GRID_KS


@dataclasses.dataclass(frozen=True)
class MonthlyReport:
    """Monthly backtest report (host types only)."""

    times: np.ndarray          # [M] month-end timestamps
    spread: np.ndarray         # f[M], NaN = invalid month
    decile_means: np.ndarray   # f[n_bins, M]
    decile_counts: np.ndarray  # i[n_bins, M]
    labels: np.ndarray         # i[A, M], -1 invalid
    mean_spread: float
    ann_sharpe: float
    tstat: float
    tstat_nw: float
    backend: str

    def spread_series(self):
        """The valid months' spread as a pandas Series named ``spread``,
        indexed by month end (the reference's method)."""
        import pandas as pd

        return pd.Series(self.spread, index=self.times, name="spread").dropna()


@dataclasses.dataclass(frozen=True)
class GridReport:
    """J x K grid report (host types only); axes [nJ, nK, ...]."""

    times: np.ndarray          # [M] holding-month timestamps
    Js: np.ndarray             # i[nJ]
    Ks: np.ndarray             # i[nK]
    spreads: np.ndarray        # f[nJ, nK, M], NaN = not live
    spread_valid: np.ndarray   # bool[nJ, nK, M]
    mean_spread: np.ndarray    # f[nJ, nK]
    ann_sharpe: np.ndarray     # f[nJ, nK]
    tstat: np.ndarray          # f[nJ, nK]
    tstat_nw: np.ndarray       # f[nJ, nK]
    backend: str


# the card engine's names: ``"tpu"`` is the reference's, so one config
# file serves both packages
CARD_BACKENDS = ("torch", "tpu")


def run_monthly(
    panel: Panel,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    freq: int = 12,
    device=None,
    dtype=None,
    sector_ids=None,
    n_sectors: int = 0,
    backend: str = "torch",
    strategy=None,
    **panels,
) -> MonthlyReport:
    """Monthly decile backtest of a month-end price panel [A, M].

    ``backend`` is ``"torch"`` (the engine on ``device``, which defaults
    to ``"cuda"``; ``"tpu"`` is accepted as its name in the reference's
    config files) or ``"pandas"`` (the reference-semantics CPU engine,
    which ignores ``device``, ``dtype`` and ``mode``).  ``dtype`` defaults
    to the panel's own.  ``strategy`` is an optional
    :class:`~csmom_tpu_torch.strategy.Strategy` ranked instead of the
    built-in momentum signal; extra ``**panels`` (``volumes=``,
    ``volumes_mask=``; arrays or tensors) go to its ``signal``, and only
    names it reads are accepted.  ``sector_ids`` (int[A], negative =
    unclassified and unranked) with ``n_sectors`` >= 1 switches the card
    engine to sector-neutral ranking (BASELINE config 3), with or without
    a strategy.
    """
    if sector_ids is not None and (n_sectors is None or int(n_sectors) < 1):
        raise ValueError(
            "sector_ids requires n_sectors >= 1 (the sector id count)"
        )
    if strategy is None and panels:
        raise TypeError(
            f"unexpected keyword arguments {sorted(panels)} — extra panels are "
            "only forwarded to a strategy plugin (did you misspell a parameter, "
            "or forget strategy=?)"
        )
    if strategy is not None and panels:
        from csmom_tpu_torch.strategy import consumed_panels

        allowed = consumed_panels(strategy)
        unknown = sorted(set(panels) - allowed)
        if unknown:
            raise TypeError(
                f"panel kwarg(s) {unknown} match no signal parameter of "
                f"{type(strategy).__name__} (accepts: {sorted(allowed) or None}) "
                "— misspelled? A strategy's **panels catch-all exists to ignore "
                "panels other strategies need, not to swallow typos."
            )
    if sector_ids is not None and backend not in CARD_BACKENDS:
        raise NotImplementedError(
            "sector-neutral ranking runs on the card engine only "
            "(backend='torch'; works with or without strategy=)"
        )
    if backend == "pandas":
        return _run_monthly_pandas(panel, lookback, skip, n_bins, freq, strategy,
                                   panels)
    if backend not in CARD_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected 'torch' or 'pandas')")

    from csmom_tpu_torch.backtest.monthly import (
        monthly_spread_backtest,
        sector_neutral_backtest,
    )

    v, m = to_tensors(panel.values, panel.mask, device=device, dtype=dtype)
    sid = None
    if sector_ids is not None:
        sid = torch.as_tensor(np.asarray(sector_ids, np.int64), device=v.device)
    if strategy is not None:
        from csmom_tpu_torch.strategy import strategy_backtest

        res = strategy_backtest(
            v, m, strategy, n_bins=n_bins, mode=mode, freq=freq, sector_ids=sid,
            n_sectors=int(n_sectors) if sid is not None else None,
            **{k: _panel_tensor(x, v) for k, x in panels.items()})
    elif sid is not None:
        res = sector_neutral_backtest(v, m, sid, int(n_sectors), lookback=lookback,
                                      skip=skip, n_bins=n_bins, mode=mode,
                                      freq=freq)
    else:
        res = monthly_spread_backtest(v, m, lookback=lookback, skip=skip,
                                      n_bins=n_bins, mode=mode, freq=freq)
    spread = np.where(res.spread_valid.cpu().numpy(), res.spread.cpu().numpy(),
                      np.nan)
    return MonthlyReport(
        times=panel.times,
        spread=spread,
        decile_means=res.decile_means.cpu().numpy(),
        decile_counts=res.decile_counts.cpu().numpy(),
        labels=res.labels.cpu().numpy(),
        mean_spread=float(res.mean_spread),
        ann_sharpe=float(res.ann_sharpe),
        tstat=float(res.tstat),
        tstat_nw=float(res.tstat_nw),
        backend=f"torch:{v.device.type}",
    )


def _panel_tensor(x, like):
    """An extra panel on ``like``'s device: floats in ``like``'s dtype,
    masks as bool; None passes through."""
    if x is None:
        return None
    t = torch.as_tensor(x, device=like.device)
    return t if t.dtype == torch.bool else t.to(like.dtype)


def _run_monthly_pandas(panel, lookback, skip, n_bins, freq, strategy, panels):
    if strategy is not None:
        from csmom_tpu_torch.strategy import strategy_backtest_pandas

        res = strategy_backtest_pandas(panel.to_dataframe(), strategy,
                                       n_bins=n_bins, freq=freq, **panels)
    else:
        from csmom_tpu_torch.backends.pandas_engine import (
            monthly_spread_backtest_pandas,
        )

        res = monthly_spread_backtest_pandas(panel.to_dataframe(), lookback=lookback,
                                             skip=skip, n_bins=n_bins, freq=freq)
    return MonthlyReport(
        times=panel.times,
        spread=res.spread.to_numpy(),
        decile_means=res.decile_means.to_numpy(),
        decile_counts=res.decile_counts.to_numpy(),
        labels=res.labels.to_numpy(),
        mean_spread=res.mean_spread,
        ann_sharpe=res.ann_sharpe,
        tstat=res.tstat,
        tstat_nw=res.tstat_nw,
        backend="pandas",
    )


def run_grid(
    panel: Panel,
    Js=GRID_JS,
    Ks=GRID_KS,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    max_hold: int | None = None,
    freq: int = 12,
    device=None,
    dtype=None,
    impl: str = "kernel",
) -> GridReport:
    """J x K momentum grid of a month-end price panel [A, M].

    ``device`` defaults to ``"cuda"``; ``dtype`` to the panel's own;
    ``mode`` is 'qcut', 'rank' or 'hist'; ``impl`` the cohort aggregation
    ('kernel', 'plain', 'matmul' or 'matmul_bf16').
    """
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest

    v, m = to_tensors(panel.values, panel.mask, device=device, dtype=dtype)
    res = jk_grid_backtest(v, m, Js, Ks, skip=skip, n_bins=n_bins, mode=mode,
                           max_hold=max_hold, freq=freq, impl=impl)
    return GridReport(
        times=panel.times,
        Js=res.Js.cpu().numpy(),
        Ks=res.Ks.cpu().numpy(),
        spreads=res.spreads.cpu().numpy(),
        spread_valid=res.spread_valid.cpu().numpy(),
        mean_spread=res.mean_spread.cpu().numpy(),
        ann_sharpe=res.ann_sharpe.cpu().numpy(),
        tstat=res.tstat.cpu().numpy(),
        tstat_nw=res.tstat_nw.cpu().numpy(),
        backend=f"torch:{v.device.type}",
    )
