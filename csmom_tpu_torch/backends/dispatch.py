"""Host-side entry points: a month-end :class:`Panel` in, a report of host
arrays out.

Counterpart of :func:`csmom_tpu.backends.dispatch.run_monthly` (its
panel-engine branch, without strategy plugins or sectors) plus
:func:`run_grid`, its J x K twin.  Both run on ``device="cuda"`` unless
the caller passes ``device="cpu"``, and raise when no card is present.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


def run_monthly(
    panel: Panel,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    freq: int = 12,
    device=None,
    dtype=None,
) -> MonthlyReport:
    """Monthly decile backtest of a month-end price panel [A, M].

    ``device`` defaults to ``"cuda"``; ``dtype`` to the panel's own.
    """
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest

    v, m = to_tensors(panel.values, panel.mask, device=device, dtype=dtype)
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
) -> GridReport:
    """J x K momentum grid of a month-end price panel [A, M].

    ``device`` defaults to ``"cuda"``; ``dtype`` to the panel's own.
    """
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest

    v, m = to_tensors(panel.values, panel.mask, device=device, dtype=dtype)
    res = jk_grid_backtest(v, m, Js, Ks, skip=skip, n_bins=n_bins, mode=mode,
                           max_hold=max_hold, freq=freq)
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
