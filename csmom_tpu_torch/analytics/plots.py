"""Artifact writers: the reference demo's result files, same names, same
schema.

A copy of :mod:`csmom_tpu.analytics.plots`.  The demo writes
``results/monthly_mom_cum.png`` (cumulative spread growth),
``results/intraday_cum_pnl.png`` (cumulative event-backtest PnL) and
``results/trades.csv`` (header ``datetime,ticker,size,price,impact,score``);
identical names and schemas keep a user's downstream tooling working.
Plots take host arrays and draw with matplotlib's Agg backend.

Plot style: line charts — primary hue + a small categorical cycle for
overlays, thin 2px line, recessive grid, neutral ink for text, legend only
when more than one series is drawn (otherwise the title names the series).
"""

from __future__ import annotations

import os

import numpy as np

_LINE = "#3b82b4"   # primary hue
_OVERLAYS = ("#b45a3b", "#5a9e6f", "#8a6db1")  # overlay cycle
_INK = "#333333"
_GRID = "#dddddd"


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def _line_plot(x, y, title: str, ylabel: str, out_path: str, extra=None,
               label=None):
    """One styled line chart; ``extra`` is an optional list of
    ``(label, x, y)`` overlay series drawn in the overlay hue cycle."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.plot(x, y, color=_LINE, linewidth=2, label=label)
    for i, (lab, xo, yo) in enumerate(extra or ()):
        ax.plot(xo, yo, color=_OVERLAYS[i % len(_OVERLAYS)], linewidth=2,
                label=lab)
    ax.set_title(title, color=_INK)
    ax.set_ylabel(ylabel, color=_INK)
    ax.grid(True, color=_GRID, linewidth=0.6)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.tick_params(colors=_INK)
    if extra:
        ax.legend(frameon=False, labelcolor=_INK)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def save_monthly_cum_plot(times, spread, results_dir: str,
                          fname: str = "monthly_mom_cum.png",
                          overlays=None) -> str:
    """Cumulative growth of the monthly spread, ``(1+r).cumprod()``, over
    valid months only.

    ``overlays`` is an optional ``{label: spread_series}`` dict drawn as
    extra lines (each over its own valid months, in the module's overlay
    hue cycle) — the CLI uses it to put the banded / vol-managed variants
    next to the plain spread in the same reference-schema artifact.
    """
    ensure_dir(results_dir)

    def _cum(s):
        s = np.asarray(s, dtype=float)
        v = np.isfinite(s)
        return np.asarray(times)[v], np.cumprod(1.0 + s[v])

    x, y = _cum(spread)
    extra = [(label, *_cum(s)) for label, s in (overlays or {}).items()]
    return _line_plot(
        x, y,
        "Monthly momentum: cumulative spread growth",
        "growth of $1",
        os.path.join(results_dir, fname),
        extra=extra or None,
        label="spread" if extra else None,
    )


def save_intraday_pnl_plot(times, pnl, results_dir: str,
                           fname: str = "intraday_cum_pnl.png") -> str:
    """Cumulative minute PnL, ``pnl.cumsum()``."""
    ensure_dir(results_dir)
    return _line_plot(
        np.asarray(times), np.cumsum(np.asarray(pnl, dtype=float)),
        "Intraday event backtest: cumulative PnL",
        "PnL ($)",
        os.path.join(results_dir, fname),
    )


def save_horizon_plot(profile, results_dir: str,
                      fname: str = "horizon_profile.png") -> str:
    """Event-time cumulative spread curve (the JT/LeSw hump: persistence
    then reversal).  ``profile`` carries ``cum_spread``: ``f[H]`` (one
    line) or ``f[V, H]`` (one line per volume tercile), an array or a
    tensor on any device, as the port's and the reference's
    ``HorizonProfile`` and ``VolumeHorizonProfile`` do."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ensure_dir(results_dir)
    cum = profile.cum_spread
    cum = np.asarray(cum.cpu() if hasattr(cum, "cpu") else cum, dtype=float)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    if cum.ndim == 1:
        ax.plot(np.arange(1, len(cum) + 1), cum, color=_LINE, linewidth=2)
    else:
        from csmom_tpu_torch.analytics.tables import tercile_labels

        V = cum.shape[0]
        labels = tercile_labels(V)
        for v in range(V):
            ax.plot(np.arange(1, cum.shape[1] + 1), cum[v], linewidth=2,
                    label=labels[v])
        ax.legend(frameon=False, labelcolor=_INK)
    ax.axhline(0.0, color=_GRID, linewidth=1)
    ax.set_title("Event-time cumulative momentum spread", color=_INK)
    ax.set_xlabel("months since formation", color=_INK)
    ax.set_ylabel("cumulative spread", color=_INK)
    ax.grid(True, color=_GRID, linewidth=0.6)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.tick_params(colors=_INK)
    fig.tight_layout()
    out_path = os.path.join(results_dir, fname)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def save_trades_csv(trades_df, results_dir: str, fname: str = "trades.csv") -> str:
    """Write the trade log with the reference demo's exact header
    (datetime,ticker,size,price,impact,score)."""
    ensure_dir(results_dir)
    cols = ["datetime", "ticker", "size", "price", "impact", "score"]
    out = os.path.join(results_dir, fname)
    trades_df.loc[:, cols].to_csv(out, index=False)
    return out
