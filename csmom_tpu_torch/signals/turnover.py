"""Turnover features: the Lee–Swaminathan volume leg.

Counterpart of :mod:`csmom_tpu.signals.turnover`: ``adv_est = monthly
volume / 21``; shares outstanding from a per-ticker info map with a
market-cap / price fallback; ``turnover_monthly = adv_est / shares``
(guarded); ``turn_avg`` its rolling ``lookback``-month mean.  These feed
the momentum x volume double sort (LeSw00 Table II) in
:mod:`csmom_tpu_torch.backtest.double_sort` and the volume-conditioned
horizon profile.

Shares outstanding is a host vector ``f[A]``; the panels are tensors and
the features are elementwise ops plus masked rolling means on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.ops.rolling import rolling_mean

TRADING_DAYS_PER_MONTH = 21.0  # the reference's constant


def shares_outstanding_vector(tickers, shares_info: dict, last_price=None):
    """Per-asset shares outstanding from an info map (host, runs once).

    Prefers ``shares_outstanding``; falls back to ``market_cap / price``
    (int-truncated, like the reference) when a positive last price is
    known; NaN otherwise.
    """
    out = np.full(len(tickers), np.nan)
    for i, t in enumerate(tickers):
        info = (shares_info or {}).get(t) or {}
        so = info.get("shares_outstanding")
        if so is not None and not (isinstance(so, float) and np.isnan(so)):
            out[i] = float(so)
            continue
        mcap = info.get("market_cap")
        price = None if last_price is None else last_price[i]
        # a NaN market cap is truthy and int(NaN / price) raises: leave NaN
        try:
            if mcap and price and price > 0 and np.isfinite(mcap):
                out[i] = float(int(mcap / price))
        except (ValueError, OverflowError, TypeError):
            pass
    return out


def turnover_features(monthly_volume, volume_mask, shares_outstanding,
                      lookback: int = 3):
    """adv_est / turnover_monthly / turn_avg panels.

    Args:
      monthly_volume: f[A, M] summed monthly share volume (a tensor).
      volume_mask: bool[A, M] months with at least one daily bar.
      shares_outstanding: f[A] (NaN when unknown), any array.
      lookback: rolling window of ``turn_avg`` (the reference's 3).

    Returns a dict of ``(value, valid)`` tensor pairs.
    """
    adv = monthly_volume / TRADING_DAYS_PER_MONTH
    so = torch.as_tensor(shares_outstanding, device=adv.device).to(adv.dtype)[:, None]
    so_ok = torch.isfinite(so) & (so > 0)
    turn_valid = volume_mask & so_ok
    turn = torch.where(turn_valid, adv / torch.where(so_ok, so, 1.0), torch.nan)
    turn_avg, turn_avg_valid = rolling_mean(turn, turn_valid, lookback, 1)
    return {
        "adv_est": (adv, volume_mask),
        "turnover_monthly": (turn, turn_valid),
        "turn_avg": (turn_avg, turn_avg_valid),
    }


def volume_tercile_labels(turn_avg, turn_valid, n_vol_bins: int = 3,
                          mode: str = "qcut"):
    """Per-date volume-group labels (V1..V3) for the double sort:
    ``(labels i32[..., A, M], n_bins_effective i32[..., M])``."""
    return decile_assign_panel(turn_avg, turn_valid, n_bins=n_vol_bins, mode=mode)
