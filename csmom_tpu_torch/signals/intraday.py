"""Intraday minute-bar features.

Counterpart of :mod:`csmom_tpu.signals.intraday`: per ticker sorted by
time — the 1-minute return, its rolling-5 sum, tick-rule signed volume,
rolling volume sums, and a volume z-score against rolling-60 moments (a
std of NaN maps to 1).

Every window runs over *observed rows* of a ticker, not calendar minutes:
a ticker missing a minute simply has a shorter series.  So the features
are computed on a **compacted layout** ``[A, R]``: row j of asset a is
a's j-th observed bar, padded to the largest row count, with
``row_valid[a, j] = j < n_rows[a]``.  Windows are then plain trailing
windows over the ``(values, valid)`` pairs of :mod:`~csmom_tpu_torch.ops.rolling`.
``time_idx[A, R]`` maps each row back to the global minute axis for the
event engine.  The compaction is host pandas, done once per dataset; the
features run on the tensors' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.ops.rolling import rolling_mean, rolling_std, rolling_sum


@dataclasses.dataclass(frozen=True)
class CompactMinutePanel:
    """Per-asset compacted minute bars + mapping to the global minute axis."""

    price: np.ndarray     # f[A, R]
    volume: np.ndarray    # f[A, R]
    time_idx: np.ndarray  # i32[A, R] global minute index of each row
    row_valid: np.ndarray # bool[A, R]
    tickers: tuple
    times: np.ndarray     # datetime64[T] global minute axis (union)

    @property
    def n_rows(self):
        return self.row_valid.sum(axis=1)


def compact_minutes(df, tickers=None) -> CompactMinutePanel:
    """Long intraday frame -> compacted per-asset row layout.

    ``df`` columns: datetime, ticker, price, volume (canonical intraday
    schema).  Host-side; runs once per dataset.
    """
    if tickers is None:
        tickers = sorted(df["ticker"].unique())
    times = np.sort(df["datetime"].unique())

    groups = {t: g.sort_values("datetime") for t, g in df.groupby("ticker")}
    R = max((len(g) for g in groups.values()), default=0)
    A = len(tickers)
    price = np.full((A, R), np.nan)
    volume = np.full((A, R), np.nan)
    time_idx = np.zeros((A, R), dtype=np.int32)
    row_valid = np.zeros((A, R), dtype=bool)
    for a, t in enumerate(tickers):
        g = groups.get(t)
        if g is None:
            continue
        n = len(g)
        price[a, :n] = g["price"].values
        volume[a, :n] = g["volume"].values
        time_idx[a, :n] = np.searchsorted(times, g["datetime"].values)
        row_valid[a, :n] = True
    return CompactMinutePanel(
        price=price, volume=volume, time_idx=time_idx, row_valid=row_valid,
        tickers=tuple(tickers), times=times,
    )


FEATURE_NAMES = ("ret_1m", "ret_5m", "vol_roll_sum", "vol_zscore", "signed_vol_roll")


def _shifted_valid(valid, shift: int):
    """``valid`` rolled by ``shift`` rows with the wrapped-in column False."""
    out = torch.roll(valid, shift, dims=1)
    out[:, 0 if shift > 0 else -1] = False
    return out


def minute_features(price, volume, row_valid, window: int = 30):
    """All reference minute features over a compacted ``[A, R]`` layout.

    Returns:
      features: f[A, R, 5] in FEATURE_NAMES order.
      feat_valid: bool[A, R] rows where every feature is defined (in
        practice every row but each asset's first, where ret_1m is NaN).
    """
    prev_p = torch.roll(price, 1, dims=1)
    ret_valid = row_valid & _shifted_valid(row_valid, 1)
    ret_1m = torch.where(
        ret_valid, price / torch.where(ret_valid, prev_p, 1.0) - 1.0, torch.nan)

    ret_5m, ret5_valid = rolling_sum(ret_1m, ret_valid, 5, 1)

    # tick rule: sign of the price change, 0 on the first row; the zero IS
    # a valid observation for the rolling sum
    tick = torch.where(ret_valid, torch.sign(price - prev_p), 0.0)
    signed_vol = torch.where(row_valid, torch.nan_to_num(tick * volume), torch.nan)

    vol_roll, _ = rolling_sum(volume, row_valid, window, 1)
    signed_roll, _ = rolling_sum(signed_vol, row_valid, window, 1)

    v_mean, _ = rolling_mean(vol_roll, row_valid, 60, 1)
    v_std, v_std_valid = rolling_std(vol_roll, row_valid, 60, 1, ddof=1)
    v_std = torch.where(v_std_valid, v_std, 1.0)  # std NaN -> 1.0
    zscore = (vol_roll - v_mean) / v_std

    features = torch.stack([ret_1m, ret_5m, vol_roll, zscore, signed_roll], dim=-1)
    feat_valid = row_valid & ret_valid & ret5_valid
    return features, feat_valid


def next_row_return(price, feat_valid):
    """Training label: next-row return over *surviving* rows.

    Survivors are a contiguous tail per asset (row 0 is the only
    casualty), so the next surviving row is row j+1.  Returns
    ``(y f[A, R], y_valid bool[A, R])``; the last surviving row of each
    asset is invalid.
    """
    nxt_p = torch.roll(price, -1, dims=1)
    y_valid = feat_valid & _shifted_valid(feat_valid, -1)
    y = torch.where(y_valid, nxt_p / torch.where(y_valid, price, 1.0) - 1.0, torch.nan)
    return y, y_valid
