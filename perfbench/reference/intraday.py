"""Plain reference of the intraday pipeline, in PyTorch on the CPU.

From compacted minute bars (each name's observed bars in minute order,
as the benchmark's generator lays them out) it works out again, name by
name and by formulations of its own:

- the five minute features over each name's observed rows: the 1-minute
  return, its trailing 5-row sum, the trailing ``window``-row volume sum
  and tick-rule signed volume sum, and the volume sum's z-score against
  its trailing 60-row mean and sample std (1 where that std is
  undefined), each window a direct ``unfold`` over the rows, not a
  difference of prefix sums;
- the next-row return label; the modeling rows are every row with all
  features and the label defined (a name's rows 1 to n-2);
- the training block, the leading ``train_frac`` of modeling rows in
  (name, minute) order (0.6 at or below 100 rows), and its
  population-std scaler (scale 1 for a constant feature);
- sklearn ``TimeSeriesSplit(n_splits)``'s expanding folds as explicit
  index ranges, each a ridge fit with intercept, by least squares on the
  centred design stacked over ``sqrt(alpha) * I`` (``torch.linalg.lstsq``,
  not normal equations), and its test MSE; then the final fit on the
  whole block and the scores of every modeling row;
- the scores, prices and modeling-row mask on the dense minute axis, and
  the event backtest with its cost attribution by
  :func:`perfbench.reference.event.backtest`, unchanged.

``dtype`` is the precision of every step: float64 for the reference,
float32 for the control.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import event

N_FEATURES = 5
# at or below this many modeling rows the training block is this share
SMALL_BLOCK, SMALL_TRAIN_FRAC = 100, 0.6


def _windows(x, w: int):
    """``[n] -> [n, w]``: the ``w`` rows ending at each row, NaN before the
    series' start."""
    pad = torch.full((w - 1,), torch.nan, dtype=x.dtype)
    return torch.cat([pad, x]).unfold(0, w, 1)


def name_features(p, v, window: int):
    """The features ``f[n, 5]`` of one name's ``n`` observed bars (row 0's
    are NaN: it has no return)."""
    nan = torch.full((1,), torch.nan, dtype=p.dtype)
    ret_1m = torch.cat([nan, p[1:] / p[:-1] - 1.0])
    w5 = _windows(ret_1m, 5)
    ret_5m = torch.where(torch.isnan(w5).all(dim=1), torch.nan, torch.nansum(w5, dim=1))
    tick = torch.cat([torch.zeros(1, dtype=p.dtype), torch.sign(p[1:] - p[:-1])])
    vol_roll = torch.nansum(_windows(v, window), dim=1)
    signed_roll = torch.nansum(_windows(tick * v, window), dim=1)

    w60 = _windows(vol_roll, 60)
    seen = ~torch.isnan(w60)
    k = seen.sum(dim=1).to(p.dtype)
    mean = torch.nansum(w60, dim=1) / k
    dev = torch.where(seen, w60 - mean[:, None], 0.0)
    std = torch.sqrt((dev * dev).sum(dim=1) / (k - 1.0).clamp(min=1.0))
    std = torch.where(k > 1.0, std, 1.0)
    zscore = (vol_roll - mean) / std
    return torch.stack([ret_1m, ret_5m, vol_roll, zscore, signed_roll], dim=1)


def ridge(X, y, alpha: float):
    """Ridge with intercept on rows ``X f[m, F]``, ``y f[m]``: least squares
    of the centred design stacked over ``sqrt(alpha) * I`` against the
    centred labels over zeros.  Returns ``(coef f[F], intercept f[])``."""
    F = X.shape[1]
    xm, ym = X.mean(dim=0), y.mean()
    design = torch.cat([X - xm, math.sqrt(alpha) * torch.eye(F, dtype=X.dtype)])
    target = torch.cat([y - ym, torch.zeros(F, dtype=X.dtype)])
    coef = torch.linalg.lstsq(design, target[:, None]).solution[:, 0]
    return coef, ym - xm @ coef


def fit(price, volume, row_valid, time_idx, n_minutes: int, window: int,
        n_splits: int, alpha: float, train_frac: float, dtype=torch.float64):
    """Features, label, scaler, folds, fit and scores from the compacted
    panels (CPU tensors; ``price`` and ``volume`` are read in ``dtype``).

    Returns a dict: ``features f[A, R, 5]`` (NaN off each name's rows 1 to
    n-1), ``label f[A, R]`` and ``valid bool[A, R]`` (the modeling rows),
    ``n_train``, ``mean`` and ``std f[5]`` (the scaler), ``folds`` (each
    fold's ``(coef, intercept)``), ``cv_mse f[n_splits]``, ``coef f[5]``,
    ``intercept``, ``scores f[A, R]`` (NaN off the modeling rows), and on
    the dense minute axis ``[A, n_minutes]``: ``dense_score`` (0 off the
    modeling rows), ``dense_price`` (NaN there) and ``dense_valid``.
    """
    A, R = price.shape
    counts = row_valid.sum(dim=1).tolist()
    features = torch.full((A, R, N_FEATURES), torch.nan, dtype=dtype)
    label = torch.full((A, R), torch.nan, dtype=dtype)
    valid = torch.zeros((A, R), dtype=torch.bool)
    Xs, ys = [], []
    for a in range(A):
        n = counts[a]
        if n == 0:
            continue
        p = price[a, :n].to(dtype)
        f = name_features(p, volume[a, :n].to(dtype), window)
        features[a, 1:n] = f[1:]
        label[a, 1:n - 1] = p[2:] / p[1:-1] - 1.0
        valid[a, 1:n - 1] = True
        Xs.append(f[1:n - 1])
        ys.append(label[a, 1:n - 1])
    X, y = torch.cat(Xs), torch.cat(ys)
    N = X.shape[0]

    frac = torch.tensor(train_frac if N > SMALL_BLOCK else SMALL_TRAIN_FRAC, dtype=dtype)
    n_train = int(torch.floor(torch.tensor(N, dtype=dtype) * frac))
    mean = X[:n_train].mean(dim=0)
    std = X[:n_train].std(dim=0, correction=0)
    std = torch.where(std > 0, std, 1.0)
    Z = (X - mean) / std

    test_size = n_train // (n_splits + 1)
    folds, cv_mse = [], []
    for i in range(n_splits):
        start = n_train - (n_splits - i) * test_size
        coef, b = ridge(Z[:start], y[:start], alpha)
        folds.append((coef, b))
        err = Z[start:start + test_size] @ coef + b - y[start:start + test_size]
        cv_mse.append((err * err).mean())
    coef, b = ridge(Z[:n_train], y[:n_train], alpha)
    s = Z @ coef + b

    scores = torch.full((A, R), torch.nan, dtype=dtype)
    scores[valid] = s
    dense_score = torch.zeros((A, n_minutes), dtype=dtype)
    dense_price = torch.full((A, n_minutes), torch.nan, dtype=dtype)
    dense_valid = torch.zeros((A, n_minutes), dtype=torch.bool)
    names = torch.arange(A)[:, None].expand(A, R)[valid]
    minutes = time_idx[valid].long()
    dense_score[names, minutes] = s
    dense_price[names, minutes] = price[valid].to(dtype)
    dense_valid[names, minutes] = True
    return {"features": features, "label": label, "valid": valid,
            "n_train": n_train, "mean": mean, "std": std, "folds": folds,
            "cv_mse": torch.stack(cv_mse), "coef": coef, "intercept": b,
            "scores": scores, "dense_score": dense_score,
            "dense_price": dense_price, "dense_valid": dense_valid}


def pipeline(price, volume, row_valid, time_idx, n_minutes: int, adv, vol,
             window: int, n_splits: int, alpha: float, train_frac: float,
             size_shares: int, threshold: float, cash0: float, spread: float,
             dtype=torch.float64):
    """:func:`fit`, then the threshold engine and its costs
    (:func:`perfbench.reference.event.backtest`) on the dense panels.
    Returns :func:`fit`'s dict updated with the backtest's."""
    out = fit(price, volume, row_valid, time_idx, n_minutes, window, n_splits,
              alpha, train_frac, dtype=dtype)
    out.update(event.backtest(out["dense_price"], out["dense_valid"],
                              out["dense_score"], adv, vol, "threshold",
                              {"threshold": threshold}, size_shares, cash0,
                              spread, dtype=dtype))
    return out
