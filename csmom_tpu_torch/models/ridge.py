"""Closed-form ridge regression with expanding-window time-series CV.

Counterpart of :mod:`csmom_tpu.models.ridge`: a StandardScaler fit on the
training block, sklearn ``TimeSeriesSplit(n_splits)`` expanding folds
collecting per-fold MSE, and a final ``Ridge(alpha)`` refit, with the
whole history scored.  With 5 features the normal equations are a 6x6
solve; every reduction is a masked product over the padded ``[A, R, F]``
feature tensor, and fold membership is index arithmetic on the global row
ordinal (the position each valid row takes in the reference's
sort-by-(ticker, datetime) flattening), so the folds are masks.  Nothing
in the fit waits on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RidgeFit:
    coef: torch.Tensor        # f[F] on scaled features
    intercept: torch.Tensor   # f[] scalar
    scale_mean: torch.Tensor  # f[F] scaler mean (ddof=0 std below)
    scale_std: torch.Tensor   # f[F]
    cv_mse: torch.Tensor      # f[n_splits]
    scores: torch.Tensor      # f[A, R] predictions over every valid row
    n_train: torch.Tensor     # i32 number of training rows

    @classmethod
    def from_numpy(cls, device=None, **arrays):
        """A fit from numpy arrays (a ``csmom_tpu`` fit's fields, read
        with ``np.asarray``), as tensors on ``device`` (cuda by default;
        raises without a card unless ``device="cpu"``)."""
        return cls(**_tensors(arrays, device))


def _tensors(arrays, device):
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in arrays.items()}


def _masked_ridge(Xs, y, w, alpha):
    """Solve Ridge(alpha, fit_intercept=True) over rows weighted by w (0/1).

    Returns (coef f[F], intercept f[]).
    """
    n = torch.clamp(torch.sum(w), min=1.0)
    xbar = (w @ Xs) / n
    ybar = torch.sum(w * y) / n
    Xc = (Xs - xbar) * w[:, None]
    yc = (y - ybar) * w
    G = Xc.T @ Xc + alpha * torch.eye(Xs.shape[1], dtype=Xs.dtype, device=Xs.device)
    b = Xc.T @ yc
    # solve_ex: no check of the factorization's info, so no wait on the host
    coef = torch.linalg.solve_ex(G, b).result
    intercept = ybar - xbar @ coef
    return coef, intercept


def _linear_predict(params, Xs):
    return Xs @ params[0] + params[1]


def time_series_cv_harness(
    features,
    y,
    valid,
    solver,
    n_splits: int,
    train_frac: float,
    train_frac_small: float,
    small_threshold: int,
    predict=None,
):
    """Shared prepare -> scale -> expanding-CV -> final-fit -> score harness.

    Flattens to the global (ticker, datetime) row order, trains on the
    leading ``train_frac`` of valid rows (``train_frac_small`` at or below
    ``small_threshold`` rows), fits the scaler on that block, runs
    ``TimeSeriesSplit``-layout expanding folds, refits on the whole block
    and scores the entire history.

    ``solver(Xs, yf, w)`` fits one model on rows weighted by w (0/1);
    ``predict(params, Xs)`` maps its parameters to per-row predictions
    (default: ``(coef f[F], intercept f[])``, the linear case).

    Returns ``(params, mean, std, cv_mse, scores, n_train, train_w)``;
    ``train_w f[A*R]`` is the final fit's 0/1 row weights.

    ``n_train = floor(n_total * frac)`` is computed in the features'
    dtype, as the JAX package computes it in its default float type.
    """
    if predict is None:
        predict = _linear_predict
    A, R, F = features.shape
    dt = features.dtype
    Xf = torch.nan_to_num(features.reshape(A * R, F))
    yf = torch.nan_to_num(y.reshape(A * R))
    vf = valid.reshape(A * R)

    # global row ordinal in (asset, row) order == reference row order
    ordinal = torch.cumsum(vf, 0) - 1
    n_total = torch.sum(vf)
    frac = torch.where(n_total > small_threshold,
                       torch.tensor(train_frac, dtype=dt, device=vf.device),
                       torch.tensor(train_frac_small, dtype=dt, device=vf.device))
    n_train = torch.floor(n_total.to(dt) * frac).to(torch.int32)
    train = vf & (ordinal < n_train)

    # scaler fit on the training block only
    w_tr = train.to(dt)
    n_tr = torch.clamp(torch.sum(w_tr), min=1.0)
    mean = (w_tr @ Xf) / n_tr
    var = (w_tr @ (Xf - mean) ** 2) / n_tr
    std = torch.sqrt(var)
    # sklearn maps zero-variance features to scale 1; compare relative to
    # the feature's magnitude, as float accumulation leaves ~eps**2
    tiny = 1e-12 * torch.clamp(torch.abs(mean), min=1.0)
    std = torch.where(std > tiny, std, 1.0)
    Xs = (Xf - mean) / std

    # sklearn TimeSeriesSplit over the n_train training rows
    test_size = torch.div(n_train, n_splits + 1, rounding_mode="floor")

    def fold(i):
        test_start = n_train - (n_splits - i) * test_size
        tr = train & (ordinal < test_start)
        te = train & (ordinal >= test_start) & (ordinal < test_start + test_size)
        params = solver(Xs, yf, tr.to(dt))
        pred = predict(params, Xs)
        wte = te.to(dt)
        return torch.sum(wte * (pred - yf) ** 2) / torch.clamp(torch.sum(wte), min=1.0)

    cv_mse = torch.stack([fold(i) for i in range(n_splits)])

    params = solver(Xs, yf, w_tr)
    scores = predict(params, Xs).reshape(A, R)
    scores = torch.where(valid, scores, torch.nan)
    return params, mean, std, cv_mse, scores, n_train, w_tr


def ridge_time_series_cv(
    features,
    y,
    valid,
    n_splits: int = 3,
    alpha: float = 1.0,
    train_frac: float = 0.7,
    train_frac_small: float = 0.6,
    small_threshold: int = 100,
) -> RidgeFit:
    """Scale -> expanding-window CV -> final ridge -> score full history.

    Args:
      features: f[A, R, F] compacted feature tensor (padded rows arbitrary).
      y: f[A, R] next-row return labels.
      valid: bool[A, R] modeling rows (features and label all defined).
      n_splits: CV folds.
      alpha: ridge penalty.
      train_frac: leading fraction of rows used for training (the
        reference trains on the first 70%, 60% at or below 100 rows, in
        (ticker, datetime) order and scores everything).
    """
    (coef, icept), mean, std, cv_mse, scores, n_train, _ = time_series_cv_harness(
        features, y, valid,
        solver=lambda Xs, yf, w: _masked_ridge(Xs, yf, w, alpha),
        n_splits=n_splits, train_frac=train_frac,
        train_frac_small=train_frac_small, small_threshold=small_threshold,
    )
    return RidgeFit(coef=coef, intercept=icept, scale_mean=mean, scale_std=std,
                    cv_mse=cv_mse, scores=scores, n_train=n_train)
