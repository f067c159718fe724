"""Elastic-net / lasso regression via FISTA, on ridge's CV harness.

Counterpart of :mod:`csmom_tpu.models.elastic_net`.  The smooth part of
the objective reduces to the same masked Gram products as ridge (an FxF
system), the l1 part is a soft-threshold proximal step.  FISTA runs a
fixed number of iterations (no data-dependent stop, so no wait on the
host inside the loop); the step size is the exact Lipschitz constant from
``eigvalsh`` of the FxF Gram.

Objective (sklearn's parameterization):

    (1/2n)||y - Xw - b||^2 + alpha*l1_ratio*||w||_1
                           + (alpha*(1-l1_ratio)/2)*||w||^2
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.models.ridge import RidgeFit, _tensors, time_series_cv_harness


@dataclasses.dataclass(frozen=True)
class ElasticNetFit:
    coef: torch.Tensor        # f[F] on scaled features
    intercept: torch.Tensor   # f[]
    scale_mean: torch.Tensor  # f[F]
    scale_std: torch.Tensor   # f[F]
    cv_mse: torch.Tensor      # f[n_splits]
    scores: torch.Tensor      # f[A, R]
    n_train: torch.Tensor     # i32
    n_nonzero: torch.Tensor   # i32 selected features in the final model

    @classmethod
    def from_numpy(cls, device=None, **arrays):
        """A fit from numpy arrays (a ``csmom_tpu`` fit's fields), as
        tensors on ``device`` (cuda by default; raises without a card
        unless ``device="cpu"``)."""
        return cls(**_tensors(arrays, device))


def _soft(v, t):
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _masked_enet(Xs, y, w, alpha, l1_ratio, n_iter):
    """Elastic net over rows weighted by w (0/1), intercept by centering.

    Returns (coef f[F], intercept f[]).
    """
    n = torch.clamp(torch.sum(w), min=1.0)
    xbar = (w @ Xs) / n
    ybar = torch.sum(w * y) / n
    Xc = (Xs - xbar) * w[:, None]
    yc = (y - ybar) * w

    G = (Xc.T @ Xc) / n                       # FxF smooth Hessian (l2 apart)
    b = (Xc.T @ yc) / n
    l2 = alpha * (1.0 - l1_ratio)
    l1 = alpha * l1_ratio
    L = torch.linalg.eigvalsh(G)[-1] + l2     # exact Lipschitz constant
    step = 1.0 / torch.clamp(L, min=1e-30)

    wk = zk = torch.zeros(Xs.shape[1], dtype=Xs.dtype, device=Xs.device)
    tk = torch.ones((), dtype=Xs.dtype, device=Xs.device)
    for _ in range(n_iter):
        grad = G @ zk - b + l2 * zk
        w_next = _soft(zk - step * grad, step * l1)
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        zk = w_next + ((tk - 1.0) / t_next) * (w_next - wk)
        wk, tk = w_next, t_next
    intercept = ybar - xbar @ wk
    return wk, intercept


def elastic_net_time_series_cv(
    features,
    y,
    valid,
    n_splits: int = 3,
    alpha: float = 1e-4,
    l1_ratio: float = 0.5,
    n_iter: int = 500,
    train_frac: float = 0.7,
    train_frac_small: float = 0.6,
    small_threshold: int = 100,
) -> ElasticNetFit:
    """Scale -> expanding-window CV -> final elastic net -> score everything,
    on :func:`~csmom_tpu_torch.models.ridge.time_series_cv_harness` with the
    ridge solve swapped for the FISTA loop.  ``l1_ratio=1`` is lasso,
    ``l1_ratio=0`` is (iterative) ridge."""
    (coef, icept), mean, std, cv_mse, scores, n_train, _ = time_series_cv_harness(
        features, y, valid,
        solver=lambda Xs, yf, w: _masked_enet(Xs, yf, w, alpha, l1_ratio, n_iter),
        n_splits=n_splits, train_frac=train_frac,
        train_frac_small=train_frac_small, small_threshold=small_threshold,
    )
    return ElasticNetFit(
        coef=coef, intercept=icept, scale_mean=mean, scale_std=std,
        cv_mse=cv_mse, scores=scores, n_train=n_train,
        n_nonzero=torch.sum(coef != 0).to(torch.int32),
    )


def as_ridge_fit(fit: ElasticNetFit) -> RidgeFit:
    """View an elastic-net fit through the RidgeFit schema."""
    return RidgeFit(coef=fit.coef, intercept=fit.intercept,
                    scale_mean=fit.scale_mean, scale_std=fit.scale_std,
                    cv_mse=fit.cv_mse, scores=fit.scores, n_train=fit.n_train)
