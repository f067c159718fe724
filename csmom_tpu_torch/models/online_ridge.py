"""Online (recursive) ridge: strictly-causal walk-forward scores.

Counterpart of :mod:`csmom_tpu.models.online_ridge`: every row t is
scored by a model fit only on rows seen before t, by rank-1
Sherman–Morrison updates of the regularized inverse Gram,

    P_t = P_{t-1} - (P_{t-1} x_t x_t^T P_{t-1}) / (1 + x_t^T P_{t-1} x_t)
    b_t = b_{t-1} + x_t y_t            =>   w_t = P_t b_t

with ``P_0 = I/alpha``; the intercept is an augmented column penalized by
the same alpha.  With ``standardize=True`` each row is scaled by the
running (Welford) mean and std of the rows before it.

The walk is row-blocked: at row r every asset's row is scored with the
state from rows < r, and only then do row r's (x, y) pairs update it, one
asset at a time in asset order (scoring asset B after updating with
asset A's row r would leak the r -> r+1 return).  The order of the
updates and their expressions are the reference's, so the rounding is
too; that makes the walk R sequential steps of small tensor operations,
each launched from the host with nothing waiting on the device.
``cv_mse[i]`` is the mean squared one-step-ahead error over the i-th of
``n_splits`` contiguous blocks of scored rows.  Masked rows
(``valid == False``) neither update the state nor receive a score.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.models.ridge import _tensors


@dataclasses.dataclass(frozen=True)
class OnlineRidgeFit:
    coef: torch.Tensor        # f[F] final weights on (causally) scaled features
    intercept: torch.Tensor   # f[] final augmented-intercept weight
    scale_mean: torch.Tensor  # f[F] final running mean (causal scaler state)
    scale_std: torch.Tensor   # f[F] final running std
    cv_mse: torch.Tensor      # f[n_splits] prequential MSE per contiguous block
    scores: torch.Tensor      # f[A, R] strictly-causal one-step-ahead predictions
    n_train: torch.Tensor     # i32 rows ever updated on (== n valid rows)

    @classmethod
    def from_numpy(cls, device=None, **arrays):
        """A fit from numpy arrays (a ``csmom_tpu`` fit's fields), as
        tensors on ``device`` (cuda by default; raises without a card
        unless ``device="cpu"``)."""
        return cls(**_tensors(arrays, device))


def _causal_std(cnt, M2):
    std = torch.sqrt(torch.clamp(M2 / torch.clamp(cnt, min=1.0), min=1e-24))
    return torch.where(std > 1e-12, std, 1.0)


def _causal_scale(X, cnt, mean, M2, standardize: bool):
    """Scale a row's features by the moments of rows strictly before it."""
    if not standardize:
        return X
    return (X - mean) / _causal_std(cnt, M2)


def _dot(x, y):
    """``x @ y`` of two short vectors as the reference's compiled scan
    rounds it: a chain of fused multiply-adds in index order (a BLAS dot
    sums in another order, which the ill-conditioned inverse Gram of
    unscaled features amplifies)."""
    xs, ys = x.unbind(0), y.unbind(0)
    acc = xs[0] * ys[0]
    for xj, yj in zip(xs[1:], ys[1:]):
        acc = torch.addcmul(acc, xj, yj)
    return acc


def _row_sm_update(P, b, Xa, yt, w):
    """Fold one row's per-asset rank-1 Sherman-Morrison updates (masked),
    asset by asset; ``b``'s sum is one fused multiply-add, as the
    reference's compiled scan contracts it."""
    # w=0 zeroes an asset's update exactly (Px=0, denom=1)
    for xw, y in zip((Xa * w[:, None]).unbind(0), yt.unbind(0)):
        Px = P @ xw
        P = P - torch.outer(Px, Px) / (1.0 + _dot(xw, Px))
        b = torch.addcmul(b, xw, y)
    return P, b


def _row_moment_update(cnt, mean, M2, X, w):
    """Fold one row's per-asset Welford updates on the RAW features."""
    for x, wa in zip(X.unbind(0), w.unbind(0)):
        cnt2 = cnt + wa
        wd = wa * (x - mean)
        mean2 = mean + wd / torch.clamp(cnt2, min=1.0)
        M2 = torch.addcmul(M2, wd, x - mean2)
        cnt, mean = cnt2, mean2
    return cnt, mean, M2


def _make_row_step(A: int, dt, burn_in: int, standardize: bool):
    """The per-row step: score the whole row with the prior state, then
    apply the row's updates.  Carry: ``(P, b, cnt, mean, M2)``."""
    def step(carry, X, yt, w):
        P, b, cnt, mean, M2 = carry
        Xs = _causal_scale(X, cnt, mean, M2, standardize)
        Xa = torch.cat([Xs, torch.ones((A, 1), dtype=dt, device=X.device)], dim=1)
        preds = Xa @ (P @ b)
        P_new, b_new = _row_sm_update(P, b, Xa, yt, w)
        cnt_new, mean_new, M2_new = _row_moment_update(cnt, mean, M2, X, w)
        seen_enough = cnt >= burn_in  # prior count: the model behind preds
        return (P_new, b_new, cnt_new, mean_new, M2_new), preds, seen_enough

    return step


def _prequential_fit(preds, seen, wr, yr, n_splits: int, w_final, cnt, mean, M2
                     ) -> OnlineRidgeFit:
    """Assemble OnlineRidgeFit from the walk's outputs and final state.

    ``preds/seen/wr/yr`` are time-major ``[R, A]``; ``w_final`` the final
    augmented weights; ``(cnt, mean, M2)`` the final raw-feature moments.
    """
    R, A = preds.shape
    dt = preds.dtype
    F = mean.shape[0]

    scored = (wr > 0) & seen  # bool[R, A]
    preds = torch.where(scored, preds, torch.nan)
    scores = preds.transpose(0, 1)

    scored_f = scored.reshape(R * A)
    yf = yr.reshape(R * A)
    preds_f = preds.reshape(R * A)
    ordinal = torch.cumsum(scored_f, 0) - 1
    n_scored = torch.sum(scored_f)
    block = torch.clamp(
        torch.div(ordinal * n_splits, torch.clamp(n_scored, min=1), rounding_mode="floor"),
        max=n_splits - 1)
    err2 = torch.where(scored_f, (torch.nan_to_num(preds_f) - yf) ** 2, 0.0)

    def block_mse(i):
        wb = (scored_f & (block == i)).to(dt)
        return torch.sum(wb * err2) / torch.clamp(torch.sum(wb), min=1.0)

    cv_mse = torch.stack([block_mse(i) for i in range(n_splits)])
    return OnlineRidgeFit(
        coef=w_final[:F], intercept=w_final[F], scale_mean=mean,
        scale_std=_causal_std(cnt, M2), cv_mse=cv_mse, scores=scores.contiguous(),
        n_train=torch.sum(wr).to(torch.int32),
    )


def online_ridge_scores(
    features,
    y,
    valid,
    alpha: float = 1.0,
    n_splits: int = 3,
    burn_in: int = 30,
    standardize: bool = True,
) -> OnlineRidgeFit:
    """Walk-forward ridge scores for every valid row.

    Args:
      features: f[A, R, F] compacted feature tensor (padded rows arbitrary).
      y: f[A, R] next-row return labels.
      valid: bool[A, R] modeling rows.
      alpha: ridge penalty (applies to the augmented intercept too).
      n_splits: number of contiguous prequential-MSE blocks reported.
      burn_in: rows that must have updated the state before scores start.
      standardize: causally standardize features by prior running moments.

    Returns OnlineRidgeFit; ``scores[a, r]`` used none of row (a, r) itself
    nor any row at a later step.
    """
    A, R, F = features.shape
    dt = features.dtype
    dev = features.device
    Xr = torch.nan_to_num(features.transpose(0, 1)).contiguous()  # f[R, A, F]
    yr = torch.nan_to_num(y.transpose(0, 1)).contiguous()         # f[R, A]
    wr = valid.transpose(0, 1).to(dt).contiguous()                # f[R, A]

    carry = (
        torch.eye(F + 1, dtype=dt, device=dev) / torch.tensor(alpha, dtype=dt, device=dev),
        torch.zeros(F + 1, dtype=dt, device=dev),
        torch.zeros((), dtype=dt, device=dev),
        torch.zeros(F, dtype=dt, device=dev),
        torch.zeros(F, dtype=dt, device=dev),
    )
    step = _make_row_step(A, dt, burn_in, standardize)
    preds = torch.empty((R, A), dtype=dt, device=dev)
    seen = torch.empty((R,), dtype=torch.bool, device=dev)
    for r in range(R):
        carry, preds[r], seen[r] = step(carry, Xr[r], yr[r], wr[r])
    P, b, cnt, mean, M2 = carry
    seen = seen[:, None].expand(R, A)
    return _prequential_fit(preds, seen, wr, yr, n_splits, P @ b, cnt, mean, M2)
