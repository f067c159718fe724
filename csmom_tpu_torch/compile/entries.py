"""Shared hot entry points of the warm-up and the benchmarks.

Counterpart of ``csmom_tpu.compile.entries``.  The reference builds one
jitted callable per hot computation so that its benchmarks and its
warm-up lower the same program; here each factory is ``lru_cache``d so
every caller in one process runs one callable, and the warm-up runs
exactly what a benchmark runs.  They run on their inputs' device.

- :func:`grid_scalar_fn`: the J x K grid reduced to one scalar;
- :func:`batched_event_fn`: ``batch`` event backtests summed to one
  scalar.  torch has no ``vmap`` through the event engine, so it is a
  loop of single-panel calls (ROADMAP.md, known difference 10);
- :func:`histrank_labels_fn`: the histogram-rank labels;
- :func:`online_ridge_rows_fn`: the reference's time-sharded online
  ridge scan on one device, on row-major inputs.
"""

from __future__ import annotations

from functools import lru_cache

__all__ = ["batched_event_fn", "grid_scalar_fn", "histrank_labels_fn",
           "online_ridge_rows_fn"]


@lru_cache(maxsize=64)
def grid_scalar_fn(Js: tuple, Ks: tuple, skip: int, mode: str, impl: str):
    """The grid hot entry: the whole J x K backtest summed to one scalar,
    ``fn(prices f[A, M], mask bool[A, M]) -> f[]``.  ``impl`` takes the
    port's names (``kernel`` runs K2)."""
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest

    def grid_scalar(p, v):
        return jk_grid_backtest(p, v, Js, Ks, skip=skip, mode=mode,
                                impl=impl).mean_spread.sum()

    return grid_scalar


@lru_cache(maxsize=8)
def batched_event_fn(batch: int):
    """``batch`` event backtests of one panel under ``batch`` scores,
    their total PnLs summed: ``fn(price, valid, bscore f[batch, A, T],
    adv, vol) -> f[]``.  Each term equals its single call."""
    import torch

    from csmom_tpu_torch.backtest.event import event_backtest

    def batched_event(price, valid, bscore, adv, vol):
        if bscore.shape[0] != batch:
            raise ValueError(f"bscore has {bscore.shape[0]} scores, not {batch}")
        return torch.stack([event_backtest(price, valid, sc, adv, vol).total_pnl
                            for sc in bscore.unbind(0)]).sum()

    return batched_event


@lru_cache(maxsize=8)
def histrank_labels_fn(n_bins: int):
    """Single-device histogram-rank labels, ``fn(x f[A, M], valid
    bool[A, M]) -> i32[A, M]``."""
    from csmom_tpu_torch.parallel.histrank import histogram_rank_labels

    def histrank_labels(x, v):
        return histogram_rank_labels(x, v, n_bins, axis_name=None)

    return histrank_labels


@lru_cache(maxsize=8)
def online_ridge_rows_fn(A: int, F: int, alpha: float, burn_in: int,
                         standardize: bool):
    """The reference's time-sharded online-ridge scan on one device
    (``csmom_tpu.parallel.online_ridge._compiled`` on a one-device mesh):
    ``fn(X f[R, A, F], y f[R, A], w f[R, A]) -> (preds f[R, A], seen
    bool[R, A], G f[F+1, F+1], b f[F+1], (cnt f[1], mean f[1, F], M2
    f[1, F]))``.  With one block the carries into the block are zero, so
    this is the single-device walk of
    :func:`~csmom_tpu_torch.models.online_ridge.online_ridge_scores` plus
    the block's scaled Gram and label sums and its raw-feature moments."""
    import torch

    from csmom_tpu_torch.models.online_ridge import (
        _causal_scale,
        _make_row_step,
        _row_moment_update,
    )

    def online_ridge_rows(X, y, w):
        dt, dev = X.dtype, X.device
        R = X.shape[0]
        step = _make_row_step(A, dt, burn_in, standardize)
        zero_f = torch.zeros(F, dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        ones = torch.ones((A, 1), dtype=dt, device=dev)
        G = torch.zeros((F + 1, F + 1), dtype=dt, device=dev)
        bsum = torch.zeros(F + 1, dtype=dt, device=dev)
        moments = (zero, zero_f, zero_f)
        for r in range(R):  # the scaled Gram of the block, causally scaled
            xw = torch.cat([_causal_scale(X[r], *moments, standardize), ones],
                           dim=1) * w[r][:, None]
            G = G + xw.T @ xw
            bsum = bsum + xw.T @ y[r]
            moments = _row_moment_update(*moments, X[r], w[r])
        carry = (torch.linalg.inv(alpha * torch.eye(F + 1, dtype=dt, device=dev)),
                 zero_f.new_zeros(F + 1), zero, zero_f, zero_f)
        preds = torch.empty((R, A), dtype=dt, device=dev)
        seen = torch.empty((R,), dtype=torch.bool, device=dev)
        for r in range(R):
            carry, preds[r], seen[r] = step(carry, X[r], y[r], w[r])
        # the block's raw-feature moments, merged into the (zero) carry
        cnt_b = w.sum()
        mean_b = torch.einsum("ra,raf->f", w, X) / torch.clamp(cnt_b, min=1.0)
        M2_b = torch.einsum("ra,raf->f", w, (X - mean_b) ** 2)
        n = zero + cnt_b
        mean_f = zero_f + (mean_b - zero_f) * cnt_b / torch.clamp(n, min=1.0)
        M2_f = zero_f + M2_b + (mean_b - zero_f) ** 2 * zero * cnt_b / torch.clamp(n, min=1.0)
        return (preds, seen[:, None].expand(R, A), G, bsum,
                (n[None], mean_f[None], M2_f[None]))

    return online_ridge_rows
