"""Sequence-parallel online ridge: the walk-forward scan, time-sharded.

Counterpart of :mod:`csmom_tpu.parallel.online_ridge`.  The online ridge
(:mod:`csmom_tpu_torch.models.online_ridge`) is an R-step sequential
walk, but everything it carries is a sum of per-row contributions: the
regularized Gram ``G = sum w x x^T`` and label vector ``b = sum w x y``
add, and the raw-feature scaler moments ``(count, mean, M2)`` merge by
Chan's parallel Welford formula.  So each time shard is seeded with an
exclusive prefix of small block summaries and then walks its own rows:

1. **moment summaries**: each block's ``(count, mean, M2)`` in one
   pass; Chan's fold of the earlier blocks' gives the scaler state the
   block inherits;
2. **scaled Gram**: each block walks its rows from that state,
   accumulating its ``(dG, db)``; their exclusive prefix sum is the Gram
   and label state the block inherits;
3. **the row walk**: each block seeds ``P = inv(alpha I + G)`` (one
   ``(F+1)^2`` inverse a shard) and runs the single-device row step
   (:func:`~csmom_tpu_torch.models.online_ridge._make_row_step`, its
   fused multiply-add order unchanged), scoring every row strictly
   causally.

The scores equal the sequential walk's to rounding (the seeds are sums
in another order), and the final fit solves the full Gram once.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.models.online_ridge import (
    OnlineRidgeFit,
    _causal_scale,
    _make_row_step,
    _prequential_fit,
    _row_moment_update,
)
from csmom_tpu_torch.parallel.compat import all_gather, axis_index, psum, shard_map
from csmom_tpu_torch.parallel.event_time import _exclusive_prefix_sum

__all__ = ["time_sharded_online_ridge_scores"]


def _block_moment_summary(Xb, wb):
    """``(count, mean, M2)`` of this block's valid raw features in one
    pass (``Xb f[R_l, A, F]``, ``wb f[R_l, A]``)."""
    cnt = wb.sum()
    mean = torch.einsum("ra,raf->f", wb, Xb) / torch.clamp(cnt, min=1.0)
    M2 = torch.einsum("ra,raf->f", wb, (Xb - mean) ** 2)
    return cnt, mean, M2


def _chan_merge(state, other):
    """Chan's merge of two ``(count, mean, M2)`` summaries."""
    cnt, mean, M2 = state
    n2, m2, M22 = other
    n = cnt + n2
    delta = m2 - mean
    return (n, mean + delta * n2 / torch.clamp(n, min=1.0),
            M2 + M22 + delta * delta * cnt * n2 / torch.clamp(n, min=1.0))


def _exclusive_moment_carry(cnt_b, mean_b, M2_b, axis_name: str):
    """Chan's fold of every earlier block's summary, in block order."""
    g_cnt = all_gather(cnt_b, axis_name)       # [nb]
    g_mean = all_gather(mean_b, axis_name)     # [nb, F]
    g_M2 = all_gather(M2_b, axis_name)
    state = (torch.zeros_like(cnt_b), torch.zeros_like(mean_b),
             torch.zeros_like(M2_b))
    for j in range(axis_index(axis_name)):
        state = _chan_merge(state, (g_cnt[j], g_mean[j], g_M2[j]))
    return state


def _compiled(mesh, time_axis: str, A: int, F: int, alpha: float,
              burn_in: int, standardize: bool):
    """The sharded walk on ``mesh``: ``fn(X f[R, A, F], y f[R, A], w
    f[R, A]) -> (preds f[R, A], seen bool[R, A], G f[F+1, F+1], b
    f[F+1], (cnt f[n], mean f[n, F], M2 f[n, F]))``, rows split over
    ``time_axis`` (R divisible by its size); ``G``/``b`` are the whole
    history's, and the moments each block's inclusive merge (the last
    block's covers every row)."""

    def block(Xb, yb, wb):
        dt, dev = Xb.dtype, Xb.device
        R_l = Xb.shape[0]
        # phase 1: the scaler state this block inherits
        summary = _block_moment_summary(Xb, wb)
        carry0 = _exclusive_moment_carry(*summary, time_axis)

        # phase 2: this block's scaled Gram and label sums, scaled from
        # the inherited state, as the sequential walk scales them
        ones = torch.ones((A, 1), dtype=dt, device=dev)
        dG = torch.zeros((F + 1, F + 1), dtype=dt, device=dev)
        db = torch.zeros(F + 1, dtype=dt, device=dev)
        moments = carry0
        for r in range(R_l):
            xw = torch.cat([_causal_scale(Xb[r], *moments, standardize), ones],
                           dim=1) * wb[r][:, None]
            dG = dG + xw.T @ xw
            db = db + xw.T @ yb[r]
            moments = _row_moment_update(*moments, Xb[r], wb[r])
        G0 = _exclusive_prefix_sum(dG, time_axis)
        b0 = _exclusive_prefix_sum(db, time_axis)

        # phase 3: the single-device row step from the inherited state;
        # one inverse a shard
        P0 = torch.linalg.inv(alpha * torch.eye(F + 1, dtype=dt, device=dev) + G0)
        step = _make_row_step(A, dt, burn_in, standardize)
        carry = (P0, b0, *carry0)
        preds = torch.empty((R_l, A), dtype=dt, device=dev)
        seen = torch.empty((R_l,), dtype=torch.bool, device=dev)
        for r in range(R_l):
            carry, preds[r], seen[r] = step(carry, Xb[r], yb[r], wb[r])

        G_tot = psum(dG, time_axis)
        b_tot = psum(db, time_axis)
        cnt_f, mean_f, M2_f = _chan_merge(carry0, summary)
        return (preds, seen[:, None].expand(R_l, A), G_tot, b_tot,
                (cnt_f[None], mean_f[None], M2_f[None]))

    spec_x, spec_v = P(time_axis, None, None), P(time_axis, None)
    return shard_map(block, mesh=mesh, in_specs=(spec_x, spec_v, spec_v),
                     out_specs=(spec_v, spec_v, P(), P(),
                                (P(time_axis), P(time_axis, None),
                                 P(time_axis, None))))


def time_sharded_online_ridge_scores(features, y, valid, mesh,
                                     time_axis: str = "time", alpha: float = 1.0,
                                     n_splits: int = 3, burn_in: int = 30,
                                     standardize: bool = True) -> OnlineRidgeFit:
    """The walk-forward ridge of
    :func:`~csmom_tpu_torch.models.online_ridge.online_ridge_scores` with
    its rows split over ``mesh[time_axis]``.  Rows are padded to a
    multiple of the shard count with invalid no-op rows.  The fit is on
    the mesh's first device."""
    A, R, F = features.shape
    dt = features.dtype
    home = mesh.home
    n_shards = mesh.shape[time_axis]
    Xr = torch.nan_to_num(torch.as_tensor(features).transpose(0, 1)).to(home)
    yr = torch.nan_to_num(torch.as_tensor(y).transpose(0, 1)).to(home)
    wr = torch.as_tensor(valid).transpose(0, 1).to(device=home, dtype=dt)
    pad = (-R) % n_shards
    if pad:
        Xr = torch.cat([Xr, Xr.new_zeros((pad, A, F))])
        yr = torch.cat([yr, yr.new_zeros((pad, A))])
        wr = torch.cat([wr, wr.new_zeros((pad, A))])

    fn = _compiled(mesh, time_axis, A, F, float(alpha), int(burn_in),
                   bool(standardize))
    preds, seen, G_tot, b_tot, (cnt, mean, M2) = fn(Xr, yr, wr)
    w_final = torch.linalg.solve(
        alpha * torch.eye(F + 1, dtype=dt, device=home) + G_tot, b_tot)
    return _prequential_fit(preds[:R], seen[:R], wr[:R].contiguous(),
                            yr[:R].contiguous(), n_splits, w_final,
                            cnt[-1], mean[-1], M2[-1])
