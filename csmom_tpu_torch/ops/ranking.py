"""Cross-sectional decile assignment.

Counterpart of :mod:`csmom_tpu.ops.ranking` for modes ``"qcut"`` (pandas
``qcut(..., duplicates='drop')`` parity) and ``"rank"`` (ordinal-rank
flooring, ties by position).  Each month's cross-section is one
contiguous row: panels ``[..., A, M]`` are ranked as rows ``[..., M, A]``,
so one batched ``torch.sort`` covers every month (and every J of the grid).

Labels are int32 in ``[0, n_bins)`` with ``-1`` for unranked lanes.
"""

from __future__ import annotations

import numpy as np
import torch

_TOP32 = 0x7FFFFFFF
_TOP64 = 0x7FFFFFFFFFFFFFFF


def sortable_bits(x, valid):
    """Monotone float -> int64 key map with the reference's total order.

    The reference maps floats to unsigned keys; torch's unsigned support is
    thin, so this map gives signed int64 keys in the same order: -0.0 is
    folded onto +0.0 first, a negative float's magnitude bits are flipped,
    and invalid lanes take the largest int64, strictly above every valid
    value including ``+inf``.  Returns ``(keys int64, nbits)`` where
    ``nbits`` is the width the keys were formed at (64 for f64, else 32).
    """
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        key = torch.where(b < 0, b ^ _TOP64, b)
        nbits = 64
    else:
        b = x.to(torch.float32).view(torch.int32)
        key = torch.where(b < 0, b ^ _TOP32, b).to(torch.int64)
        nbits = 32
    return torch.where(valid, key, _TOP64), nbits


def _rank_labels(x, valid, n_bins: int):
    """Rows ``[R, A]``: ``floor(pct_rank * n_bins)`` capped at ``n_bins-1``,
    ties by position (``rank(method='first')``), with exact integer
    boundaries: bin k's lowest member sits at 1-based rank ``ceil(k*n/B)``,
    and a lane's label counts the boundary ``(key, position)`` pairs it
    lexicographically dominates."""
    A = x.shape[-1]
    key, _ = sortable_bits(x, valid)
    order = torch.sort(key, dim=-1, stable=True).indices   # invalid lanes last
    n = valid.sum(dim=-1)                                  # [R]
    pos = torch.arange(A, device=x.device)
    labels = torch.zeros(key.shape, dtype=torch.int32, device=x.device)
    for k in range(1, n_bins):
        r_k = (k * n + n_bins - 1) // n_bins               # ceil(k*n/B)
        b = torch.gather(order, -1, (r_k - 1).clamp(0, A - 1)[:, None])
        v = torch.gather(key, -1, b)
        labels += (key > v) | ((key == v) & (pos[None, :] >= b))
    return torch.where(valid, labels, -1)


def _qcut_edges(x, valid, n_bins: int):
    """Rows ``[R, A]`` -> linear-interpolated quantile edges ``[R, B+1]``
    over each row's valid lanes (``np.quantile`` of the compacted vector)."""
    A = x.shape[-1]
    v_sorted = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    n = valid.sum(dim=-1)
    # pandas >= 2.0 routes the linspace probabilities through a lossy
    # percent roundtrip (q*100/100); parity needs the same probabilities
    q = np.linspace(0.0, 1.0, n_bins + 1)
    q = torch.as_tensor((q * 100.0) / 100.0, device=x.device).to(x.dtype)
    nm1 = (n - 1).clamp(min=0)
    pos = q[None, :] * nm1.to(x.dtype)[:, None]
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, nm1[:, None])
    frac = pos - lo.to(x.dtype)
    a = torch.gather(v_sorted, -1, lo.clamp(0, A - 1))
    b = torch.gather(v_sorted, -1, hi.clamp(0, A - 1))
    # numpy's _lerp: switches form at t=0.5 so equal endpoints give exactly
    # that value (anything else splits duplicate edges by one ulp)
    d = b - a
    return torch.where(frac < 0.5, a + d * frac, b - d * (1 - frac))


def _qcut_labels(x, valid, n_bins: int):
    """Rows ``[R, A]`` -> ``(labels i32[R, A], n_bins_effective i32[R])``."""
    edges = _qcut_edges(x, valid, n_bins)                  # [R, B+1]
    # duplicates='drop': keep the first occurrence of each distinct edge
    keep = torch.cat(
        [torch.ones_like(edges[:, :1], dtype=torch.bool),
         edges[:, 1:] != edges[:, :-1]], dim=-1,
    )
    n_edges = keep.sum(dim=-1)
    # searchsorted(side='left') over the kept edges == count of kept edges < x
    idx = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for e in range(n_bins + 1):
        idx += keep[:, e:e + 1] & (edges[:, e:e + 1] < x)
    labels = (idx - 1).clamp(min=0)
    # fewer than 2 distinct edges (constant or single-value cross-section),
    # or no valid lane at all (NaN edges): pandas labels every lane NaN
    qcut_ok = (n_edges >= 2) & (valid.sum(dim=-1) > 0)
    labels = torch.where(qcut_ok[:, None], labels, -1)
    n_eff = torch.where(qcut_ok, n_edges - 1, 0)
    return (torch.where(valid, labels, -1).to(torch.int32),
            n_eff.to(torch.int32))


def _assign_rows(x, valid, n_bins: int, mode: str):
    if mode == "qcut":
        return _qcut_labels(x, valid, n_bins)
    if mode == "rank":
        labels = _rank_labels(x, valid, n_bins)
        n_eff = valid.sum(dim=-1).clamp(max=n_bins).to(torch.int32)
        return labels, n_eff
    if mode == "hist":
        raise NotImplementedError("mode='hist' is not ported yet; use 'rank'")
    raise ValueError(f"unknown mode {mode!r}")


def decile_assign_panel(x, valid, n_bins: int = 10, mode: str = "qcut"):
    """Bins for every date of ``[..., A, M]`` panels.

    Returns ``(labels i32[..., A, M], n_bins_effective i32[..., M])``.
    """
    A, M = x.shape[-2:]
    lead = x.shape[:-2]
    rows = x.transpose(-1, -2).reshape(-1, A)
    vrows = valid.transpose(-1, -2).reshape(-1, A)
    labels, n_eff = _assign_rows(rows, vrows, n_bins, mode)
    labels = labels.reshape(*lead, M, A).transpose(-1, -2).contiguous()
    return labels, n_eff.reshape(*lead, M)
