"""Rank-mode decile labels without a sort: radix-histogram selection of the
bin boundaries, on one device or over an asset-sharded mesh.

Counterpart of :mod:`csmom_tpu.parallel.histrank`.  A lane's rank-mode
label is fixed by the B-1 order statistics at 1-based ranks
``ceil(k*n/B)`` (``ops.ranking._rank_labels``); each is found by radix
selection over the sortable bit keys, ``nbits / bits_per_round`` rounds
of counts (no sort).  Ties at a boundary resolve by global lane
position, as the stable sort does, so the labels equal
``decile_assign_panel(mode="rank")`` of the whole panel bit for bit,
whatever the digit width and the shard count.

The port's keys are signed int64 in the reference's order
(``ops.ranking.sortable_bits``); the selection walks their range from
the smallest key of the width up.  Sharded (``axis_name`` given, inside
:func:`~csmom_tpu_torch.parallel.compat.shard_map` with shard i holding
rows ``[i*A_l, (i+1)*A_l)``), each round psums one ``[2**bits - 1, R,
B-1]`` block of counts, so the traffic does not grow with A; the tie
resolution adds one psum, one all_gather of per-shard equal counts and
one psum of the boundary lanes' positions.  With ``axis_name=None``
every collective is the identity.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.ops.ranking import sortable_bits

__all__ = ["histogram_rank_labels"]


def _collectives(axis_name):
    """``(psum, all_gather, shard index)`` along ``axis_name``; the
    identities (shard 0 of 1) without one."""
    if axis_name is None:
        return (lambda v: v), (lambda v: v[None]), 0
    from csmom_tpu_torch.parallel.compat import all_gather, axis_index, psum

    return ((lambda v: psum(v, axis_name)),
            (lambda v: all_gather(v, axis_name)), axis_index(axis_name))


def _hist_rank_rows(x, valid, n_bins: int, bits_per_round: int,
                    axis_name=None):
    """Rows ``[R, A]`` (this shard's lanes) -> rank-mode labels
    ``i32[R, A]`` (-1 invalid) of the rows over every shard's lanes.

    Each round fixes the next ``bits_per_round`` bits of every boundary
    value ``v`` (its 1-based rank ``r`` among the valid keys) from counts
    below thresholds: digit ``d`` is the number of ``b`` in
    ``1 .. 2**bits - 1`` with ``#{key < v + b * 2**shift} < r``.  That is
    the reference's bucket histogram of the candidates in cumulative form,
    with no candidate mask to carry: each threshold is one compare-and-count
    over ``[R, B-1, A]``, so one bit a round counts least: 32 passes for
    float32 keys, 64 for float64.  Invalid lanes hold the largest key,
    above every threshold, and are never counted.
    """
    psum, all_gather, shard = _collectives(axis_name)
    R, A = x.shape
    dev = x.device
    key, nbits = sortable_bits(x, valid)
    if nbits % bits_per_round:
        raise ValueError(f"bits_per_round={bits_per_round} must divide {nbits}")
    E = n_bins - 1
    n = psum(valid.sum(dim=-1))                                     # [R]
    ks = torch.arange(1, n_bins, device=dev)
    r_k = (ks[None, :] * n[:, None] + n_bins - 1) // n_bins         # [R, E]

    def count_below(t):                                             # t: [R, E]
        return (key[:, None, :] < t[:, :, None]).sum(dim=-1)

    # the smallest key of the width; the selection adds each digit to it
    v = torch.full((R, E), -(1 << (nbits - 1)), dtype=torch.int64, device=dev)
    for t in range(nbits // bits_per_round):
        shift = nbits - (t + 1) * bits_per_round
        # b << shift as a wrapped int64 (the true threshold fits)
        offs = [((b << shift) + (1 << 63)) % (1 << 64) - (1 << 63)
                for b in range(1, 1 << bits_per_round)]
        counts = psum(torch.stack([count_below(v + off) for off in offs]))
        digit = (counts < r_k[None]).sum(dim=0)
        v = v + (digit << shift)

    # v is each boundary's key; its lane is the (r - #below)-th equal key
    # by global position, the stable sort's tie rule: this shard holds
    # it when that index falls among its own equal keys
    need = r_k - psum(count_below(v))                               # [R, E]
    gpos = shard * A + torch.arange(A, device=dev)
    eq = key[:, None, :] == v[:, :, None]                           # [R, E, A]
    loc_eq = eq.sum(dim=-1)                                         # [R, E]
    g_eq = all_gather(loc_eq)                                       # [n_sh, R, E]
    local_j = need - g_eq[:shard].sum(dim=0)
    ceq = torch.cumsum(eq, dim=-1, dtype=torch.int64)
    match = eq & (ceq == local_j[:, :, None])
    b_lane = psum(torch.where(match, gpos, 0).sum(dim=-1))          # [R, E]
    labels = torch.zeros((R, A), dtype=torch.int32, device=dev)
    for e in range(E):
        ve, be = v[:, e:e + 1], b_lane[:, e:e + 1]
        labels += (key > ve) | ((key == ve) & (gpos[None, :] >= be))
    return torch.where(valid, labels, -1)


def histogram_rank_labels(x_l, valid_l, n_bins: int, axis_name=None,
                          bits_per_round: int = 4):
    """Rank-mode decile labels of ``[..., A, M]`` panels by radix
    selection: ``labels i32[..., A, M]`` (-1 at invalid lanes), equal to
    ``decile_assign_panel(x_l, valid_l, mode="rank")``.

    With ``axis_name`` (inside ``shard_map``, the asset axis split over
    that mesh axis) ``x_l``/``valid_l`` are this shard's rows and the
    labels are this shard's rows of the whole panel's labels.
    """
    A, M = x_l.shape[-2:]
    lead = x_l.shape[:-2]
    rows = x_l.transpose(-1, -2).reshape(-1, A)
    vrows = valid_l.transpose(-1, -2).reshape(-1, A)
    labels = _hist_rank_rows(rows, vrows, n_bins, bits_per_round, axis_name)
    return labels.reshape(*lead, M, A).transpose(-1, -2).contiguous()
