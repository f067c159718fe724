"""Rank-mode decile labels without a sort: radix-histogram selection of the
bin boundaries.

Counterpart of :mod:`csmom_tpu.parallel.histrank`, single-device form
(``axis_name=None``: the reference's collectives are identities there).
A lane's rank-mode label is fixed by the B-1 order statistics at 1-based
ranks ``ceil(k*n/B)`` (``ops.ranking._rank_labels``); each is found by
radix selection over the sortable bit keys, ``nbits / bits_per_round``
rounds of counts (no sort).  Ties at a boundary resolve by lane
position, as the stable sort does, so the labels equal
``decile_assign_panel(mode="rank")`` bit for bit, whatever the digit
width.

The port's keys are signed int64 in the reference's order
(``ops.ranking.sortable_bits``); the selection walks their range from
the smallest key of the width up.  The collective (asset-sharded) form
waits for the port's multi-GPU layer.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.ops.ranking import sortable_bits

__all__ = ["histogram_rank_labels"]


def _hist_rank_rows(x, valid, n_bins: int, bits_per_round: int):
    """Rows ``[R, A]`` -> rank-mode labels ``i32[R, A]`` (-1 invalid).

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
    R, A = x.shape
    dev = x.device
    key, nbits = sortable_bits(x, valid)
    if nbits % bits_per_round:
        raise ValueError(f"bits_per_round={bits_per_round} must divide {nbits}")
    E = n_bins - 1
    n = valid.sum(dim=-1)                                           # [R]
    ks = torch.arange(1, n_bins, device=dev)
    r_k = (ks[None, :] * n[:, None] + n_bins - 1) // n_bins         # [R, E]

    def count_below(t):                                             # t: [R, E]
        return (key[:, None, :] < t[:, :, None]).sum(dim=-1)

    # the smallest key of the width; the selection adds each digit to it
    v = torch.full((R, E), -(1 << (nbits - 1)), dtype=torch.int64, device=dev)
    for t in range(nbits // bits_per_round):
        shift = nbits - (t + 1) * bits_per_round
        digit = torch.zeros_like(v)
        for b in range(1, 1 << bits_per_round):
            # b << shift as a wrapped int64 (the true threshold fits)
            off = ((b << shift) + (1 << 63)) % (1 << 64) - (1 << 63)
            digit += count_below(v + off) < r_k
        v = v + (digit << shift)

    # v is each boundary's key; its lane is the (r - #below)-th equal key
    # by position, the stable sort's tie rule
    need = r_k - count_below(v)
    pos = torch.arange(A, device=dev)
    b_lane = torch.empty_like(v)
    for e in range(E):
        eq = key == v[:, e:e + 1]
        ceq = torch.cumsum(eq, dim=-1, dtype=torch.int32)
        match = eq & (ceq == need[:, e:e + 1])
        b_lane[:, e] = torch.where(match, pos, 0).sum(dim=-1)
    labels = torch.zeros((R, A), dtype=torch.int32, device=dev)
    for e in range(E):
        ve, be = v[:, e:e + 1], b_lane[:, e:e + 1]
        labels += (key > ve) | ((key == ve) & (pos[None, :] >= be))
    return torch.where(valid, labels, -1)


def histogram_rank_labels(x_l, valid_l, n_bins: int, axis_name=None,
                          bits_per_round: int = 4):
    """Rank-mode decile labels of an ``[A, M]`` panel by radix selection:
    ``labels i32[A, M]`` (-1 at invalid lanes), equal to
    ``decile_assign_panel(x_l, valid_l, mode="rank")``.

    Only the single-device form (``axis_name=None``) is ported.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "the collective (asset-sharded) form of histogram_rank_labels is "
            "not ported yet; call it with axis_name=None"
        )
    labels = _hist_rank_rows(x_l.transpose(0, 1), valid_l.transpose(0, 1),
                             n_bins, bits_per_round)
    return labels.transpose(0, 1).contiguous()
