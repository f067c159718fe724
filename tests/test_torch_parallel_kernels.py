"""Both kernels' index maps at the shard shapes the sharded engines hand
them (the north star's 3,000 assets over 2, 4 and 8 asset shards; the
grid's Js over 1 or 2 grid shards), emulated in numpy against the plain
versions: K1 by ``test_torch_kernels._k1_emulate``, K2 by a walk of the
blocks, clusters and threads that ``_cohort_plan`` lays out (every label
read once per horizon chunk, every output stored once, the sums and counts
the plain version's).  The sharded engines also pass each shard's inputs
to the kernels contiguous."""

import numpy as np
import pytest
import torch

from csmom_tpu_torch.ops import kernels
from test_torch_kernels import TOL, _k1_emulate

torch.set_num_threads(2)

# the north star's month count; its assets over the asset shards
M_NORTH = 696


@pytest.mark.parametrize("A,itemsize,vec", [(375, 4, True), (375, 4, False),
                                             (750, 4, True), (375, 8, True)])
def test_k1_map_at_the_shard_shapes(A, itemsize, vec):
    """``vec``: 16-byte loads (M % V == 0 and both pointers aligned), else
    scalar loads."""
    B = 10
    rng = np.random.default_rng(A + itemsize)
    labels = rng.integers(-1, B, size=(A, M_NORTH)).astype(np.int32)
    ret = np.where(labels >= 0, rng.normal(size=(A, M_NORTH)), 0.0)
    plan = kernels._decile_plan(A, M_NORTH, B, itemsize)
    ws, wc = kernels.decile_partial_sums_plain(torch.as_tensor(ret),
                                               torch.as_tensor(labels), B)
    assert M_NORTH % plan["v"] == 0
    s, c, reads, stores = _k1_emulate(labels, ret, B, plan, vec)
    assert (reads == 1).all() and (stores == 1).all()
    np.testing.assert_array_equal(c, wc.numpy())
    np.testing.assert_allclose(s, ws.numpy(), **TOL)


def _k2_emulate(labels, ret, valid, n_bins, H, plan, ys):
    """The CUDA kernel's index map, in numpy, over the month tiles ``ys``:
    each block (cluster rank, month tile, J group x horizon chunk) stages
    its slice's tiles, each thread (asset group, j, month) takes its tile
    rows' members and adds the staged months ``t + 1 + k``; the cluster's
    ranks add in rank order.  Returns ``(sums, counts, label reads,
    stores)``."""
    nJ, A, M = labels.shape
    TS, TA, jg, hc, groups, C = (plan[k] for k in ("ts", "ta", "jg", "hc", "groups",
                                                    "cluster"))
    gx, gy, gz = plan["grid"]
    KH = -(-hc // 4) * 4
    n_hc = -(-H // hc)
    r_live = np.where(valid, np.nan_to_num(ret), 0.0)
    sums = np.zeros((nJ, 2, M, H))
    counts = np.zeros((nJ, 2, M, H))
    reads = np.zeros((n_hc, nJ, A, M), dtype=int)
    stores = np.zeros((nJ, 2, M, H), dtype=int)
    per = -(-A // C)
    for y in ys:
        m0 = y * TS
        for z in range(gz):
            j0, h0 = (z // n_hc) * jg, (z % n_hc) * hc
            part = np.zeros((C, jg, 2, TS, hc))
            cnt = np.zeros((C, jg, 2, TS, hc))
            for rank in range(C):
                a_lo = min(A, rank * per)
                a_end = min(A, a_lo + per)
                for it in range(-(-(a_end - a_lo) // TA)):
                    na = min(TA, a_end - (a_lo + it * TA))
                    for g in range(groups):
                        rows = a_lo + it * TA + np.arange(g, na, groups)
                        for jl in range(jg):
                            j = j0 + jl
                            for t in range(TS):
                                s = m0 + t
                                if s >= M or j >= nJ:   # a dead lane takes nothing
                                    continue
                                reads[z % n_hc, j, rows, s] += 1
                                lab = labels[j, rows, s]
                                cols = s + h0 + 1 + np.arange(KH)
                                ok = cols < M           # staged as zeros past M
                                cc = np.minimum(cols, M - 1)
                                for side, want in ((0, 0), (1, n_bins - 1)):
                                    mem = rows[lab == want]
                                    x = np.where(ok, r_live[mem][:, cc], 0.0)
                                    v = np.where(ok, valid[mem][:, cc], False)
                                    part[rank, jl, side, t] += x.sum(axis=0)[:hc]
                                    cnt[rank, jl, side, t] += v.sum(axis=0)[:hc]
            for jl in range(jg):
                for t in range(TS):
                    for k in range(hc):
                        j, s, h = j0 + jl, m0 + t, h0 + k
                        if j < nJ and s < M and h < H:
                            for side in (0, 1):
                                acc = 0.0
                                for q in range(C):      # rank order
                                    acc += part[q, jl, side, t, k]
                                sums[j, side, s, h] = acc
                                counts[j, side, s, h] = cnt[:, jl, side, t, k].sum()
                                stores[j, side, s, h] += 1
    return sums, counts, reads, stores


# (nJ, A): one grid shard (4 Js) or two (2 Js) over 1, 2, 4, 8 asset
# shards of the north star, at its month count and so its plan; the walk
# covers the first month tile and the last, ragged one (696 = 21 x 32 + 24)
@pytest.mark.parametrize("nJ,A", [(4, 375), (2, 750), (1, 375)])
def test_k2_map_at_the_shard_shapes(nJ, A):
    M, H, B = M_NORTH, 12, 10
    rng = np.random.default_rng(nJ * 10_000 + A)
    labels = rng.integers(-1, B, size=(nJ, A, M)).astype(np.int32)
    valid = rng.random((A, M)) > 0.25
    ret = np.where(valid, rng.normal(0, 0.02, size=(A, M)), np.nan)
    plan = kernels._cohort_plan(nJ, A, M, H, 4)
    ys = (0, plan["grid"][1] - 1)
    s, c, reads, stores = _k2_emulate(labels, ret, valid, B, H, plan, ys)
    ws, wc = kernels.cohort_partial_sums_plain(
        torch.as_tensor(ret), torch.as_tensor(valid), torch.as_tensor(labels), B, H)
    months = np.concatenate([np.arange(y * plan["ts"], min(M, (y + 1) * plan["ts"]))
                             for y in ys])
    assert (reads[..., months] == 1).all()     # every label once per chunk
    assert (stores[:, :, months] == 1).all()   # every output stored once
    np.testing.assert_array_equal(c[:, :, months], wc.numpy()[:, :, months])
    np.testing.assert_allclose(s[:, :, months], ws.numpy()[:, :, months], **TOL)


def test_the_engines_hand_the_kernels_contiguous_shard_inputs(monkeypatch):
    """The sharded monthly and grid engines call K1 and K2 once per shard
    with contiguous ``[A_l, M]`` inputs planned for ``A_l`` assets."""
    from csmom_tpu_torch.parallel.collectives import (
        sharded_jk_grid_backtest,
        sharded_monthly_spread_backtest,
    )
    from csmom_tpu_torch.parallel.mesh import make_mesh

    calls = []
    k1, k2 = kernels.decile_partial_sums, kernels.cohort_partial_sums

    def spy1(ret, labels, n_bins):
        calls.append(("K1", tuple(ret.shape), ret.is_contiguous() and labels.is_contiguous()))
        return k1(ret, labels, n_bins)

    def spy2(ret, valid, labels, n_bins=10, max_hold=12):
        calls.append(("K2", tuple(labels.shape), all(x.is_contiguous()
                                                     for x in (ret, valid, labels))))
        return k2(ret, valid, labels, n_bins, max_hold)

    monkeypatch.setattr(kernels, "decile_partial_sums", spy1)
    monkeypatch.setattr(kernels, "cohort_partial_sums", spy2)
    rng = np.random.default_rng(0)
    p = torch.as_tensor(50 * np.exp(np.cumsum(rng.normal(0, 0.07, (48, 30)), 1)))
    m = torch.ones_like(p, dtype=torch.bool)
    sharded_monthly_spread_backtest(p, m, make_mesh(["cpu"] * 4), lookback=3)
    assert sorted(calls) == [("K1", (12, 30), True)] * 4
    calls.clear()
    sharded_jk_grid_backtest(p, m, [3, 6, 9, 12], [1, 3], make_mesh(["cpu"] * 8, grid_axis=2),
                             mode="rank")
    assert sorted(calls) == [("K2", (2, 12, 30), True)] * 8
