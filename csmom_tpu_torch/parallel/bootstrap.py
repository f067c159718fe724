"""Sharded block bootstrap: the resample axis over a mesh axis.

Counterpart of :mod:`csmom_tpu.parallel.bootstrap`.  Resamples are
independent (a gather and a reduction over the same T-month series),
so the sample axis splits with no collective: the whole index matrix is
drawn once from the key (:func:`~csmom_tpu_torch.analytics.bootstrap.
circular_block_indices`, the single-device draw), each shard evaluates
its rows, and only the per-resample statistics come back.  So the
results equal :func:`~csmom_tpu_torch.analytics.bootstrap.block_bootstrap`'s
on any shard count.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.analytics.bootstrap import (
    BootstrapResult,
    _percentiles,
    circular_block_indices,
)
from csmom_tpu_torch.analytics.stats import masked_mean, sharpe
from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.parallel.compat import shard_map

__all__ = ["sharded_block_bootstrap"]


def sharded_block_bootstrap(returns, valid, key, mesh, n_samples: int = 1000,
                            block_len: int = 6, freq: int = 12,
                            ci_level: float = 0.95, axis_name: str = "assets",
                            index_dtype=torch.int32) -> BootstrapResult:
    """:func:`~csmom_tpu_torch.analytics.bootstrap.block_bootstrap` of a
    series ``f[T]`` with the resamples split over ``mesh[axis_name]``
    (``n_samples`` divisible by its size).  The result is on the mesh's
    first device."""
    n_shards = mesh.shape[axis_name]
    if n_samples % n_shards:
        raise ValueError(f"n_samples={n_samples} not divisible by mesh axis "
                         f"{axis_name!r} size {n_shards}")
    home = mesh.home
    returns = torch.as_tensor(returns, device=home)
    valid = torch.as_tensor(valid, device=home)
    idx = circular_block_indices(torch.as_tensor(key, device=home), n_samples,
                                 returns.shape[-1], block_len,
                                 index_dtype).to(torch.int64)

    def local_fn(r, v, idx_l):
        rs, vs = r[0][idx_l], v[0][idx_l]           # [S_l, T]
        return (masked_mean(rs, vs)[None],
                sharpe(rs, vs, freq_per_year=freq)[None])

    means, sharpes = shard_map(
        local_fn, mesh=mesh, in_specs=(P(), P(), P(axis_name)),
        out_specs=(P(None, axis_name), P(None, axis_name)),
    )(returns[None, :], valid[None, :], idx)
    means, sharpes = means[0], sharpes[0]
    return BootstrapResult(
        mean_samples=means,
        sharpe_samples=sharpes,
        mean_point=masked_mean(returns, valid),
        sharpe_point=sharpe(returns, valid, freq_per_year=freq),
        mean_ci=_percentiles(means, ci_level),
        sharpe_ci=_percentiles(sharpes, ci_level),
    )
