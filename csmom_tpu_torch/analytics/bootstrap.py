"""Circular block-bootstrap confidence intervals (BASELINE config 5).

Counterpart of :mod:`csmom_tpu.analytics.bootstrap`.  A resample is an
index gather, so S resamples x T months x statistics are a few batched
ops, not a loop over resamples.  Blocks keep the short-horizon
autocorrelation of monthly spreads; circular wrapping keeps every
resample exactly T months long.

The start points come from the port's threefry
(:mod:`csmom_tpu_torch.random`), so a key draws the JAX package's
resamples.  Their integer width is explicit: ``index_dtype=torch.int32``
(the default) draws what the JAX package draws in production (64-bit
types off), ``torch.int64`` what it draws with them on.  The draw runs
on the data's device.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch import random
from csmom_tpu_torch.analytics.stats import masked_mean, sharpe


@dataclasses.dataclass(frozen=True)
class BootstrapResult:
    """Bootstrap distribution + percentile CIs of a masked return series."""

    mean_samples: torch.Tensor    # f[S] resampled mean returns
    sharpe_samples: torch.Tensor  # f[S] resampled annualized Sharpes
    mean_point: torch.Tensor      # scalar, on the original series
    sharpe_point: torch.Tensor    # scalar
    mean_ci: torch.Tensor         # f[2] percentile interval (lo, hi)
    sharpe_ci: torch.Tensor       # f[2]


def circular_block_indices(key, n_samples: int, n_times: int, block_len: int,
                           index_dtype=torch.int32):
    """i32[n_samples, n_times] circular-block resample indices: each row is
    ceil(T / L) blocks of L consecutive (mod T) months from uniform random
    starts, cut to exactly T.  Drawn on the key's device."""
    if block_len < 1:
        raise ValueError(f"block_len must be >= 1, got {block_len}")
    n_blocks = -(-n_times // block_len)
    starts = random.randint(key, (n_samples, n_blocks), 0, n_times,
                            dtype=index_dtype).to(torch.int64)
    offs = torch.arange(block_len, device=starts.device)
    idx = (starts[:, :, None] + offs[None, None, :]) % n_times
    return idx.reshape(n_samples, -1)[:, :n_times].to(torch.int32)


def _percentiles(samples, ci_level: float):
    alpha = (1.0 - ci_level) / 2.0
    q = torch.tensor([alpha, 1.0 - alpha], dtype=samples.dtype,
                     device=samples.device)
    return torch.nanquantile(samples, q, dim=0)


def _resample_stats(returns, valid, key, n_samples, block_len, freq,
                    index_dtype):
    T = returns.shape[-1]
    key = torch.as_tensor(key, device=returns.device)
    idx = circular_block_indices(key, n_samples, T, block_len,
                                 index_dtype).to(torch.int64)
    r = returns[..., idx]      # [..., S, T]
    v = valid[..., idx]
    return masked_mean(r, v), sharpe(r, v, freq_per_year=freq)


def block_bootstrap(returns, valid, key, n_samples: int = 1000,
                    block_len: int = 6, freq: int = 12, ci_level: float = 0.95,
                    index_dtype=torch.int32) -> BootstrapResult:
    """Bootstrap the mean and annualized Sharpe of a masked series ``f[T]``.

    Invalid months travel with their index, so a resample that draws them
    has fewer live observations (masked statistics).
    """
    means, sharpes = _resample_stats(returns, valid, key, n_samples,
                                     block_len, freq, index_dtype)
    return BootstrapResult(
        mean_samples=means,
        sharpe_samples=sharpes,
        mean_point=masked_mean(returns, valid),
        sharpe_point=sharpe(returns, valid, freq_per_year=freq),
        mean_ci=_percentiles(means, ci_level),
        sharpe_ci=_percentiles(sharpes, ci_level),
    )


def block_bootstrap_grid(spreads, spread_valid, key, n_samples: int = 200,
                         block_len: int = 6, freq: int = 12,
                         ci_level: float = 0.95,
                         index_dtype=torch.int32) -> BootstrapResult:
    """Bootstrap every cell of a ``[..., T]`` grid of spread series at once,
    with one shared set of resample indices (the cells are the same
    calendar months, so the resamples are synchronized across cells).
    Samples come back as ``f[S, ...grid]`` and CIs as ``f[2, ...grid]``.
    """
    means, sharpes = _resample_stats(spreads, spread_valid, key, n_samples,
                                     block_len, freq, index_dtype)
    means = torch.movedim(means, -1, 0)
    sharpes = torch.movedim(sharpes, -1, 0)
    return BootstrapResult(
        mean_samples=means,
        sharpe_samples=sharpes,
        mean_point=masked_mean(spreads, spread_valid),
        sharpe_point=sharpe(spreads, spread_valid, freq_per_year=freq),
        mean_ci=_percentiles(means, ci_level),
        sharpe_ci=_percentiles(sharpes, ci_level),
    )
