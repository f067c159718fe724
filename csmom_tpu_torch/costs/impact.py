"""Execution cost models on tensors.

Counterpart of :mod:`csmom_tpu.costs.impact`: square-root market impact,
market and limit fills (the limit fill draws from the port's threefry,
:mod:`csmom_tpu_torch.random`, so a key gives the JAX package's fills),
and the equal-weight long-short book with its linear turnover cost that
nets both engines' spreads (BASELINE config 3).  Every function works on
whole cross-sections or panels at once, on its inputs' device.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch import random


def square_root_impact(size_shares, adv_shares, volatility, k=0.1, expo=0.5):
    """Square-root market impact as a return fraction; 0 where ADV <= 0."""
    adv_ok = adv_shares > 0
    part = torch.abs(size_shares) / torch.where(adv_ok, adv_shares, 1.0)
    return torch.where(adv_ok, k * volatility * part ** expo, 0.0)


def market_fill(price, size_shares, adv_shares, volatility, side, spread=0.001):
    """Immediate market-order fill with half-spread + impact:
    ``(executed_price, impact)``; ``side`` is +1 buy / -1 sell."""
    impact = square_root_impact(size_shares, adv_shares, volatility)
    executed = price * (1.0 + side * (spread / 2.0 + impact))
    return executed, impact


def limit_fill(key, price, size_shares, adv_shares, volatility, aggressiveness=0.5):
    """Probabilistic limit-order fill: fill probability
    ``(0.2 + 0.7*agg) * (1 - 0.5*min(1, |size|/max(1, adv)))`` against one
    uniform draw per order; the price improves by ``0.5*agg*10bp``; the
    expected slippage is the unfilled share of the impact.

    The draw has the width of the computation's float type (float64 on
    float64 inputs, else float32), as the JAX package's follows its
    64-bit flag.  Returns ``(filled bool, executed_price, expected_slippage)``.
    """
    p_fill = 0.2 + 0.7 * aggressiveness
    size_frac = torch.clamp(
        torch.abs(size_shares) / torch.clamp(adv_shares, min=1.0), max=1.0)
    p_full = p_fill * (1.0 - 0.5 * size_frac)
    dtype = torch.float64 if p_full.dtype == torch.float64 else torch.float32
    u = random.uniform(torch.as_tensor(key, device=p_full.device),
                       tuple(p_full.shape), dtype=dtype)
    filled = u < p_full
    executed = price * (1.0 - 0.5 * aggressiveness * 0.001)
    slip = square_root_impact(size_shares, adv_shares, volatility) * (1.0 - aggressiveness)
    return filled, executed, slip


def long_short_weights(labels, counts, n_bins: int, dtype=None):
    """Equal-weight long-short weights from decile labels: ``+1/n_top`` for
    top-decile members, ``-1/n_bot`` for bottom ones, 0 otherwise, and both
    legs 0 in a month where either extreme decile is empty.

    Args:
      labels: int ``[..., A, M]`` decile ids (-1 invalid).
      counts: int ``[..., B, M]`` members per decile.
      dtype: the weights' float type (torch's default if None); the engines
        pass their spreads' type.
    """
    dtype = torch.get_default_dtype() if dtype is None else dtype
    top_n = counts[..., n_bins - 1, :].to(dtype)
    bot_n = counts[..., 0, :].to(dtype)
    live = ((top_n > 0) & (bot_n > 0)).unsqueeze(-2)
    w_top = torch.where((labels == n_bins - 1) & live,
                        1.0 / top_n.clamp(min=1).unsqueeze(-2), 0.0)
    w_bot = torch.where((labels == 0) & live,
                        1.0 / bot_n.clamp(min=1).unsqueeze(-2), 0.0)
    return w_top - w_bot


def turnover_cost(weights, half_spread=0.0005):
    """Linear cost of rebalancing a weight panel ``f[..., A, M]``:
    ``cost[t] = half_spread * sum_a |w[a, t] - w[a, t-1]|`` with
    ``w[:, -1] = 0`` (the first month buys the whole book)."""
    prev = torch.roll(weights, 1, dims=-1)
    prev[..., 0] = 0.0
    return torch.sum(torch.abs(weights - prev), dim=-2) * half_spread
