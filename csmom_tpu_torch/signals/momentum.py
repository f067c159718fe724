"""Momentum signals on monthly ``[A, M]`` panels.

Counterpart of :mod:`csmom_tpu.signals.momentum`, with the same pandas
``fill_method='pad'`` semantics: returns are differences of the
forward-filled panel (an interior gap month returns 0.0, a delisted asset
keeps a 0-return tail), and the compounded (J, skip) momentum telescopes
to one price ratio on the filled panel::

    mom[a, t] = filled[a, t-skip] / filled[a, t-skip-J] - 1

valid iff every padded monthly return inside the window exists.
:func:`momentum_dynamic` takes a tensor of lookbacks ``[nJ]`` and returns
``[nJ, A, M]`` — the batch axis that replaces the reference's ``vmap``
over J in the grid engine.
"""

from __future__ import annotations

import torch


def padded_prices(prices, mask):
    """Forward-filled price panel.

    Returns ``(filled f[A, M], seen bool[A, M])``: ``filled[a, t]`` is the
    last observed price at or before t (NaN before the first observation),
    ``seen[a, t]`` marks slots with at least one observation at or before t.
    """
    M = prices.shape[1]
    idx = torch.arange(M, device=prices.device)
    last = torch.cummax(torch.where(mask, idx, -1), dim=1).values
    seen = last >= 0
    filled = torch.gather(torch.where(mask, prices, torch.nan), 1,
                          last.clamp(0, M - 1))
    return torch.where(seen, filled, torch.nan), seen


def monthly_returns(prices, mask):
    """1-month simple returns of the forward-filled panel.

    Returns ``(ret f[A, M], ret_valid bool[A, M])``; slot t holds
    ``filled[t]/filled[t-1] - 1``, invalid before the asset's first
    observation, in the first month, and after a zero price.
    """
    filled, seen = padded_prices(prices, mask)
    prev = torch.roll(filled, 1, dims=1)
    prev_seen = torch.roll(seen, 1, dims=1)
    prev_seen[:, 0] = False
    # seen is monotone along time, so prev_seen alone implies seen
    valid = prev_seen & (prev != 0.0)
    ret = torch.where(valid, filled / torch.where(valid, prev, 1.0) - 1.0,
                      torch.nan)
    return ret, valid


def momentum_dynamic(prices, mask, lookback, skip: int):
    """Compounded (J, skip) momentum for one J or a batch of Js.

    Args:
      prices: f[A, M] month-end prices; mask: bool[A, M].
      lookback: J as an int / 0-d tensor, or a 1-D tensor of Js ``[nJ]``.
      skip: months skipped between the window end and the formation date.

    Returns ``(mom, mom_valid)`` of shape ``[A, M]`` for a scalar J and
    ``[nJ, A, M]`` for a vector; ``mom[..., t]`` forms the portfolio held
    over month t+1.
    """
    _, ret_valid = monthly_returns(prices, mask)
    filled, _ = padded_prices(prices, mask)
    A, M = prices.shape
    dev = prices.device
    J = torch.as_tensor(lookback, device=dev).to(torch.int64)
    scalar = J.ndim == 0
    J = J.reshape(-1, 1)                                   # [nJ, 1]
    nJ = J.shape[0]
    t = torch.arange(M, device=dev)

    # window of monthly returns entering the product: [t-skip-J+1, t-skip]
    hi = t - skip                                          # [M]
    lo = t[None, :] - skip - J                             # [nJ, M]
    in_range = lo >= 0

    bad = (~ret_valid).to(torch.int64)
    badc = torch.cat(
        [torch.zeros((A, 1), dtype=torch.int64, device=dev),
         torch.cumsum(bad, dim=1)], dim=1,
    )                                                      # [A, M+1]
    hi_c = hi.clamp(0, M - 1)
    lo_c = (lo + 1).clamp(0, M - 1)

    def at(panel, cols):  # panel[a, cols[j, t]] -> [nJ, A, M]
        return torch.gather(panel.expand(nJ, *panel.shape), 2,
                            cols[:, None, :].expand(nJ, A, M))

    window_bad = badc[:, hi_c + 1][None] - at(badc, lo_c)
    p_hi = filled[:, hi_c][None]
    p_lo = at(filled, lo.clamp(0, M - 1))
    valid = in_range[:, None, :] & (window_bad == 0) & (p_lo != 0.0)
    mom = torch.where(valid, p_hi / torch.where(valid, p_lo, 1.0) - 1.0,
                      torch.nan)
    if scalar:
        return mom[0], valid[0]
    return mom, valid


def momentum(prices, mask, lookback: int = 12, skip: int = 1):
    """Compounded (J, skip) momentum for one J: ``(mom f[A, M],
    mom_valid bool[A, M])``."""
    return momentum_dynamic(prices, mask, lookback, skip)


def formation_listed_mask(mask, skip: int):
    """bool[A, M]: the asset is still listed at the formation window's end
    (an observation exists at or after month ``t - skip``), the reference
    backtest scripts' raw-shifted-price rule that drops delisted assets."""
    M = mask.shape[1]
    idx = torch.arange(M, device=mask.device)
    last = torch.where(mask, idx, -1).amax(dim=1)          # [A] final print
    hi = idx - skip
    return last[:, None] >= hi[None, :]
