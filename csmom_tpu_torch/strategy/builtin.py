"""Built-in strategies.

Counterpart of :mod:`csmom_tpu.strategy.builtin`, with the same names,
fields and field order.  ``Momentum`` is the reference's own signal (J=12,
skip=1 momentum); the others are standard cross-sectional signals of the
same literature over the same panel, none of which needed an engine
change.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.signals.momentum import formation_listed_mask, momentum
from csmom_tpu_torch.signals.residual import residual_momentum
from csmom_tpu_torch.strategy.base import (
    Strategy,
    make_strategy,
    register_strategy,
    xs_zscore,
)

__all__ = [
    "FiftyTwoWeekHigh",
    "IntermediateMomentum",
    "LowVolatility",
    "Momentum",
    "Reversal",
    "ResidualMomentum",
    "VolumeZMomentum",
    "ZScoreCombo",
    "parse_combo_spec",
]


def _shift(x, s: int, fill):
    """``x`` moved ``s`` months later along the last axis, ``fill`` in front."""
    if s == 0:
        return x
    M = x.shape[-1]
    head = torch.full((*x.shape[:-1], min(s, M)), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[..., :max(M - s, 0)]], dim=-1)


@register_strategy("momentum")
@dataclasses.dataclass(frozen=True)
class Momentum(Strategy):
    """Compounded (J, skip) price momentum — the reference's signal
    (``features.py:5-57`` semantics; first valid value at month J+skip+1)."""

    lookback: int = 12
    skip: int = 1

    def signal(self, prices, mask, **panels):
        mom, valid = momentum(prices, mask, lookback=self.lookback, skip=self.skip)
        # the monthly engine's delisting rule, so the strategy engine equals
        # it on panels with delistings too
        valid = valid & formation_listed_mask(mask, self.skip)
        return torch.where(valid, mom, torch.nan), valid


@register_strategy("intermediate_momentum")
@dataclasses.dataclass(frozen=True)
class IntermediateMomentum(Momentum):
    """Novy-Marx (2012, JFE 103) intermediate momentum: the return over
    months t-12..t-7 only — NM's finding is that momentum's power lives in
    this *intermediate* horizon, not the recent t-6..t-2 leg.  A pure
    reparametrization of :class:`Momentum` (``lookback=6, skip=7``)."""

    lookback: int = 6
    skip: int = 7


@register_strategy("low_volatility")
@dataclasses.dataclass(frozen=True)
class LowVolatility(Strategy):
    """Blitz–van Vliet (2007, JPM 34) volatility effect: rank on the
    NEGATED trailing standard deviation of monthly returns, so the top
    decile is the lowest-volatility book and the spread is long-low /
    short-high vol.  ``min_obs`` valid months must lie inside the trailing
    ``window``."""

    window: int = 36
    min_obs: int = 12

    def signal(self, prices, mask, **panels):
        from csmom_tpu_torch.ops.rolling import rolling_std
        from csmom_tpu_torch.signals.momentum import raw_monthly_returns

        ret, rvalid = raw_monthly_returns(prices, mask)
        vol, vvalid = rolling_std(ret, rvalid, self.window,
                                  min_periods=self.min_obs, ddof=1)
        return torch.where(vvalid, -vol, torch.nan), vvalid


@register_strategy("reversal")
@dataclasses.dataclass(frozen=True)
class Reversal(Strategy):
    """Short-term reversal: negative of the trailing ``lookback``-month
    return (Jegadeesh 1990's 1-month contrarian signal by default)."""

    lookback: int = 1
    skip: int = 0

    def signal(self, prices, mask, **panels):
        mom, valid = momentum(prices, mask, lookback=self.lookback, skip=self.skip)
        valid = valid & formation_listed_mask(mask, self.skip)
        return torch.where(valid, -mom, torch.nan), valid


@register_strategy("residual_momentum")
@dataclasses.dataclass(frozen=True)
class ResidualMomentum(Strategy):
    """Blitz–Huij–Martens (2011) idiosyncratic momentum: rank on the
    volatility-scaled mean of trailing market-model residuals instead of
    raw returns (the closed-form rolling OLS of
    :mod:`csmom_tpu_torch.signals.residual`); the first valid score lands
    at month ``est_window + skip + 1``.
    """

    lookback: int = 12
    skip: int = 1
    est_window: int = 36
    scale_by_vol: bool = True

    def signal(self, prices, mask, **panels):
        return residual_momentum(prices, mask, lookback=self.lookback,
                                 skip=self.skip, est_window=self.est_window,
                                 scale_by_vol=self.scale_by_vol)


@register_strategy("volume_z_momentum")
@dataclasses.dataclass(frozen=True)
class VolumeZMomentum(Strategy):
    """Momentum tilted by trailing volume — a one-score rendering of
    Lee–Swaminathan's finding that high-volume winners outperform.

    ``score = z(momentum) + gamma * z(log1p(mean trailing volume))``, both
    legs z-scored per date; needs a ``volumes`` panel (month-summed
    volume, as :func:`csmom_tpu_torch.api.monthly_price_panel` gives).
    """

    lookback: int = 12
    skip: int = 1
    vol_lookback: int = 3
    gamma: float = 0.5

    def signal(self, prices, mask, *, volumes=None, volumes_mask=None, **panels):
        if volumes is None:
            raise ValueError("VolumeZMomentum needs a volumes= panel")
        mom, mom_valid = momentum(prices, mask, lookback=self.lookback, skip=self.skip)
        mom_valid = mom_valid & formation_listed_mask(mask, self.skip)
        mom = torch.where(mom_valid, mom, torch.nan)
        # month-summed volume panels hold 0.0 (not NaN) at never-observed
        # slots, so the fallback mask excludes zeros; pass volumes_mask to
        # count true zero-volume months
        vm = (volumes_mask if volumes_mask is not None
              else torch.isfinite(volumes) & (volumes > 0))

        # trailing mean volume over vol_lookback months (all present)
        v = torch.where(vm, torch.nan_to_num(volumes), 0.0)
        csum = torch.cumsum(v, dim=1)
        ccnt = torch.cumsum(vm.to(v.dtype), dim=1)
        L = self.vol_lookback
        win_cnt = ccnt - _shift(ccnt, L, 0.0)
        vol_avg = (csum - _shift(csum, L, 0.0)) / win_cnt.clamp(min=1)
        vol_valid = win_cnt >= L

        valid = mom_valid & vol_valid
        score = xs_zscore(mom, valid) + self.gamma * xs_zscore(
            torch.log1p(vol_avg.clamp(min=0.0)), valid)
        return torch.where(valid, score, torch.nan), valid


@register_strategy("high_52w")
@dataclasses.dataclass(frozen=True)
class FiftyTwoWeekHigh(Strategy):
    """George–Hwang (2004) 52-week-high momentum: rank on nearness of the
    current price to its trailing high, ``P[t-skip] / max(P over the
    lookback window ending t-skip)`` — a score in (0, 1].  Validity needs
    the full window of price observations, so the first valid score lands
    at month ``lookback + skip``.  The score has an atom at exactly 1.0,
    so ``mode='rank'`` is the natural pairing (``qcut`` drops duplicate
    edges)."""

    lookback: int = 12
    skip: int = 1

    def signal(self, prices, mask, **panels):
        from csmom_tpu_torch.ops.rolling import rolling_count

        p = torch.where(mask, prices, -torch.inf)
        # rolling max has no prefix-sum form: an unrolled maximum over the
        # window; its validity is the shared prefix-sum count
        high = torch.full_like(p, -torch.inf)
        for s in range(self.skip, self.skip + self.lookback):
            high = torch.maximum(high, _shift(p, s, -torch.inf))
        cnt = rolling_count(mask, self.lookback)
        allv = _shift(cnt == self.lookback, self.skip, False)
        ps = _shift(torch.where(mask, prices, torch.nan), self.skip, torch.nan)
        valid = allv & (high > 0)
        score = ps / torch.where(valid, high, 1.0)
        return torch.where(valid, score, torch.nan), valid


def parse_combo_spec(spec: str) -> tuple:
    """``"momentum:0.6,reversal:0.4"`` -> ((Momentum(), 0.6), (Reversal(), 0.4)).

    Each comma-separated term is ``name[:weight]`` (weight 1.0 by
    default), ``name`` any registered strategy with its defaults.
    """
    out = []
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        name, _, w = term.partition(":")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(
                f"combo term {term!r}: weight {w!r} is not a number"
            ) from None
        out.append((make_strategy(name.strip()), weight))
    if not out:
        raise ValueError(f"empty combo spec {spec!r}")
    return tuple(out)


@register_strategy("zscore_combo")
@dataclasses.dataclass(frozen=True)
class ZScoreCombo(Strategy):
    """Weighted sum of cross-sectionally z-scored component strategies.

    ``components`` is a tuple of ``(Strategy, weight)`` pairs, or a string
    spec like ``"momentum:0.6,reversal:0.4"`` (parsed by
    :func:`parse_combo_spec` at construction).  A slot is valid only where
    every component is valid.
    """

    components: tuple = ()

    def __post_init__(self):
        if isinstance(self.components, str):
            object.__setattr__(self, "components", parse_combo_spec(self.components))

    @property
    def panel_names(self):
        """Panels any component reads (the combo forwards ``**panels``)."""
        from csmom_tpu_torch.strategy.base import consumed_panels

        names = set()
        for s, _w in self.components:
            names |= consumed_panels(s)
        return tuple(sorted(names))

    def signal(self, prices, mask, **panels):
        if not self.components:
            raise ValueError("ZScoreCombo needs at least one component")
        outs = [(s.signal(prices, mask, **panels), w) for s, w in self.components]
        valid = None
        for (_score, v), _w in outs:
            valid = v if valid is None else (valid & v)
        total = None
        for (score, _v), w in outs:
            z = xs_zscore(torch.where(valid, score, torch.nan), valid)
            contrib = w * torch.where(valid, z, 0.0)
            total = contrib if total is None else total + contrib
        return torch.where(valid, total, torch.nan), valid
