"""The ``Strategy`` plugin boundary.

Counterpart of :mod:`csmom_tpu.strategy.base`.  A :class:`Strategy` is a
frozen, hashable dataclass whose :meth:`signal` maps the masked month-end
panel to scores::

    score, valid = strategy.signal(prices, mask, **panels)

``prices``/``mask`` are the ``f[A, M]`` / ``bool[A, M]`` tensors; extra
named panels (e.g. ``volumes``) are passed through by the engine.  The
engine's ranking and portfolio tail is shared by every strategy, so a new
signal never touches an engine.

Strategies register by name with :func:`register_strategy`, as
kind-``strategy`` engines of the registry (:mod:`csmom_tpu_torch.registry`),
and are built by name with :func:`make_strategy`: the monthly commands'
zoo and ``registry list`` read the same row.
"""

from __future__ import annotations

import abc
import dataclasses
import inspect

import torch

__all__ = [
    "Strategy",
    "register_strategy",
    "make_strategy",
    "available_strategies",
    "consumed_panels",
    "xs_zscore",
]

@dataclasses.dataclass(frozen=True)
class Strategy(abc.ABC):
    """Base class for cross-sectional strategies (frozen, hashable)."""

    @abc.abstractmethod
    def signal(self, prices, mask, **panels):
        """Formation-date scores over the panel.

        Args:
          prices: f[A, M] month-end prices (NaN at masked slots).
          mask: bool[A, M] observation mask.
          **panels: extra named panels (the engine passes them through;
            a strategy reads what it needs and ignores the rest).

        Returns:
          ``(score f[A, M], valid bool[A, M])``: a higher score ranks into
          a higher decile (the long leg); invalid slots are not ranked.
        """


def consumed_panels(strategy) -> frozenset:
    """Names of the extra panels a strategy's ``signal`` can read: its
    explicit keyword parameters besides ``prices``/``mask`` (the
    ``**panels`` catch-all does not count), plus an optional
    ``panel_names`` attribute of composites that forward panels.  The
    engine rejects forwarded panels outside this set, so a misspelled
    panel name fails loudly."""
    params = inspect.signature(type(strategy).signal).parameters
    names = {
        n
        for n, p in params.items()
        if n not in ("self", "prices", "mask")
        and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    }
    names |= set(getattr(strategy, "panel_names", ()))
    return frozenset(names)


def register_strategy(name: str):
    """Class decorator: register a Strategy as the kind-``strategy``
    engine ``name`` (a later registration of the same name replaces
    it)."""

    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, Strategy)):
            raise TypeError(f"{cls!r} is not a Strategy subclass")
        from csmom_tpu_torch.registry.core import REGISTRY, EngineSpec

        doc = (cls.__doc__ or "").strip().splitlines()
        REGISTRY.register(EngineSpec(
            name=name, kind="strategy", strategy_cls=cls,
            description=doc[0] if doc else "",
            axes="prices f[A,M], mask bool[A,M] -> (score, valid)",
        ), replace=True)
        return cls

    return deco


def make_strategy(name: str, **params) -> Strategy:
    """Instantiate a registered strategy by name with keyword params."""
    zoo = available_strategies()
    try:
        cls = zoo[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(zoo)}"
        ) from None
    return cls(**params)


def available_strategies() -> dict:
    """``{name: Strategy subclass}`` of every registered strategy."""
    from csmom_tpu_torch.registry import strategies

    return strategies()


def xs_zscore(score, valid):
    """Cross-sectional z-score per date over the masked asset axis.

    Monotone within a date, so it ranks like the raw signal; it makes
    combinations of signals scale-free (each component counts in units of
    its cross-sectional standard deviation).  Panels are ``[..., A, M]``:
    the moments reduce over the asset axis (-2), so a batch of panels
    ``[B, A, M]`` z-scores each panel's dates on their own.
    """
    n = valid.sum(dim=-2, keepdim=True).clamp(min=1)
    x = torch.where(valid, torch.nan_to_num(score), 0.0)
    mu = x.sum(dim=-2, keepdim=True) / n
    var = torch.where(valid, (x - mu) ** 2, 0.0).sum(dim=-2, keepdim=True) / n
    sd = torch.sqrt(var)
    z = torch.where(sd > 0, (x - mu) / torch.where(sd == 0, 1.0, sd), 0.0)
    return torch.where(valid, z, torch.nan)
