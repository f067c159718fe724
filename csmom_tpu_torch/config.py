"""Typed run configuration and its TOML loader.

A copy of :mod:`csmom_tpu.config`: the reference demo hardcodes every
parameter (universe, dates, J/skip, cash/size/threshold, impact
constants); here the same knobs are one frozen dataclass tree whose
defaults reproduce those constants, so a default ``RunConfig()`` is
parity mode.  ``load_config`` reads TOML (stdlib ``tomllib``): top-level
tables mirror the dataclass names, and unknown keys are rejected (a
mistyped knob must not fall back to a default).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# the reference demo's hardcoded 20-name universe (run_demo.py:15-16)
DEFAULT_TICKERS = (
    "AAPL", "MSFT", "AMZN", "GOOGL", "NVDA", "TSLA", "META", "JPM", "BAC", "WMT",
    "PG", "KO", "DIS", "CSCO", "ORCL", "INTC", "AMD", "NFLX", "C", "GS",
)


@dataclasses.dataclass(frozen=True)
class UniverseConfig:
    """What to trade and when (run_demo.py:15-16,196)."""

    tickers: Sequence[str] = DEFAULT_TICKERS
    start: str = "2018-01-01"
    end: str = "2024-12-31"
    data_dir: str = "data"


@dataclasses.dataclass(frozen=True)
class MomentumConfig:
    """Formation/holding parameters (run_demo.py:32; features.py:5)."""

    lookback: int = 12
    skip: int = 1
    n_bins: int = 10
    mode: str = "qcut"          # 'qcut' parity | 'rank' fast
    holding: int = 1            # K (reference holds 1 month)
    turnover_lookback: int = 3  # turn_avg window (features.py:60 lookback=3)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """J x K sweep axes (Lee-Swaminathan / Jegadeesh-Titman grid)."""

    Js: Sequence[int] = (3, 6, 9, 12)
    Ks: Sequence[int] = (3, 6, 9, 12)
    walk_forward_min_months: int = 24


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Execution model constants (execution_models.py:4-12)."""

    impact_k: float = 0.1
    impact_expo: float = 0.5
    spread: float = 0.001       # full spread, 10 bp
    half_spread_monthly: float = 0.0005  # linear cost on monthly turnover


@dataclasses.dataclass(frozen=True)
class IntradayConfig:
    """Minute pipeline + event backtest knobs (run_demo.py:86,140,170,180)."""

    window_minutes: int = 30
    n_splits: int = 3
    alpha: float = 1.0
    train_frac: float = 0.7
    size_shares: int = 50
    threshold: float = 1e-5
    cash0: float = 1_000_000.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Complete run description; the default is reference parity mode."""

    universe: UniverseConfig = UniverseConfig()
    momentum: MomentumConfig = MomentumConfig()
    grid: GridConfig = GridConfig()
    costs: CostConfig = CostConfig()
    intraday: IntradayConfig = IntradayConfig()
    results_dir: str = "results"   # run_demo.py:12
    backend: str = "tpu"
    # momentum keys the user explicitly set (config-file keys recorded by
    # load_config; CLI flags appended by the CLI layer).  Lets consumers —
    # e.g. strategy parametrization — distinguish "user chose lookback=12"
    # from "built-in default is 12", without re-parsing the file.
    explicit_momentum: Sequence[str] = ()
    # True when the user chose the universe (config-file [universe].tickers
    # or a --tickers flag) rather than inheriting the built-in demo list;
    # lets pack-aware consumers default to "every packed ticker" without
    # overriding an explicit choice
    explicit_universe: bool = False


_SECTIONS = {
    "universe": UniverseConfig,
    "momentum": MomentumConfig,
    "grid": GridConfig,
    "costs": CostConfig,
    "intraday": IntradayConfig,
}


def _build(cls, table: dict, where: str):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(table) - names
    if unknown:
        raise ValueError(f"unknown key(s) {sorted(unknown)} in [{where}]")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in table.items()})


def load_config(path: str) -> RunConfig:
    """Load a RunConfig from a TOML file; absent sections keep defaults."""
    import tomllib

    with open(path, "rb") as f:
        raw = tomllib.load(f)

    top_names = {f.name for f in dataclasses.fields(RunConfig)}
    unknown = set(raw) - top_names
    if unknown:
        raise ValueError(f"unknown top-level key(s) {sorted(unknown)}")

    kwargs = {}
    for key, val in raw.items():
        if key in _SECTIONS:
            kwargs[key] = _build(_SECTIONS[key], val, key)
        else:
            kwargs[key] = val
    kwargs["explicit_momentum"] = tuple(sorted(raw.get("momentum", {})))
    kwargs["explicit_universe"] = "tickers" in raw.get("universe", {})
    return RunConfig(**kwargs)
