"""Strategy plugin boundary: pluggable cross-sectional signals over one
shared ranking/portfolio engine (both backends).  See ``base.py``."""

from csmom_tpu_torch.strategy.base import (
    Strategy,
    available_strategies,
    consumed_panels,
    make_strategy,
    register_strategy,
    xs_zscore,
)
from csmom_tpu_torch.strategy.builtin import (
    FiftyTwoWeekHigh,
    IntermediateMomentum,
    LowVolatility,
    Momentum,
    ResidualMomentum,
    Reversal,
    VolumeZMomentum,
    ZScoreCombo,
)
from csmom_tpu_torch.strategy.engine import strategy_backtest, strategy_backtest_pandas

__all__ = [
    "Strategy",
    "available_strategies",
    "consumed_panels",
    "make_strategy",
    "register_strategy",
    "xs_zscore",
    "FiftyTwoWeekHigh",
    "IntermediateMomentum",
    "LowVolatility",
    "Momentum",
    "ResidualMomentum",
    "Reversal",
    "VolumeZMomentum",
    "ZScoreCombo",
    "strategy_backtest",
    "strategy_backtest_pandas",
]
