"""Predictive models: linear family (ridge closed-form, elastic-net/lasso
via FISTA, online ridge via Sherman-Morrison updates) and a small MLP
(full-batch AdamW), counterparts of :mod:`csmom_tpu.models`.  The batch
models share one expanding-window time-series-CV harness; the online
model is its leak-free walk-forward counterpart."""

from csmom_tpu_torch.models.ridge import ridge_time_series_cv, RidgeFit
from csmom_tpu_torch.models.elastic_net import (
    ElasticNetFit,
    as_ridge_fit,
    elastic_net_time_series_cv,
)
from csmom_tpu_torch.models.mlp import MLPFit, mlp_time_series_cv
from csmom_tpu_torch.models.online_ridge import OnlineRidgeFit, online_ridge_scores

__all__ = [
    "ridge_time_series_cv",
    "RidgeFit",
    "elastic_net_time_series_cv",
    "ElasticNetFit",
    "as_ridge_fit",
    "MLPFit",
    "mlp_time_series_cv",
    "OnlineRidgeFit",
    "online_ridge_scores",
]
