"""Known-bad fixture: a parallel enumeration and an undeclared point."""

from csmom_tpu_torch.chaos.inject import checkpoint

# a module-level endpoint table outside csmom_tpu_torch/registry/ forks
# the registry back into parallel lists
ENDPOINTS = ("momentum", "turnover", "backtest")


def probe():
    checkpoint("serve.not_a_point")   # absent from chaos.plan.KNOWN_POINTS
