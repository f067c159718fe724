"""Clean twin: donated tensors are never touched again in scope."""

from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.serve.engine import serve_entry_fn_donated


def run(values, mask, Js, Ks):
    grid = jk_grid_backtest(values, mask, Js, Ks, donate_panels=True)
    return grid, Ks.sum()        # Js and Ks (positions 2, 3) were kept


def run_rebound(values, mask):
    fn = serve_entry_fn_donated("momentum", 12, 1, 10, "rank")
    values = fn(values, mask)    # rebind: the old tensor is gone by name
    return values
