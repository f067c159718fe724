"""Clean twin: pure shard functions and scorers (host values come from
the enclosing factory, once)."""

import torch

from csmom_tpu_torch.parallel.compat import shard_map
from csmom_tpu_torch.registry.core import ServeSurface


def make_score(params):
    bins = float(params["n_bins"])   # the factory's host value: made once

    def score(values, mask):
        return torch.where(mask, values, torch.nan).nansum(dim=-1) / bins

    return score


surface = ServeSurface(batch_fn=make_score, stub_fn=make_score)
batched = shard_map(lambda v, m: torch.where(m, v, 0.0).sum(), mesh=None,
                    in_specs=(), out_specs=())
