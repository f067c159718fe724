"""The J x K grid entry: ``csmom_tpu_torch.backtest.grid.jk_grid_backtest``
on a month-end panel resident on the card, its result table fetched.

Set-up makes the daily panel from the seed, keeps a host copy of it for the
reference, and runs the port's data-in step (month-end segments and the
month-end aggregation) on the card.  One call is the grid from the
resident panel to its result table on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from perfbench import load
from perfbench.reference import grid as reference

STATS = ("mean", "sharpe", "t", "nw_t")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        daily = load("generators", cfg["generator"]).make(cfg, seed, device)
        self.host = {"values": daily["values"].cpu().numpy(),
                     "mask": daily["mask"].cpu().numpy(),
                     "times": daily["times"]}
        seg, ends = month_end_segments(daily["times"])
        self.prices, self.mask = month_end_aggregate(
            daily["values"], daily["mask"], seg, len(ends))
        del daily
        self.Js, self.Ks = tuple(cfg["Js"]), tuple(cfg["Ks"])
        self.shape = (len(self.Js), len(self.Ks), self.prices.shape[1])

    def _run(self, impl: str):
        g = jk_grid_backtest(self.prices, self.mask, self.Js, self.Ks,
                             skip=self.cfg["skip"], n_bins=self.cfg["n_bins"],
                             mode=self.traffic["mode"],
                             freq=self.cfg["freq_per_year"], impl=impl)
        stats = torch.stack([g.mean_spread, g.ann_sharpe, g.tstat, g.tstat_nw])
        out = torch.cat([g.spreads.reshape(-1),
                         g.spread_valid.reshape(-1).to(g.spreads.dtype),
                         stats.reshape(-1)])
        return out.cpu().numpy()

    def call(self):
        """One timed call: the grid and its result table on the host."""
        return self._run(self.traffic["impl"])

    def control_call(self):
        """The program's own lower-precision path in place of the timed one."""
        return self._run(self.traffic["control_impl"])

    def close(self):
        """Free the program's device state once the window has closed."""
        del self.prices, self.mask

    def reference(self):
        c = self.cfg
        return reference.grid(
            self.host["values"], self.host["mask"], self.host["times"],
            c["Js"], c["Ks"], c["skip"], c["n_bins"], c["freq_per_year"])

    def readings(self, out, ref) -> dict:
        """One call's result table against the reference: cells whose
        validity differs (exact), the widest spread gap over the
        reference's valid months as a share of their RMS, and the widest
        gap of each statistic as a share of the statistic's largest
        magnitude over the grid."""
        n = int(np.prod(self.shape))
        spreads = out[:n].reshape(self.shape).astype(np.float64)
        valid = out[n:2 * n].reshape(self.shape) > 0.5
        stats = out[2 * n:].reshape(len(STATS), *self.shape[:2]).astype(np.float64)
        rv = ref["valid"]
        scale = np.sqrt(np.mean(ref["spreads"][rv] ** 2))
        return {
            "valid_mismatch": float((valid != rv).sum()),
            "spread_gap": _gap(spreads[rv], ref["spreads"][rv]) / scale,
            "stat_gap": max(_gap(stats[i], ref[k]) / np.nanmax(np.abs(ref[k]))
                            for i, k in enumerate(STATS)),
        }

    def final_readings(self, ref) -> dict:
        return {}

    def work(self, ref) -> dict:
        return {"k2": {"labels_shape": (len(self.Js), self.host["values"].shape[0],
                                        self.shape[2]),
                       "members": ref["members"],
                       "ret_itemsize": self.host["values"].itemsize,
                       "H": max(self.Ks)}}


def _gap(got, want) -> float:
    """The widest absolute gap; NaN on both sides agrees, NaN on one side is
    an infinite gap."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both = np.isnan(got) & np.isnan(want)
    d = np.abs(got - want)
    d = np.where(both, 0.0, np.where(np.isnan(d), np.inf, d))
    return float(d.max()) if d.size else 0.0
