"""The event backtest entry: ``csmom_tpu_torch.backtest.event``'s threshold
or hysteresis engine with its cost attribution, on dense minute panels
resident on the card, the PnL path, trade counts and cost totals fetched.

The last call's position, trade-side and fill panels stay on the card
until the window closes, and are compared with the reference's whole.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.backtest.event import (
    cost_attribution,
    event_backtest,
    hysteresis_event_backtest,
)
from perfbench import load
from perfbench.metrics._yardstick import event_bytes
from perfbench.reference import event as reference

# the scalars fetched after the PnL path, in this order
SCALARS = ("total_pnl", "n_trades", "n_buys", "n_sells", "net_notional",
           "total_cost", "spread_cost", "impact_cost", "gross_notional")
COUNTS = ("n_trades", "n_buys", "n_sells")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.dev = load("generators", cfg["generator"]).make(cfg, seed, device)
        self.host = {k: v.cpu() for k, v in self.dev.items()}
        self.last = None
        self.kept = None

    def _engine_args(self):
        c, t = self.cfg, self.traffic
        common = dict(size_shares=c["size_shares"], cash0=c["cash0"],
                      spread=c["spread"])
        if t["engine"] == "threshold":
            return event_backtest, dict(common, threshold=t["threshold"])
        if t["engine"] == "hysteresis":
            return hysteresis_event_backtest, dict(
                common, threshold_hi=t["threshold_hi"],
                threshold_lo=t["threshold_lo"])
        raise ValueError(f"unknown engine {t['engine']!r}")

    def call(self):
        """One timed call: the engine and its cost attribution, the PnL path
        and the scalar totals on the host."""
        self.last = None
        engine, kw = self._engine_args()
        d = self.dev
        r = engine(d["price"], d["valid"], d["score"], d["adv"], d["vol"], **kw)
        c = cost_attribution(r, d["price"], size_shares=kw["size_shares"],
                             spread=kw["spread"])
        dt = r.pnl.dtype
        scal = torch.stack([r.total_pnl, r.n_trades.to(dt), r.n_buys.to(dt),
                            r.n_sells.to(dt), r.net_notional, c.total_cost,
                            c.spread_cost, c.impact_cost, c.gross_notional])
        out = torch.cat([r.pnl, scal]).cpu().numpy()
        self.last = r
        return out

    def control_call(self):
        """The reference in bfloat16 in the program's place: its output in
        the program's form, its panels kept as :meth:`close` keeps the
        program's."""
        ref = self._reference(torch.bfloat16)
        scal = [float(ref[k]) for k in SCALARS]
        self.kept = {"units": ref["units"].numpy(),
                     "positions": ref["positions"].numpy(),
                     "fill": ref["fill"].float().numpy()}
        return np.concatenate([ref["pnl"].float().numpy(),
                               np.asarray(scal, dtype=np.float32)])

    def close(self):
        """Fetch the last call's panels, then free the program's device state."""
        if self.last is not None:
            r = self.last
            self.kept = {"units": r.trade_side.cpu().numpy(),
                         "positions": r.positions.cpu().numpy(),
                         "fill": r.exec_price.cpu().numpy()}
        self.last = None
        self.dev = None

    def _reference(self, dtype):
        _, kw = self._engine_args()
        h = self.host
        params = {k: self.traffic[k] for k in
                  ("threshold", "threshold_hi", "threshold_lo") if k in self.traffic}
        return reference.backtest(
            h["price"], h["valid"], h["score"], h["adv"], h["vol"],
            self.traffic["engine"], params, kw["size_shares"], kw["cash0"],
            kw["spread"], dtype=dtype)

    def reference(self):
        ref = self._reference(torch.float64)
        out = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in ref.items()}
        bars = self.host["valid"].any(dim=0).numpy()
        out["pnl_scale"] = float(np.sqrt(np.mean(out["pnl"][bars] ** 2)))
        out["pnl_abs"] = float(np.abs(out["pnl"]).sum())
        return out

    def readings(self, out, ref) -> dict:
        """One call's fetched output against the reference: its trade counts
        (exact), the widest PnL gap over the bars as a share of the
        reference PnL's RMS, and the widest relative gap of the cost
        totals (net notional against the gross, total PnL against the sum
        of the PnL's magnitudes)."""
        T = ref["pnl"].shape[0]
        pnl = out[:T].astype(np.float64)
        s = dict(zip(SCALARS, out[T:].astype(np.float64)))
        d = np.abs(pnl - ref["pnl"])
        pnl_gap = float(np.where(np.isnan(d), np.inf, d).max()) / ref["pnl_scale"]
        rel = [abs(s[k] - float(ref[k])) / abs(float(ref[k]))
               for k in ("total_cost", "spread_cost", "impact_cost", "gross_notional")]
        rel.append(abs(s["net_notional"] - float(ref["net_notional"]))
                   / abs(float(ref["gross_notional"])))
        rel.append(abs(s["total_pnl"] - float(ref["total_pnl"])) / ref["pnl_abs"])
        cost_gap = max(np.inf if np.isnan(x) else x for x in rel)
        return {
            "count_mismatch": float(sum(abs(s[k] - ref[k]) for k in COUNTS)),
            "pnl_gap": pnl_gap,
            "cost_gap": float(cost_gap),
        }

    def final_readings(self, ref) -> dict:
        """The last call's panels against the reference: cells whose trade
        units or positions differ (exact), and the widest relative fill
        gap over the reference's trades."""
        k = self.kept
        if k is None:
            return {"trade_mismatch": np.inf, "fill_gap": np.inf}
        units = k["units"].astype(np.int64)
        mismatch = ((units != ref["units"]).sum()
                    + (k["positions"].astype(np.int64) != ref["positions"]).sum())
        traded = ref["units"] != 0
        d = np.abs(k["fill"].astype(np.float64)[traded] - ref["fill"][traded])
        d = np.where(np.isnan(d), np.inf, d) / np.abs(ref["fill"][traded])
        return {"trade_mismatch": float(mismatch),
                "fill_gap": float(d.max()) if d.size else 0.0}

    def work(self, ref) -> dict:
        A, T = self.host["price"].shape
        return {"event_bytes": event_bytes(A, T, self.host["price"].element_size())}
