"""The intraday pipeline entry: ``csmom_tpu_torch.api.intraday_on_device``
(minute features, the model's fit with its time-series CV, the scores on
the minute axis, the event backtest) and the engine's cost attribution,
on compacted minute panels resident on the card; the PnL path, trade
counts, cost totals, the fit's coefficients, intercept, CV MSEs and
``n_train`` fetched.

The last call's dense score, trade-side, position and fill panels stay on
the card until the window closes, and are compared with the reference's
whole.  The fetch runs inside the profiler range ``perfbench.fetch``, so
that a traced call's host operations are the pipeline's phase spans and
that one range.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.api import intraday_on_device
from csmom_tpu_torch.backtest.event import cost_attribution
from perfbench import load
from perfbench.metrics._yardstick_intraday import intraday_bytes
from perfbench.reference import intraday as reference

FETCH = "perfbench.fetch"
# the scalars fetched after the PnL path, in this order; then the
# coefficients and the CV MSEs
SCALARS = ("total_pnl", "n_trades", "n_buys", "n_sells", "net_notional",
           "total_cost", "spread_cost", "impact_cost", "gross_notional",
           "intercept", "n_train")
COUNTS = ("n_trades", "n_buys", "n_sells")
EVENT_COSTS = ("total_cost", "spread_cost", "impact_cost", "gross_notional")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.dev = load("generators", cfg["generator"]).make(cfg, seed, device)
        self.host = {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in self.dev.items()}
        self.last = None
        self.kept = None

    def call(self):
        """One timed call: the pipeline's device body and the cost
        attribution, then the PnL path, the scalars, the coefficients and
        the CV MSEs on the host."""
        self.last = None
        c, d = self.cfg, self.dev
        r, fit, score, price, _ = intraday_on_device(
            d["price"], d["volume"], d["row_valid"], d["time_idx"], d["n_minutes"],
            d["adv"], d["vol"], window_minutes=c["window_minutes"],
            n_splits=c["n_splits"], alpha=c["alpha"], size_shares=c["size_shares"],
            threshold=c["threshold"], cash0=c["cash0"], model=self.traffic["model"],
            latency_bars=c["latency_bars"])
        costs = cost_attribution(r, price, size_shares=c["size_shares"],
                                 spread=c["spread"])
        with torch.profiler.record_function(FETCH):
            dt = r.pnl.dtype
            scal = torch.stack([r.total_pnl, r.n_trades.to(dt), r.n_buys.to(dt),
                                r.n_sells.to(dt), r.net_notional, costs.total_cost,
                                costs.spread_cost, costs.impact_cost,
                                costs.gross_notional, fit.intercept.to(dt),
                                fit.n_train.to(dt)])
            out = torch.cat([r.pnl, scal, fit.coef.to(dt), fit.cv_mse.to(dt)])
            out = out.cpu().numpy()
        self.last = (r, score)
        return out

    def control_call(self):
        """The reference in float32 in the program's place: its output in
        the program's form, its panels kept as :meth:`close` keeps the
        program's."""
        ref = self._reference(torch.float32)
        self.kept = {"score": ref["scores"].numpy(), "units": ref["units"].numpy(),
                     "positions": ref["positions"].numpy(),
                     "fill": ref["fill"].numpy()}
        scal = [float(ref[k]) for k in SCALARS]
        return np.concatenate([ref["pnl"].numpy(), np.asarray(scal, np.float32),
                               ref["coef"].numpy(), ref["cv_mse"].numpy()])

    def close(self):
        """Fetch the last call's panels, then free the program's device
        state.  The dense score panel is read back at the modeling rows, in
        the compacted layout the reference gives its scores in."""
        if self.last is not None:
            r, score = self.last
            h = self.host
            rows = torch.arange(score.shape[0])[:, None].expand_as(h["time_idx"])
            self.kept = {
                "score": score.cpu()[rows, h["time_idx"].long()].numpy(),
                "units": r.trade_side.cpu().numpy(),
                "positions": r.positions.cpu().numpy(),
                "fill": r.exec_price.cpu().numpy()}
        self.last = None
        self.dev = None

    def _reference(self, dtype):
        c, h = self.cfg, self.host
        return reference.pipeline(
            h["price"], h["volume"], h["row_valid"], h["time_idx"], h["n_minutes"],
            h["adv"], h["vol"], c["window_minutes"], c["n_splits"], c["alpha"],
            c["train_frac"], c["size_shares"], c["threshold"], c["cash0"],
            c["spread"], dtype=dtype)

    def reference(self):
        ref = self._reference(torch.float64)
        out = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in ref.items()
               if k not in ("folds", "features", "label")}
        bars = out["dense_valid"].any(axis=0)
        out["pnl_scale"] = float(np.sqrt(np.mean(out["pnl"][bars] ** 2)))
        out["pnl_abs"] = float(np.abs(out["pnl"]).sum())
        s = out["scores"][out["valid"]]
        out["score_scale"] = float(np.sqrt(np.mean(s ** 2)))
        return out

    def readings(self, out, ref) -> dict:
        """One call's fetched output against the reference: its trade counts
        (exact), the widest PnL gap over the bars as a share of the
        reference PnL's RMS, the widest relative gap of the cost totals
        (net notional against the gross, total PnL against the sum of the
        PnL's magnitudes), the widest relative gap of the fit (the
        coefficients and the intercept against the larger of the
        coefficients' magnitudes and the intercept's, each CV MSE against
        its own) and ``n_train`` (exact)."""
        T = ref["pnl"].shape[0]
        F, K = ref["coef"].shape[0], ref["cv_mse"].shape[0]
        pnl = out[:T].astype(np.float64)
        s = dict(zip(SCALARS, out[T:T + len(SCALARS)].astype(np.float64)))
        coef = out[T + len(SCALARS):T + len(SCALARS) + F].astype(np.float64)
        cv = out[T + len(SCALARS) + F:T + len(SCALARS) + F + K].astype(np.float64)
        d = np.abs(pnl - ref["pnl"])
        pnl_gap = float(np.where(np.isnan(d), np.inf, d).max()) / ref["pnl_scale"]
        rel = [abs(s[k] - float(ref[k])) / abs(float(ref[k])) for k in EVENT_COSTS]
        rel.append(abs(s["net_notional"] - float(ref["net_notional"]))
                   / abs(float(ref["gross_notional"])))
        rel.append(abs(s["total_pnl"] - float(ref["total_pnl"])) / ref["pnl_abs"])
        scale = max(float(np.abs(ref["coef"]).max()), abs(float(ref["intercept"])))
        fit = list(np.abs(coef - ref["coef"]) / scale)
        fit.append(abs(s["intercept"] - float(ref["intercept"])) / scale)
        fit.extend(np.abs(cv - ref["cv_mse"]) / np.abs(ref["cv_mse"]))
        return {
            "count_mismatch": float(sum(abs(s[k] - ref[k]) for k in COUNTS)),
            "pnl_gap": pnl_gap,
            "cost_gap": float(max(np.inf if np.isnan(x) else x for x in rel)),
            "fit_gap": float(max(np.inf if np.isnan(x) else x for x in fit)),
            "train_mismatch": float(abs(s["n_train"] - ref["n_train"])),
        }

    def final_readings(self, ref) -> dict:
        """The last call's panels against the reference: cells whose trade
        units or positions differ (exact), the widest relative fill gap
        over the reference's trades, and the widest score gap over the
        modeling rows as a share of the reference scores' RMS."""
        k = self.kept
        if k is None:
            return {"trade_mismatch": np.inf, "fill_gap": np.inf, "score_gap": np.inf}
        units = k["units"].astype(np.int64)
        mismatch = ((units != ref["units"]).sum()
                    + (k["positions"].astype(np.int64) != ref["positions"]).sum())
        traded = ref["units"] != 0
        d = np.abs(k["fill"].astype(np.float64)[traded] - ref["fill"][traded])
        d = np.where(np.isnan(d), np.inf, d) / np.abs(ref["fill"][traded])
        v = ref["valid"]
        g = np.abs(k["score"].astype(np.float64)[v] - ref["scores"][v])
        g = np.where(np.isnan(g), np.inf, g)
        return {"trade_mismatch": float(mismatch),
                "fill_gap": float(d.max()) if d.size else 0.0,
                "score_gap": float(g.max()) / ref["score_scale"] if g.size else 0.0}

    def work(self, ref) -> dict:
        A, R = self.host["price"].shape
        return {"intraday_bytes": intraday_bytes(
            A, R, self.host["n_minutes"], self.host["price"].element_size())}
