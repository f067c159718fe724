"""The comparison that decides ``correct``, on the CPU at small sizes: each
reference agrees with the port's plain implementation, the control (a lower
precision in the program's place) fails the committed limits, and a run
whose timed path is broken underneath comes out not correct."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from conftest import TINY

import perfbench.entries.event as event_entry
import perfbench.entries.grid as grid_entry
from csmom_tpu_torch.backtest import event as port_event
from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from perfbench import load
from perfbench.reference import event as ref_event
from perfbench.reference import grid as ref_grid
from perfbench.run import ROOT, Outputs, load_json, resolve, run_cell

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell(workload, seed):
    parts = resolve(BENCH, workload)
    cfg = dict(parts["config"], **TINY[parts["workload"]["config"]])
    cell = load("entries", parts["traffic"]["entry"]).Cell(cfg, parts["traffic"],
                                                          seed, "cpu")
    return cell, parts["limits"]


def _over(readings, limits):
    return [k for k, v in readings.items() if not v <= limits[k]]


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_grid_reference_matches_the_ports_plain_grid_in_f64(seed):
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from perfbench.generators import daily_gbm

    cfg = dict(resolve(BENCH, "jt93_crsp.grid_rank")["config"],
               **TINY["jt93_crsp"], dtype="float64")
    d = daily_gbm.make(cfg, seed, "cpu")
    seg, ends = month_end_segments(d["times"])
    pm, mm = month_end_aggregate(d["values"], d["mask"], seg, len(ends))
    g = jk_grid_backtest(pm, mm, cfg["Js"], cfg["Ks"], skip=1, n_bins=10,
                         mode="rank", impl="plain")
    ref = ref_grid.grid(d["values"].numpy(), d["mask"].numpy(), d["times"],
                        cfg["Js"], cfg["Ks"], 1, 10, 12)
    assert np.array_equal(g.spread_valid.numpy(), ref["valid"])
    np.testing.assert_allclose(g.spreads.numpy(), ref["spreads"], rtol=1e-9,
                               atol=1e-12, equal_nan=True)
    for got, k in ((g.mean_spread, "mean"), (g.ann_sharpe, "sharpe"),
                   (g.tstat, "t"), (g.tstat_nw, "nw_t")):
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=1e-9, equal_nan=True)


@pytest.mark.parametrize("engine", ["threshold", "hysteresis"])
def test_event_reference_matches_the_ports_engine_in_f64(engine):
    from perfbench.generators import minute_bars

    cfg = dict(resolve(BENCH, "sp500_minutes.event_threshold")["config"],
               **TINY["sp500_minutes"], dtype="float64")
    d = minute_bars.make(cfg, 11, "cpu")
    if engine == "threshold":
        params = {"threshold": 1e-5}
        r = port_event.event_backtest(d["price"], d["valid"], d["score"], d["adv"],
                                      d["vol"], threshold=1e-5)
    else:
        params = {"threshold_hi": 1e-4, "threshold_lo": 1e-5}
        r = port_event.hysteresis_event_backtest(d["price"], d["valid"], d["score"],
                                                 d["adv"], d["vol"], **params)
    c = port_event.cost_attribution(r, d["price"])
    ref = ref_event.backtest(d["price"], d["valid"], d["score"], d["adv"], d["vol"],
                             engine, params, 50, 1_000_000.0, 0.001)
    assert torch.equal(r.trade_side.to(torch.int64), ref["units"])
    assert torch.equal(r.positions.to(torch.int64), ref["positions"])
    assert int(r.n_trades) == ref["n_trades"] and int(r.n_buys) == ref["n_buys"]
    torch.testing.assert_close(r.exec_price, ref["fill"], rtol=1e-12, atol=0)
    torch.testing.assert_close(r.pnl, ref["pnl"], rtol=1e-9, atol=1e-6)
    for k in ("total_cost", "spread_cost", "impact_cost", "gross_notional"):
        torch.testing.assert_close(getattr(c, k), ref[k], rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails_the_committed_limits(workload):
    cell, limits = _cell(workload, 21)
    out = cell.call()
    cell.close()
    ref = cell.reference()
    r = dict(cell.readings(out, ref), **cell.final_readings(ref))
    assert set(r) == set(limits)
    assert not _over(r, limits), r

    cell, _ = _cell(workload, 21)
    out = cell.control_call()
    cell.close()
    r = dict(cell.readings(out, ref), **cell.final_readings(ref))
    assert _over(r, limits), r


def _grid_half_assets(real):
    def run(prices, mask, *a, **k):
        n = prices.shape[0] // 2
        return real(prices[:n], mask[:n], *a, **k)
    return run


def _grid_altered_answer(real):
    def run(*a, **k):
        g = real(*a, **k)
        s = g.spreads.clone()
        j, kk, m = (int(x[0]) for x in torch.nonzero(g.spread_valid, as_tuple=True))
        s[j, kk, m] += 1e-3
        return dataclasses.replace(g, spreads=s)
    return run


def _event_half_assets(real):
    def run(price, valid, score, adv, vol, **k):
        kept = score.clone()
        kept[score.shape[0] // 2:] = 0.0       # half of the names never trade
        return real(price, valid, kept, adv, vol, **k)
    return run


def _fill_altered(real):
    def fills(exec_base, side, traded, impact, spread):
        f = real(exec_base, side, traded, impact, spread)
        a, t = (int(x[0]) for x in torch.nonzero(traded, as_tuple=True))
        f[a, t] *= 1.001
        return f
    return fills


def _trade_dropped(real):
    def sides(valid, score, threshold):
        s = real(valid, score, threshold).clone()
        a, t = (int(x[0]) for x in torch.nonzero(s, as_tuple=True))
        s[a, t] = 0
        return s
    return sides


FAULTS = [
    ("jt93_crsp.grid_rank", grid_entry, "jk_grid_backtest", _grid_half_assets),
    ("jt93_crsp.grid_rank", grid_entry, "jk_grid_backtest", _grid_altered_answer),
    ("sp500_minutes.event_threshold", event_entry, "event_backtest", _event_half_assets),
    ("sp500_minutes.event_threshold", port_event, "market_fill_prices", _fill_altered),
    ("sp500_minutes.event_threshold", port_event, "threshold_sides", _trade_dropped),
    ("sp500_minutes.event_hysteresis", event_entry, "hysteresis_event_backtest",
     _event_half_assets),
    ("sp500_minutes.event_hysteresis", port_event, "market_fill_prices", _fill_altered),
]


@pytest.mark.parametrize("workload,module,name,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, _, _, f in FAULTS])
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch,
                                                   workload, module, name, fault):
    res, _ = run_cell(workload, 8, 0.2, False, device="cpu", root=tiny_root)
    assert res["correct"], res
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res, _ = run_cell(workload, 8, 0.2, False, device="cpu", root=tiny_root)
    assert not res["correct"], res
    assert res["attempted"] > 0


def test_outputs_keep_each_distinct_value_once_with_its_count():
    a = np.array([1.0, np.nan, 3.0], np.float32)
    b = np.array([1.0, np.nan, 4.0], np.float32)
    o = Outputs()
    for x in (a, a.copy(), b, a.copy(), a.copy()):
        o.add(x)
    assert o.n == 5
    assert sorted(n for _, n in o.groups.values()) == [1, 4]
