"""The intraday cell (``sp500_intraday.ridge_event``) on the CPU at a small
size: its parts found from files alone, its host operations under each
call, and planted faults in the timed path, each of which comes out not
correct against the committed limits.

Importing this module registers the configuration's CPU size in
``conftest.TINY``, so that the harness's tests that take every cell
(``tiny_root``, the control against the committed limits, the traced CPU
run) cut this cell too.
"""

from __future__ import annotations

import inspect
import json
import textwrap

import pytest
import torch
from conftest import ROOT, TINY

import perfbench.entries.intraday as intraday_entry
from csmom_tpu_torch.models import ridge as port_ridge
from csmom_tpu_torch.signals import intraday as port_signals
from perfbench import load
from perfbench.run import load_reader, resolve, run_cell
from perfbench.trace import capture, named_stretch

WORKLOAD = "sp500_intraday.ridge_event"
# 16 names x 2 days: ~12,000 modeling rows, so a one-row fold shift, the
# missing penalty (alpha over ~8,500 training rows) and the ddof-1 scaler
# (1 / (2 * 8,500)) each move the fit by ~1e-5 or more
TINY.setdefault("sp500_intraday", {"n_assets": 16, "n_days": 2})
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PHASES = ["intraday.features", "intraday.fit", "intraday.scatter",
          "event.decide", "event.fill", "event.settle", "event.costs"]
METRICS = ["device_ms_per_call.intraday", "launches_per_call.intraday",
           "idle_share.intraday", "intraday_roofline", "idle_ms.intraday_features",
           "idle_ms.intraday_fit", "idle_ms.intraday_scatter"]


def _cell(seed=7):
    parts = resolve(BENCH, WORKLOAD)
    cfg = dict(parts["config"], **TINY["sp500_intraday"])
    return load("entries", parts["traffic"]["entry"]).Cell(cfg, parts["traffic"],
                                                          seed, "cpu")


def test_the_cell_resolves_from_its_files():
    parts = resolve(BENCH, WORKLOAD)
    w, cfg, traffic = parts["workload"], parts["config"], parts["traffic"]
    assert (w["config"], w["traffic"], w["chips"]) == ("sp500_intraday",
                                                      "intraday_ridge_event", 1)
    (entry,) = [c for c in BENCH["configs"] if c["name"] == "sp500_intraday"]
    assert entry["file"] == "perfbench/configs/sp500_intraday.json"
    assert cfg["reduced"] == entry["reduced"] == []
    assert (cfg["generator"], cfg["dtype"], traffic["entry"], traffic["model"]) == (
        "minute_bars_volume", "float64", "intraday", "ridge")
    assert [m["name"] for m in parts["end_to_end"]] == ["event_call_ms", "setup_s"]
    assert [m["name"] for m in parts["per_layer"]] == METRICS
    for m in parts["end_to_end"] + parts["per_layer"]:
        assert callable(load_reader(m["name"]).read)
    assert all(m["moves"] == "event_call_ms" for m in parts["per_layer"])
    cell = _cell()
    out = cell.call()
    cell.close()
    ref = cell.reference()
    r = dict(cell.readings(out, ref), **cell.final_readings(ref))
    assert set(r) == set(parts["limits"])
    assert set(cell.work(ref)) == {"intraday_bytes"}


def test_the_phases_and_the_fetch_are_the_calls_host_operations():
    """Under each ``perfbench.call``: the pipeline's three spans, the
    engine's four and the entry's one fetch range, so that the idle gaps
    have at most ten owners with the harness's own two."""
    cell = _cell()
    cell.call()
    _, prof, _ = capture(cell.call, 2, False, True)
    named = named_stretch(prof.events())
    assert len(named.calls) == 2
    assert [n for n, _, _ in named.host_ops] == (PHASES + [intraday_entry.FETCH]) * 2


def _source_fault(module, name, old, new):
    """``module.name`` recompiled from its source with ``old`` replaced by
    ``new`` (which must occur once), in the module's namespace."""
    src = textwrap.dedent(inspect.getsource(getattr(module, name)))
    assert src.count(old) == 1, (name, old)
    ns = dict(vars(module))
    exec(compile(src.replace(old, new), inspect.getsourcefile(module), "exec"), ns)
    return ns[name]


def _window_off_by_one(monkeypatch):
    real = port_signals.minute_features
    monkeypatch.setattr(port_signals, "minute_features",
                        lambda p, v, rv, window: real(p, v, rv, window=window + 1))


def _fold_boundary_off_by_one(monkeypatch):
    monkeypatch.setattr(port_ridge, "time_series_cv_harness", _source_fault(
        port_ridge, "time_series_cv_harness", "tr = train & (ordinal < test_start)",
        "tr = train & (ordinal < test_start - 1)"))


def _ridge_without_penalty(monkeypatch):
    real = port_ridge._masked_ridge
    monkeypatch.setattr(port_ridge, "_masked_ridge",
                        lambda Xs, y, w, alpha: real(Xs, y, w, 0.0))


def _scaler_ddof_one(monkeypatch):
    monkeypatch.setattr(port_ridge, "time_series_cv_harness", _source_fault(
        port_ridge, "time_series_cv_harness", "var = (w_tr @ (Xf - mean) ** 2) / n_tr",
        "var = (w_tr @ (Xf - mean) ** 2) / (n_tr - 1)"))


def _body_in_float32(monkeypatch):
    real = intraday_entry.intraday_on_device

    def run(price, volume, row_valid, time_idx, n_minutes, adv, vol, **kw):
        f32 = torch.float32
        return real(price.to(f32), volume.to(f32), row_valid, time_idx, n_minutes,
                    adv.to(f32), vol.to(f32), **kw)

    monkeypatch.setattr(intraday_entry, "intraday_on_device", run)


FAULTS = [_window_off_by_one, _fold_boundary_off_by_one, _ridge_without_penalty,
          _scaler_ddof_one, _body_in_float32]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_a_planted_fault_comes_out_not_correct(tiny_root, monkeypatch, fault):
    res, _ = run_cell(WORKLOAD, 2**31 + 9, 0.2, False, device="cpu", root=tiny_root)
    assert res["correct"], res
    fault(monkeypatch)
    res, checks = run_cell(WORKLOAD, 2**31 + 9, 0.2, False, device="cpu", root=tiny_root)
    assert not res["correct"], res
    assert res["attempted"] > 0
    assert any(c["value"] > c["limit"] for c in checks.values())
