"""BENCHMARK.json against the benchmark's contract, and every cell's parts
found by name under ``perfbench/``."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT, edit_config

from perfbench.run import load_reader, resolve, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*size|_dim$|_rank$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_every_entry_has_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_by_name(workload):
    parts = resolve(BENCH, workload)
    pb = ROOT / "perfbench"
    t = parts["traffic"]
    assert (pb / "entries" / f"{t['entry']}.py").is_file()
    assert (pb / "reference" / f"{t['entry']}.py").is_file()
    e2e = {m["name"] for m in parts["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert parts["per_layer"]
    for m in parts["end_to_end"] + parts["per_layer"]:
        assert callable(load_reader(m["name"]).read)
    for m in parts["per_layer"]:
        assert m["moves"] in e2e, (workload, m["name"])


def test_a_layer_has_one_name():
    by_metric_family = {}
    for m in BENCH["per_layer"]:
        by_metric_family.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert by_metric_family["idle_share"] == {"device"}


def test_adding_a_config_traffic_and_metric_needs_new_files_only(tiny_root):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and new entries of BENCHMARK.json; no
    file of the harness is edited."""
    pb = tiny_root / "perfbench"
    cfg = json.loads((pb / "configs" / "sp500_minutes.json").read_text())
    cfg.update(name="dummy_minutes", n_assets=8)
    (pb / "configs" / "dummy_minutes.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "event_threshold.json").read_text())
    traffic["threshold"] = 5e-5
    (pb / "traffic" / "dummy_threshold.json").write_text(json.dumps(traffic))
    (pb / "limits" / "dummy_minutes.dummy_threshold.json").write_text(
        (pb / "limits" / "sp500_minutes.event_threshold.json").read_text())
    (pb / "metrics" / "dummy_traced_calls.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.n_calls) if ctx.trace else None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_minutes", "source": "a test",
                             "file": "perfbench/configs/dummy_minutes.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_minutes.dummy_threshold",
                               "config": "dummy_minutes",
                               "traffic": "dummy_threshold", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "event_call_ms":
            m["workloads"].append("dummy_minutes.dummy_threshold")
    bench["per_layer"].append({"name": "dummy_traced_calls", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "event_call_ms",
                               "workloads": ["dummy_minutes.dummy_threshold"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    edit_config(tiny_root, "dummy_minutes", n_days=2, minutes_per_day=30)
    res, _ = run_cell("dummy_minutes.dummy_threshold", 5, 0.2, False,
                      device="cpu", root=tiny_root)
    assert res["correct"], res
    assert set(res["metrics"]) == {"event_call_ms", "setup_s"}
    res, _ = run_cell("dummy_minutes.dummy_threshold", 6, 0.2, True,
                      device="cpu", root=tiny_root)
    assert res["correct"], res
    assert res["metrics"]["dummy_traced_calls"]["value"] >= 10
