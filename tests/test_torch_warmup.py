"""The port's warm-start (csmom_tpu_torch.compile, registry kind
``compile``, the CLI's ``warmup``) against csmom_tpu's: the same manifest
names and shapes for every profile under the stated renaming (impls
``xla``/``pallas`` -> ``plain``/``kernel``, profile ``bench-tpu`` ->
``bench-gpu``), donated entries included, every ``smoke`` entry equal to the
reference's entry on the same seeded inputs, and a CPU warm-up that
writes its report.  Tolerances: f64 ``rtol=1e-10, atol=1e-13``, integers
equal."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.compile.manifest import build_manifest as ref_build_manifest
from csmom_tpu_torch.cli.main import main
from csmom_tpu_torch.compile import manifest
from csmom_tpu_torch.compile.aot import aot_compile, read_warmup_report, warmup

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-13)


def _port_name(name):
    return name.replace(".xla", ".plain").replace(".pallas", ".kernel")


def _reference_rows(profile):
    return [(_port_name(e.name),
             e.shape_summary().replace("impl='xla'", "impl='plain'"))
            for e in ref_build_manifest(profile)]


@pytest.mark.parametrize("profile", ["smoke", "golden", "serve-smoke",
                                     "stream-smoke", "bench-cpu", "serve",
                                     "stream"])
def test_manifest_names_and_shapes_equal_the_references(profile):
    entries = manifest.build_manifest(profile)
    for e in entries:
        e.validate()
    got = [(e.name, e.shape_summary()) for e in entries]
    assert got == _reference_rows(profile)
    assert len({n for n, _ in got}) == len(got)


def test_bench_gpu_lists_the_references_bench_tpu(capsys):
    """``warmup --list`` needs no card; ``bench-tpu`` is ``bench-gpu``."""
    want = _reference_rows("bench-tpu")
    for name in ("bench-gpu", "bench-tpu"):
        assert main(["warmup", "--list", "--profiles", name]) == 0
        rows = [ln.split(None, 2) for ln in capsys.readouterr().out.splitlines()]
        assert [r[0] for r in rows] == ["bench-gpu"] * len(want)
        assert [(r[1], r[2]) for r in rows] == want
    kinds = {e.name: e.kernels for e in manifest.build_manifest("bench-gpu")}
    assert kinds["grid.jk16.rank.kernel@3000x696"] == ("cohort_partial_sums",
                                                       "rank_labels")
    # every rank-mode entry launches K3 on the card, whatever its K2 impl
    assert {k: v for k, v in kinds.items() if v} == {
        k: (("cohort_partial_sums",) if ".kernel@" in k else ()) + ("rank_labels",)
        for k in kinds if ".rank." in k} | {"grid.net_core@3000x696": ("rank_labels",)}


def test_manifest_drift_raises_type_error():
    def engine(price, mask, *, n_bins=10):
        return price

    stale = manifest.ManifestEntry(
        name="drifted", fn=engine,
        args=(manifest.sds((4, 8), np.float32), manifest.sds((4, 8), bool)),
        kwargs={"renamed_param": 3})
    with pytest.raises(TypeError):
        stale.validate()


def test_unknown_and_mesh_profiles_are_refused(capsys):
    with pytest.raises(ValueError, match="unknown warmup profile"):
        manifest.build_manifest("no-such-profile")
    assert "smoke" in manifest.PROFILES and "bench-tpu" not in manifest.PROFILES
    # the serve mesh profiles are ported: the sharded serve grid on the
    # visible cards (one logical CPU shard without a card), K1 named
    for profile in ("serve-mesh", "serve-mesh-smoke"):
        entries = manifest.build_manifest(profile)
        assert len(entries) == (31 if profile == "serve-mesh" else 11)
        assert main(["warmup", "--profiles", profile, "--device", "cpu",
                     "--list"]) == 0
        assert "mesh.serve.backtest.b1@" in capsys.readouterr().out
    # bench-mesh is ported: the sharded grid on the visible cards (one
    # logical CPU shard without a card), K2 named
    assert [(e.name, e.kernels) for e in manifest.build_manifest("bench-mesh")] == [
        ("mesh.grid.jk16.rank.kernel@512x174.g1a1",
         ("cohort_partial_sums", "rank_labels")),
        ("mesh.grid.jk16.rank.kernel@3000x696.g1a1",
         ("cohort_partial_sums", "rank_labels"))]
    assert main(["warmup", "--profiles", "nope", "--device", "cpu"]) == 2
    assert "unknown profile" in capsys.readouterr().err


def test_materialized_leaves_follow_the_contract():
    e = manifest.grid_net_entry(16, 48, np.float64, tag="16x48")
    args, _ = e.materialize("cpu", np.random.default_rng(0))
    p, m, Js, spreads, valid, hs = args
    assert p.dtype == torch.float64 and bool((p > 0).all())
    assert bool(m.all()) and bool(valid.all())
    assert Js.tolist() == [3, 6, 9, 12] and Js.dtype == torch.int64
    assert hs == 1.0
    mon = manifest.monthly_entries(8, 24, np.float64, tag="8x24")[2]
    labels, counts, *_ = mon.materialize("cpu", np.random.default_rng(0))[0]
    assert labels.dtype == torch.int32 and not labels.any() and not counts.any()


def _smoke_pairs():
    ref = {_port_name(e.name): e for e in ref_build_manifest("smoke")}
    return [(e, ref[e.name]) for e in manifest.build_manifest("smoke")]


def _leaves(x):
    """Numpy leaves of a result (a tensor, a jax array, a tuple, a
    dataclass), in field order."""
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _leaves(getattr(x, f.name))]
    if isinstance(x, (jax.Array, np.ndarray)):
        return [np.asarray(x)]
    return []


@pytest.mark.parametrize("name", [e.name for e in manifest.build_manifest("smoke")])
def test_smoke_entry_equals_the_references_on_the_same_inputs(name):
    port, ref = next((p, r) for p, r in _smoke_pairs() if p.name == name)
    args, kwargs = port.numpy_inputs(np.random.default_rng(7))
    got = port.fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in args), **kwargs)
    # the reference's entry functions are jitted (statics declared); its
    # impl names are xla/pallas
    want = ref.fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args),
                  **{k: {"plain": "xla"}.get(v, v) if k == "impl" else v
                     for k, v in kwargs.items()})
    g, w = _leaves(got), _leaves(want)
    if name.startswith("grid.net_core"):
        g, w = g[:6], w[:6]  # the result's data fields; Js/Ks/skip aside
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, **F64, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


def test_batched_event_sums_its_single_calls():
    from csmom_tpu_torch.backtest.event import event_backtest
    from csmom_tpu_torch.compile.entries import batched_event_fn

    e = manifest.event_entries(4, 32, np.float64, tag="4x32")[0]
    (p, v, s, a, vo), _ = e.materialize("cpu", np.random.default_rng(3))
    bscore = torch.stack([s, -s, 0.5 * s])
    got = batched_event_fn(3)(p, v, bscore, a, vo)
    want = sum(float(event_backtest(p, v, sc, a, vo).total_pnl) for sc in bscore)
    np.testing.assert_allclose(float(got), want, **F64)
    with pytest.raises(ValueError, match="not 3"):
        batched_event_fn(3)(p, v, bscore[:2], a, vo)


def test_cpu_warmup_writes_and_reads_back_its_report(monkeypatch, tmp_path):
    from csmom_tpu_torch.compile import aot
    from csmom_tpu_torch.obs import memstats

    monkeypatch.setattr(aot, "report_dir", lambda subdir: str(tmp_path / subdir))
    memstats.reset()
    try:
        rep = warmup(("smoke",), device="cpu", subdir="t")
    finally:
        memstats.reset()
    entries = manifest.build_manifest("smoke")
    assert rep["n_entries"] == len(entries) == len(rep["entries"])
    assert rep["n_errors"] == 0 and rep["n_cache_hits"] == len(entries)
    assert rep["platform"] == "cpu" and rep["profiles"] == ["smoke"]
    assert isinstance(rep["memory"], str) and rep["memory"].startswith("not measured")
    assert rep["golden_event"].startswith("skipped")
    for r, e in zip(rep["entries"], entries):
        assert r["name"] == e.name and r["shapes"] == e.shape_summary()
        assert r["profile"] == "smoke" and r["cache_hit"] is True
        assert isinstance(r["memory"], str) and r["libraries_built"] == 0
        assert r["launches"] == {"decile_partial_sums": 0, "cohort_partial_sums": 0,
                                 "rank_labels": 0}
        assert r["first_call_s"] >= 0 and r["warm_call_s"] >= 0
    assert read_warmup_report("t") == json.loads(
        (tmp_path / "t" / "warmup_report.json").read_text())
    assert read_warmup_report("none").startswith("not available")


def test_a_failing_entry_is_recorded_and_strict_fails_the_command(monkeypatch, capsys):
    from csmom_tpu_torch.compile import aot

    def boom(entry, device=None, seed=0):
        if entry.name.startswith("event.threshold@"):
            raise RuntimeError("broken entry")
        return {"name": entry.name, "cache_hit": True}

    monkeypatch.setattr(aot, "aot_compile", boom)
    rep = warmup(("smoke",), device="cpu", write_report=False)
    assert rep["n_errors"] == 1
    bad = [r for r in rep["entries"] if "error" in r]
    assert bad[0]["error"] == "RuntimeError: broken entry"
    monkeypatch.setattr(aot, "warmup", lambda **kw: rep)
    assert main(["warmup", "--profiles", "smoke", "--device", "cpu"]) == 0
    assert main(["warmup", "--profiles", "smoke", "--device", "cpu", "--strict"]) == 1
    assert "ERROR RuntimeError: broken entry" in capsys.readouterr().out


@pytest.mark.parametrize("leg", ["input_builders", "golden_event"])
def test_a_failing_input_leg_is_noted_and_strict_fails_the_command(
        leg, monkeypatch, capsys):
    """The grid's month inputs and the golden-event leg are no manifest
    entries: a failure there is noted in the report, and ``--strict``
    still exits 1."""
    from csmom_tpu_torch.compile import aot
    from csmom_tpu_torch.compile import workloads as wl

    def boom(*a, **kw):
        raise RuntimeError(f"broken {leg}")

    monkeypatch.setattr(manifest, "build_manifest", lambda profile: [])
    monkeypatch.setattr(manifest, "golden_event_entries", lambda *a, **kw: [])
    monkeypatch.setattr(wl, "grid_month_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(*{"input_builders": (wl, "grid_month_inputs", boom),
                          "golden_event": (manifest, "golden_event_entries",
                                           boom)}[leg])
    rep = warmup(("bench-cpu",), device="cpu", write_report=False)
    assert rep["n_errors"] == 0
    assert rep[leg] == f"failed: RuntimeError: broken {leg}"
    other = ({"input_builders", "golden_event"} - {leg}).pop()
    assert not rep[other].startswith("failed")
    monkeypatch.setattr(aot, "warmup", lambda **kw: rep)
    assert main(["warmup", "--profiles", "bench-cpu", "--device", "cpu"]) == 0
    assert main(["warmup", "--profiles", "bench-cpu", "--device", "cpu",
                 "--strict"]) == 1
    assert f"failed: RuntimeError: broken {leg}" in capsys.readouterr().out


def test_aot_compile_on_the_cpu_runs_the_entry_twice():
    e = manifest.build_manifest("smoke")[0]
    rec = aot_compile(e, device="cpu")
    assert rec["name"] == e.name and rec["cache_hit"] and rec["build_s"] >= 0
    assert set(rec) >= {"shapes", "first_call_s", "warm_call_s", "memory",
                        "libraries_built", "launches"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            aot_compile(e)


def test_warmup_cli_on_the_cpu_and_without_a_card(capsys, monkeypatch, tmp_path):
    from csmom_tpu_torch.compile import aot

    monkeypatch.setattr(aot, "report_dir", lambda subdir: str(tmp_path / subdir))
    assert main(["warmup", "--profiles", "smoke", "--device", "cpu", "--strict"]) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(manifest.build_manifest("smoke"))
    assert sum(ln.endswith("  HIT") for ln in out) == n
    assert f"{n} entries, {n} served from cache, 0 errors in" in "\n".join(out)
    assert any(ln.startswith("cache: ") for ln in out)
    if not torch.cuda.is_available():
        assert main(["warmup", "--profiles", "smoke"]) == 2
        assert "--device cpu" in capsys.readouterr().err


def test_registry_lists_the_eight_compile_engines(capsys):
    from csmom_tpu.registry import engine_specs as ref_specs
    from csmom_tpu_torch.registry import engine_specs, entry_factory

    assert main(["registry", "list", "--kind", "compile"]) == 0
    out = capsys.readouterr().out
    names = [ln.split()[0] for ln in out.splitlines()
             if ln.startswith("  ") and not ln.startswith(" " * 24)]
    want = ["grid.jk", "grid.net_core", "monthly.kernels", "event.panel",
            "parallel.histrank", "parallel.online_ridge", "serve.buckets",
            "stream.signals", "mesh.serve", "mesh.grid"]
    assert names == want == [s.name for s in engine_specs("compile")]
    assert [s.name for s in ref_specs("compile")] == want
    assert out.startswith("compile (10):")
    assert entry_factory("grid.jk")(tuple(), tuple(), 1, "rank", "plain") is \
        entry_factory("grid.jk")(tuple(), tuple(), 1, "rank", "plain")
    with pytest.raises(KeyError, match="no entry factory"):
        entry_factory("grid.net_core")


def test_serve_entry_names_match_the_manifest():
    from csmom_tpu_torch.registry import manifest_entry_names

    for profile in ("serve", "serve-smoke"):
        assert manifest_entry_names(profile) == {
            e.name for e in manifest.build_manifest(profile)}
    assert manifest_entry_names("smoke") == set()


def test_grid_month_inputs_and_months_in_days(tmp_path, monkeypatch):
    from csmom_tpu_torch.compile import workloads as wl

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert wl.months_in_days(3780) == manifest.months_of(3780) == 174
    pm, mm, M, s = wl.grid_month_inputs(40, 300, torch.float64, device="cpu")
    assert pm.shape == (40, M) and mm.dtype == torch.bool and s >= 0
    want, wmask, ends = wl.month_panel(40, 300, device="cpu", dtype=torch.float64)
    assert M == len(ends) and torch.equal(mm, wmask)
    torch.testing.assert_close(pm, want, rtol=0, atol=0, equal_nan=True)
    assert os.listdir(tmp_path) == [os.path.basename(wl.ensure_pack(40, 300))]
    dev, on_cpu, dt = wl.bench_device("cpu")
    assert (str(dev), on_cpu, dt) == ("cpu", True, torch.float64)


def test_warmup_cli_arms_spans_from_the_env_and_names_the_sidecar_item(
        capsys, monkeypatch, tmp_path):
    from csmom_tpu_torch import obs
    from csmom_tpu_torch.compile import aot

    monkeypatch.setattr(aot, "report_dir", lambda subdir: str(tmp_path / subdir))
    monkeypatch.chdir(tmp_path)  # the sidecar lands in the working directory
    monkeypatch.delenv("CSMOM_TELEMETRY_DIR", raising=False)
    stream = tmp_path / "events.jsonl"
    monkeypatch.setenv("CSMOM_TELEMETRY", str(stream))
    try:
        assert main(["warmup", "--profiles", "smoke", "--device", "cpu"]) == 0
    finally:
        obs.disarm()
    out = capsys.readouterr().out
    (sidecar,) = [p.name for p in tmp_path.glob("GPU_TELEMETRY_*.json")]
    assert f"telemetry: {sidecar}" in out
    events = [json.loads(ln) for ln in stream.read_text().splitlines()]
    names = {e.get("name") for e in events}
    assert {"warmup.cli", "warmup.entry", "aot.compile"} <= names
    spans = {a["name"] for a in json.loads(
        (tmp_path / sidecar).read_text())["spans"]}
    assert {"warmup.cli", "warmup.entry", "aot.compile"} <= spans
