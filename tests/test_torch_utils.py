"""The port's utils (logging, guards, profiling) and obs.memstats against
the reference's: ``validate_panel`` raises exactly where csmom_tpu's
does, ``checked`` keeps checkify's ``(err, out)`` contract on a NaN
output, ``get_logger`` honours ``CSMOM_LOG_LEVEL``, and the metrics
snapshot's per-shape ``memory`` block passes the reference's telemetry
validator."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csmom_tpu.utils import guards as ref_guards
from csmom_tpu_torch.utils import guards

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_T = np.arange(5).astype("datetime64[D]")
_V = np.arange(15, dtype=float).reshape(3, 5) + 1.0
_M = np.ones((3, 5), bool)


def _panel_case(name):
    v, m, t = _V.copy(), _M.copy(), _T.copy()
    if name == "shape":
        m = m[:, :4]
    elif name == "inf":
        v[1, 2] = np.inf
    elif name == "nan_under_valid":
        v[2, 1] = np.nan
    elif name == "nan_under_mask":
        v[2, 1], m[2, 1] = np.nan, False
    elif name == "times_length":
        t = t[:4]
    elif name == "times_order":
        t = t[::-1]
    elif name == "times_equal":
        t[3] = t[2]
    elif name == "dead_lane":
        v[0], m[0] = np.nan, False
    return v, m, t


@pytest.mark.parametrize("case", ["ok", "shape", "inf", "nan_under_valid",
                                  "nan_under_mask", "times_length",
                                  "times_order", "times_equal", "dead_lane"])
def test_validate_panel_raises_exactly_where_the_reference_does(case):
    v, m, t = _panel_case(case)

    def outcome(fn):
        try:
            fn(v, m, t, name="p")
        except ValueError as e:
            return str(e)
        return None

    want = outcome(ref_guards.validate_panel)
    assert outcome(guards.validate_panel) == want
    assert (want is None) == (case in ("ok", "nan_under_mask", "dead_lane"))


def test_validate_panel_warns_on_a_dead_lane(caplog):
    v, m, t = _panel_case("dead_lane")
    with caplog.at_level(logging.WARNING, logger="csmom_tpu_torch.guards"):
        guards.validate_panel(v, m, t, name="p")
    assert caplog.messages == ["p: 1 asset(s) fully masked (dead lanes)"]


def test_checked_throws_on_a_nan_output_and_passes_a_finite_one():
    g = guards.checked(lambda x: torch.log(x))
    err, out = g(torch.tensor([1.0, -1.0], dtype=torch.float64))
    assert torch.isnan(out[1]) and err.get() is not None
    with pytest.raises(ValueError, match="nan"):
        err.throw()
    err, out = g(torch.tensor([1.0, 2.0]))
    assert err.get() is None
    err.throw()  # nothing failed: no raise
    # a non-finite value nested in a dataclass result is found by its path
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest

    p = torch.full((4, 30), 100.0, dtype=torch.float64)
    p[:, 1:] += torch.arange(29, dtype=torch.float64)
    err, res = guards.checked(monthly_spread_backtest)(
        p, torch.ones_like(p, dtype=torch.bool), lookback=3, n_bins=2)
    assert err.get() is not None and "out.spread" in err.get()
    # the reference's checkify flags the same NaN-producing output
    ref_err, _ = ref_guards.checked(lambda x: __import__("jax").numpy.log(x))(
        np.array([1.0, -1.0]))
    with pytest.raises(Exception, match="nan"):
        ref_err.throw()


def test_checked_index_check_is_torchs_own():
    g = guards.checked(lambda x, i: x[i])
    with pytest.raises(IndexError):
        g(torch.zeros(3), torch.tensor(5))
    err, out = g(torch.zeros(3), torch.tensor(1))
    assert err.get() is None and float(out) == 0.0


@pytest.mark.parametrize("level,want", [("WARNING", logging.WARNING),
                                        ("debug", logging.DEBUG),
                                        ("bogus", logging.INFO),
                                        (None, logging.INFO)])
def test_get_logger_honours_csmom_log_level(level, want):
    env = {k: v for k, v in os.environ.items() if k != "CSMOM_LOG_LEVEL"}
    if level is not None:
        env["CSMOM_LOG_LEVEL"] = level
    code = ("from csmom_tpu_torch.utils import get_logger; "
            "lg = get_logger('x'); print(lg.name, lg.getEffectiveLevel())")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()
    assert out == ["csmom_tpu_torch.x", str(want)]


def test_profiling_helpers_on_the_cpu(tmp_path, caplog):
    from csmom_tpu_torch.utils import profiling

    out, s = profiling.wall(lambda a: a + 1, torch.ones(3), warmup=1)
    assert torch.equal(out, torch.full((3,), 2.0)) and s >= 0
    np.testing.assert_array_equal(profiling.fetch(torch.arange(3)), [0, 1, 2])
    assert profiling.measure_rtt(reps=3, device="cpu") > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.measure_rtt()
    a = profiling.compile_stats()
    assert a.delta(a).as_dict() == {"libraries_built_or_loaded": 0,
                                    "libraries_built": 0}
    with pytest.raises(RuntimeError, match='device="cuda"'):
        with profiling.count_dispatches():
            pass
    with caplog.at_level(logging.INFO, logger="csmom_tpu_torch.profiling"):
        with profiling.trace("blk", out_dir=str(tmp_path)):
            torch.ones(4).sum()
        with profiling.trace("plain"):
            pass
    assert (tmp_path / "blk.json").stat().st_size > 0
    assert [m.split(":")[0] for m in caplog.messages] == ["blk", "plain"]
    assert profiling.PEAK_HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}


def test_build_counts_fresh_builds_apart_from_loads(monkeypatch, tmp_path):
    """A fresh build counts in both counters, a load of an existing
    library only in ``libraries_built_or_loaded``."""
    import subprocess as sp

    from csmom_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            open(self.out, "wb").close()
            return "ok", None

    monkeypatch.setattr(sp, "Popen", FakeNvcc)
    built, both = build.libraries_built(), build.libraries_built_or_loaded()
    assert set(build.build(("decile_partial_sums",))) == {"decile_partial_sums"}
    assert build.build(("decile_partial_sums",)) == {}  # present: no build
    assert build.libraries_built() - built == 1
    assert build.libraries_built_or_loaded() - both == 1
    assert build.library_path("decile_partial_sums").exists()


def test_memstats_records_and_the_snapshot_form_passes_the_reference_validator():
    from csmom_tpu.chaos.invariants import KNOWN_TELEMETRY_SCHEMA_VERSIONS, validate
    from csmom_tpu_torch.obs import memstats, metrics

    memstats.reset()
    try:
        out, stats = memstats.measure(lambda: torch.ones(4) * 2, (torch.ones(4),), None)
        assert torch.equal(out, torch.full((4,), 2.0))
        assert isinstance(stats, str) and stats.startswith("not available")
        assert memstats.capture("cpu.entry", stats, platform="cpu") == stats
        gpu = {"argument_size_in_bytes": 64, "output_size_in_bytes": 8,
               "temp_size_in_bytes": 24, "peak_memory_in_bytes": 96,
               "peak_bytes": 96, "peak_source": "peak_memory_in_bytes"}
        rec = memstats.capture("gpu.entry", gpu, platform="gpu")
        assert rec == {**gpu, "platform": "gpu"} and "platform" not in gpu
        assert memstats.peak_bytes(rec) == 96 and memstats.peak_bytes(stats) is None
        assert memstats.snapshot() == {"cpu.entry": stats, "gpu.entry": rec}
        assert memstats.nbytes((torch.ones(4), {"a": torch.zeros(2, dtype=torch.int8)})) == 18
        snap = metrics.snapshot()
        assert snap["memory"] == memstats.snapshot() and "allocator" not in snap
        sidecar = {"run_id": "x", "schema_version": max(KNOWN_TELEMETRY_SCHEMA_VERSIONS),
                   "wall_s": 1.0, "phases": [{"name": "a", "dur_s": 1.0}],
                   "metrics": snap}
        assert validate(sidecar, kind="telemetry") == []
        # a malformed entry is what the reference's validator refuses
        memstats.record("bad", {"peak_bytes": "96"})
        sidecar["metrics"] = metrics.snapshot()
        assert validate(sidecar, kind="telemetry") != []
    finally:
        memstats.reset()
    assert "memory" not in metrics.snapshot()
