"""Faults 4-6 of ROADMAP.md's Queue 3 and the ``Panel.device`` rename
(known difference 78), each held against csmom_tpu on the same input.

- fault 4: ``MonthlyReport.spread_series()`` equals the reference's
  Series (index, name ``spread``, values at ``rtol=1e-10, atol=1e-13``)
  on the 30 x 48 toy panel of ``tests/test_backends.py``, for the card
  engine on the CPU and for the pandas engine;
- fault 5: ``EngineSpec(sharded_fn=)`` wins over the rule table in both
  packages, gives a strategy (no rule) a sharded variant, and
  ``registry list`` lists ``sharded`` for it where the reference does;
- fault 6: the ``bench`` parsers of both packages take the same argv of
  the common flags; the port's bench ignores them;
- rename 78: ``Panel.device(dtype, device=)`` is ``Panel.tensors``.
"""

import argparse

import numpy as np
import pandas as pd
import pytest
import torch

from csmom_tpu.backends import run_monthly as ref_run_monthly
from csmom_tpu.panel.panel import Panel as RefPanel
from csmom_tpu_torch.backends.dispatch import run_monthly
from csmom_tpu_torch.cli.main import build_parser, main
from csmom_tpu_torch.panel.panel import Panel

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-13)


def _toy(cls, a=30, m=48):
    """tests/test_backends.py's toy panel (late listings, no gaps)."""
    rng = np.random.default_rng(20240531)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.004, 0.06, size=(a, m)), axis=1))
    prices[: a // 5, : m // 4] = np.nan
    times = np.array([np.datetime64("2000-01-31") + 31 * i for i in range(m)])
    return cls.from_dense(prices, [f"T{i:03d}" for i in range(a)], times)


@pytest.mark.parametrize("backend,ref_backend", [("torch", "tpu"),
                                                 ("pandas", "pandas")])
def test_fault_4_spread_series_equals_the_references(backend, ref_backend):
    rep = run_monthly(_toy(Panel), lookback=3, n_bins=5, backend=backend,
                      device="cpu")
    ref = ref_run_monthly(_toy(RefPanel), lookback=3, n_bins=5,
                          backend=ref_backend)
    got, want = rep.spread_series(), ref.spread_series()
    assert len(got) == np.isfinite(rep.spread).sum() > 0
    assert got.name == want.name == "spread"
    pd.testing.assert_index_equal(got.index, want.index, exact=True)
    pd.testing.assert_series_equal(got, want, check_exact=False, **F64)


def _surfaces(text, name):
    """The surfaces of one engine's row in a registry listing."""
    row = next(ln for ln in text.splitlines() if ln.split()[:1] == [name])
    return row.split()[1:]


def test_fault_5_an_explicit_sharded_fn_wins_in_both_packages(capsys):
    from csmom_tpu import registry as ref_registry
    from csmom_tpu.cli.registry import cmd_registry as ref_cmd_registry
    from csmom_tpu.registry.core import EngineSpec as RefSpec
    from csmom_tpu.strategy.builtin import Momentum as RefMomentum
    from csmom_tpu_torch import registry
    from csmom_tpu_torch.registry.core import EngineSpec
    from csmom_tpu_torch.strategy.builtin import Momentum

    def sharded(*args, **kwargs):
        return ("sharded", args, kwargs)

    # a strategy matches no partition rule: sharded_fn gives it one
    for spec in (EngineSpec(name="toy", kind="strategy", strategy_cls=Momentum,
                            sharded_fn=sharded),
                 RefSpec(name="toy", kind="strategy", strategy_cls=RefMomentum,
                         sharded_fn=sharded)):
        assert spec.sharded(4, axis="assets") == ("sharded", (4,),
                                                   {"axis": "assets"})
    with pytest.raises(NotImplementedError, match="no sharded variant"):
        EngineSpec(name="toy", kind="strategy", strategy_cls=Momentum).sharded()
    # it wins over the rule table: a serve engine's rule is not asked
    spec = registry.get_engine("momentum", kind="serve")
    import dataclasses

    assert dataclasses.replace(spec, sharded_fn=sharded).sharded(2) == (
        "sharded", (2,), {})

    def manifest(profile, dtype):
        return []

    def listed(reg, unreg, show, fn):
        reg(name="toy.compile", kind="compile", profiles=("toy-profile",),
            manifest_fn=manifest, sharded_fn=fn, replace=True)
        try:
            return _surfaces(show(), "toy.compile")
        finally:
            unreg("toy.compile", kind="compile")

    def port_show():
        assert main(["registry", "list", "--kind", "compile"]) == 0
        return capsys.readouterr().out

    def ref_show():
        assert ref_cmd_registry(argparse.Namespace(
            action="list", kind="compile", endpoints=False, terse=True)) == 0
        return capsys.readouterr().out

    port = [listed(registry.register_engine, registry.unregister_engine,
                   port_show, fn) for fn in (None, sharded)]
    ref = [listed(ref_registry.register_engine, ref_registry.unregister_engine,
                  ref_show, fn) for fn in (None, sharded)]
    # no rule matches the toy engine: the port lists no sharded variant
    # (the reference its sharded:stub) until sharded_fn declares one
    assert port == [["manifest(toy-profile)"], ["manifest(toy-profile)", "sharded"]]
    assert ref == [["manifest(toy-profile)", "sharded:stub"],
                   ["manifest(toy-profile)", "sharded"]]


BENCH_ARGV = ["bench", "--config", "run.toml", "--data-dir", "cache",
              "--tickers", "AAA,BBB", "--out", "results", "--backend", "tpu",
              "--lookback", "6", "--skip", "1", "--n-bins", "5", "--mode", "rank"]


def test_fault_6_bench_takes_the_references_common_flags(monkeypatch):
    from csmom_tpu.cli.main import build_parser as ref_build_parser

    got = vars(build_parser().parse_args(BENCH_ARGV))
    want = vars(ref_build_parser().parse_args(BENCH_ARGV))
    common = ("config", "data_dir", "tickers", "out", "backend", "lookback",
              "skip", "n_bins", "mode")
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["device"] == "cuda"      # the port's own flag stays
    # ... and the bench ignores them: its supervisor gets --device only
    import subprocess

    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda argv, env=None: calls.append(argv) or 0)
    assert main(BENCH_ARGV + ["--device", "cpu"]) == 0
    assert [c[1:] for c in calls] == [["-m", "csmom_tpu_torch.bench",
                                       "--device", "cpu"]]


def test_rename_78_panel_device_is_panel_tensors():
    panel = _toy(Panel, a=6, m=12)
    v, m = panel.device(torch.float32, device="cpu")
    tv, tm = panel.tensors(device="cpu", dtype=torch.float32)
    assert v.dtype == torch.float32 and torch.equal(torch.nan_to_num(v, 7.0),
                                                    torch.nan_to_num(tv, 7.0))
    assert torch.equal(m, tm)
    # the reference's call shape: Panel.device(dtype) alone
    ref_v, ref_m = _toy(RefPanel, a=6, m=12).device(np.float64)
    v64, m64 = panel.device(device="cpu")
    np.testing.assert_array_equal(v64.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(m64.numpy(), np.asarray(ref_m))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            panel.device()
