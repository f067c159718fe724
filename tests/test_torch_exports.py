"""The port's package-level exports against the reference's.

For every package of ``csmom_tpu_torch`` that has a counterpart in
``csmom_tpu``, each name in the counterpart's ``__all__`` resolves from
the port's package, except the names an open ROADMAP.md Queue 1 item
owns, listed below by item.  Importing a package in a fresh interpreter
loads neither pandas nor torch: the names resolve on first use.
"""

import importlib
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names of the reference's exports that an open Queue 1 item brings,
# by package (no open item owns one)
OWNED: dict = {}

PACKAGES = ("analytics", "backtest", "backends", "costs", "ops", "signals",
            "utils", "registry", "obs", "parallel", "serve", "strategy",
            "models", "panel", "stream", "mesh", "analysis")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_reference_export_resolves(pkg):
    ref = importlib.import_module(f"csmom_tpu.{pkg}")
    port = importlib.import_module(f"csmom_tpu_torch.{pkg}")
    owned = OWNED.get(pkg, {})
    missing = [n for n in ref.__all__
               if n not in owned and not hasattr(port, n)]
    assert missing == [], f"csmom_tpu_torch.{pkg} lacks {missing}"
    # an owned name is not silently half-ported: it is absent
    assert [n for n in owned if hasattr(port, n)] == []
    assert set(owned) <= set(ref.__all__)
    assert set(getattr(port, "__all__", ())) >= (set(ref.__all__)
                                                 - set(owned))


@pytest.mark.parametrize("pkg,name,module", [
    ("signals", "momentum", "csmom_tpu_torch.signals.momentum"),
    ("analytics", "tearsheet", "csmom_tpu_torch.analytics.tearsheet"),
])
def test_an_export_named_like_its_submodule_is_the_function(pkg, name,
                                                            module):
    """As in the reference, the package's attribute is the function,
    also after the submodule of the same name was imported."""
    mod = importlib.import_module(module)
    port = importlib.import_module(f"csmom_tpu_torch.{pkg}")
    assert getattr(port, name) is getattr(mod, name)
    assert callable(getattr(port, name))


def test_registry_strategies_are_the_strategy_zoo():
    from csmom_tpu import registry as ref_registry
    from csmom_tpu_torch import registry
    from csmom_tpu_torch.strategy.base import available_strategies

    zoo = registry.strategies()
    assert zoo == available_strategies()
    # the reference's builtin zoo: its own tests leave plugins registered
    # in its global zoo when they share this process
    assert sorted(zoo) == sorted(
        n for n, cls in ref_registry.strategies().items()
        if cls.__module__ == "csmom_tpu.strategy.builtin")


@pytest.mark.parametrize("pkg", ("analytics", "backtest", "backends",
                                 "costs", "ops", "signals", "utils",
                                 "registry", "obs", "parallel", "serve",
                                 "chaos", "panel", "cli", "stream",
                                 "compile", "examples", "mesh",
                                 "analysis"))
def test_package_import_loads_neither_pandas_nor_torch(pkg):
    code = (f"import sys, csmom_tpu_torch.{pkg}; "
            "print(sorted({'torch', 'pandas'} & set(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       env={**os.environ, "PYTHONPATH": _REPO},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]", (pkg, p.stdout)


@pytest.mark.parametrize("pkg,name,module", [
    ("serve", "FleetConfig", "csmom_tpu_torch.serve.fleet"),
    ("serve", "FleetController", "csmom_tpu_torch.serve.fleet"),
    ("serve", "AutoscalerPolicy", "csmom_tpu_torch.serve.fleet"),
    ("serve", "PreforkServer", "csmom_tpu_torch.serve.fleet"),
    ("obs", "fleet", None),
])
def test_the_fleet_exports_resolve(pkg, name, module):
    """The elastic tier's classes resolve from ``csmom_tpu_torch.serve``
    and the observatory from ``csmom_tpu_torch.obs``, each listed in the
    package's ``__all__``; the observatory needs neither torch nor
    pandas, so a router replica can arm it."""
    port = importlib.import_module(f"csmom_tpu_torch.{pkg}")
    assert name in port.__all__
    if module is None:
        assert getattr(port, name) is importlib.import_module(
            f"csmom_tpu_torch.{pkg}.{name}")
    else:
        assert getattr(port, name) is getattr(
            importlib.import_module(module), name)
    code = ("import sys, csmom_tpu_torch.obs.fleet, "
            "csmom_tpu_torch.serve.fleet, csmom_tpu_torch.cli.fleet; "
            "print(sorted({'torch', 'pandas'} & set(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       env={**os.environ, "PYTHONPATH": _REPO},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("pkg,name,module", [
    ("utils", "get_logger", "csmom_tpu_torch.utils.logging"),
    ("utils", "validate_panel", "csmom_tpu_torch.utils.guards"),
    ("utils", "checked", "csmom_tpu_torch.utils.guards"),
    ("utils", "wall", "csmom_tpu_torch.utils.profiling"),
    ("utils", "fetch", "csmom_tpu_torch.utils.profiling"),
    ("utils", "measure_rtt", "csmom_tpu_torch.utils.profiling"),
    ("utils", "trace", "csmom_tpu_torch.utils.profiling"),
    ("registry", "manifest_entries", "csmom_tpu_torch.registry"),
    ("registry", "manifest_entry_names", "csmom_tpu_torch.registry"),
    ("registry", "manifest_profiles", "csmom_tpu_torch.registry"),
    ("registry", "entry_factory", "csmom_tpu_torch.registry"),
    ("obs", "memstats", None),
    ("compile", "ManifestEntry", "csmom_tpu_torch.compile.manifest"),
    ("compile", "build_manifest", "csmom_tpu_torch.compile.manifest"),
    ("compile", "aot_compile", "csmom_tpu_torch.compile.aot"),
    ("compile", "warmup", "csmom_tpu_torch.compile.aot"),
])
def test_the_warm_start_and_utils_exports_resolve(pkg, name, module):
    """The names of ROADMAP.md items 8a, 8e and 8b's profiling resolve
    from their packages to the modules that define them; the compile
    package exports what ``csmom_tpu.compile`` imports."""
    port = importlib.import_module(f"csmom_tpu_torch.{pkg}")
    assert name in port.__all__
    if module is None:
        assert getattr(port, name) is importlib.import_module(
            f"csmom_tpu_torch.{pkg}.{name}")
    else:
        assert getattr(port, name) is getattr(importlib.import_module(module), name)
    assert hasattr(importlib.import_module(f"csmom_tpu.{pkg}"), name)


def test_engine_spec_sharded_resolves_through_the_rule_table():
    """``EngineSpec.sharded`` builds the grid, monthly, event, histrank and
    online-ridge engines' mesh variants (on logical CPU shards here), each
    equal to its single-device engine; a serve endpoint's and the bucket
    grid's resolve to the sharded micro-batch scorer, and an engine no
    rule matches raises."""
    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.event import event_backtest
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.models.online_ridge import online_ridge_scores
    from csmom_tpu_torch.ops.ranking import decile_assign_panel
    from csmom_tpu_torch.registry import get_engine
    from csmom_tpu_torch.registry.core import EngineSpec

    cpu4 = ["cpu"] * 4
    rng = np.random.default_rng(0)
    p = torch.as_tensor(50 * np.exp(np.cumsum(rng.normal(0, 0.07, (16, 40)), 1)))
    m = torch.ones_like(p, dtype=torch.bool)

    grid = get_engine("grid.jk", kind="compile").sharded(cpu4)
    g = grid(p, m, [3, 6], [1, 3], mode="rank")
    want = jk_grid_backtest(p, m, [3, 6], [1, 3], mode="rank")
    torch.testing.assert_close(g.spreads, want.spreads, equal_nan=True)
    net = get_engine("grid.net_core", kind="compile").sharded(cpu4)
    assert net(p, m, [3, 6], g.spreads, g.spread_valid, 0.001, (1, 3),
               mode="rank").spreads.shape == (2, 2, 40)

    spread, valid, *_ = get_engine("monthly.kernels", kind="compile").sharded(cpu4)(
        p, m, lookback=6)
    ref = monthly_spread_backtest(p, m, lookback=6)
    assert torch.equal(valid, ref.spread_valid)
    torch.testing.assert_close(spread, ref.spread, equal_nan=True)

    labels = get_engine("parallel.histrank", kind="compile").sharded(10, cpu4)(p, m)
    assert torch.equal(labels, decile_assign_panel(p, m, mode="rank")[0])

    price, valid_ev = p[:, :32], torch.rand(16, 32, generator=torch.Generator().manual_seed(1)) > 0.2
    score = torch.as_tensor(rng.normal(0, 1e-4, (16, 32)))
    adv, vol = torch.full((16,), 1e5, dtype=torch.float64), torch.full((16,), 0.02, dtype=torch.float64)
    ev = get_engine("event.panel", kind="compile").sharded(cpu4)(price, valid_ev, score, adv, vol)
    assert torch.equal(ev.positions, event_backtest(price, valid_ev, score, adv, vol).positions)

    X = torch.as_tensor(rng.normal(size=(3, 40, 2)))
    y = torch.as_tensor(rng.normal(size=(3, 40)))
    w = torch.ones((3, 40), dtype=torch.bool)
    fit = get_engine("parallel.online_ridge", kind="compile").sharded(cpu4)(X, y, w, burn_in=5)
    torch.testing.assert_close(fit.scores, online_ridge_scores(X, y, w, burn_in=5).scores,
                               rtol=1e-8, atol=1e-12, equal_nan=True)

    sig = get_engine("stream.signals", kind="compile").sharded(cpu4)
    assert set(sig) == {"momentum", "turn_avg"}
    from csmom_tpu_torch.serve.engine import serve_entry_fn

    v = torch.stack([p[:8, :24], p[8:, :24]]).float()
    mv = torch.ones_like(v, dtype=torch.bool)
    for name, axis in (("momentum", "assets"), ("backtest", "batch")):
        entry = get_engine(name, kind="serve").sharded(devices=cpu4)
        assert entry.axis == axis
        assert torch.equal(entry(v, mv).nan_to_num(),
                           serve_entry_fn(name, 12, 1, 10, "rank")(v, mv).nan_to_num())
    assert get_engine("serve.buckets", kind="compile").sharded(
        "turnover", devices=cpu4).n_devices == 4
    toy = EngineSpec(name="toy", kind="compile", manifest_fn=lambda p, d: [])
    with pytest.raises(NotImplementedError, match="no sharded variant"):
        toy.sharded()
