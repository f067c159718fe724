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

# names of the reference's exports that an open Queue 1 item brings
OWNED = {
    "utils": {
        "validate_panel": "8e", "checked": "8e", "get_logger": "8e",
        "wall": "8b", "fetch": "8b", "measure_rtt": "8b", "trace": "8b",
    },
    "parallel": dict.fromkeys((
        "time_sharded_online_ridge_scores", "make_mesh", "auto_mesh",
        "make_hybrid_mesh", "mesh_topology", "distributed_init",
        "sharded_banded_backtest", "time_sharded_hysteresis_backtest",
        "sharded_monthly_spread_backtest", "sharded_jk_grid_backtest",
        "sharded_block_bootstrap", "sharded_event_backtest",
        "time_sharded_event_backtest"), "7"),
    "registry": {
        "manifest_entries": "8a", "manifest_entry_names": "8a",
        "manifest_profiles": "8a", "entry_factory": "8a",
        "lint_rules": "8d",
    },
    "obs": {"ledger": "8c", "memstats": "8a", "regress": "8c",
            "timeline": "8c"},
}

PACKAGES = ("analytics", "backtest", "backends", "costs", "ops", "signals",
            "utils", "registry", "obs", "parallel", "serve", "strategy",
            "models", "panel", "stream")


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
    assert sorted(zoo) == sorted(ref_registry.strategies())


@pytest.mark.parametrize("pkg", ("analytics", "backtest", "backends",
                                 "costs", "ops", "signals", "utils",
                                 "registry", "obs", "parallel", "serve",
                                 "chaos", "panel", "cli", "stream"))
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
