"""The port's Strategy plugin family against csmom_tpu's, on the CPU in f64:
every built-in signal, ``xs_zscore``, the strategy engine with and without
sector ids, the registry and its errors, ``consumed_panels``,
``parse_combo_spec``, a user-registered strategy, and ``run_monthly``'s
strategy guards.  Tolerances: f64 ``rtol=1e-10, atol=1e-13``; labels and
validity exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csmom_tpu.strategy as JS
import csmom_tpu_torch.strategy as TS
from csmom_tpu.backends import run_monthly as jax_run_monthly
from csmom_tpu.backtest.monthly import _assemble_result as jax_assemble
from csmom_tpu.ops.ranking import decile_assign_panel as jax_rank
from csmom_tpu.signals.momentum import monthly_returns as jax_returns
from csmom_tpu_torch.backends.dispatch import run_monthly
from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import Panel, to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
from csmom_tpu_torch.strategy.builtin import parse_combo_spec

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13)
BUILTIN = ("high_52w", "intermediate_momentum", "low_volatility", "momentum",
           "residual_momentum", "reversal", "volume_z_momentum", "zscore_combo")
# parameters that give each strategy valid scores on 58 months
PARAMS = {"zscore_combo": {"components": "momentum:0.6,reversal:0.4"},
          "residual_momentum": {"est_window": 24, "lookback": 6},
          "low_volatility": {"window": 24, "min_obs": 6}}


def _month_panel(n_assets, seed):
    """Seeded month-end panel with late listings, delistings and gaps:
    ``(prices f64[A, M], mask, volumes f64[A, M], volumes_mask)``."""
    daily = synthetic_daily_panel(n_assets, 1260, seed=seed, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device="cpu")
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    rng = np.random.default_rng(seed + 1)
    vol = np.where(mm.numpy(), rng.uniform(1e5, 1e7, size=pm.shape), 0.0)
    vol_mask = mm.numpy() & (rng.random(pm.shape) > 0.05)
    return pm.numpy(), mm.numpy(), vol, vol_mask, ends


@pytest.fixture(scope="module", params=[20, 60], ids=["A20", "A60"])
def panel(request):
    return _month_panel(request.param, seed=request.param)


@pytest.fixture(scope="module")
def panel60():
    """The engine tests' panel (one shape: each shape compiles the
    reference's engines anew)."""
    return _month_panel(60, seed=60)


def _both_signals(name, panel, with_mask=True):
    pm, mm, vol, vmask, _ = panel
    kw = PARAMS.get(name, {})
    js, ts = JS.make_strategy(name, **kw), TS.make_strategy(name, **kw)
    extra = {}
    if name in ("volume_z_momentum", "zscore_combo"):
        extra = {"volumes": vol}
        if with_mask:
            extra["volumes_mask"] = vmask
    a, av = js.signal(jnp.asarray(pm), jnp.asarray(mm),
                      **{k: jnp.asarray(x) for k, x in extra.items()})
    b, bv = ts.signal(torch.as_tensor(pm), torch.as_tensor(mm),
                      **{k: torch.as_tensor(x) for k, x in extra.items()})
    return (np.asarray(a), np.asarray(av)), (b.numpy(), bv.numpy())


@pytest.mark.parametrize("name", BUILTIN)
def test_builtin_signal_equals_the_reference(name, panel):
    (a, av), (b, bv) = _both_signals(name, panel)
    np.testing.assert_array_equal(bv, av)
    assert bv.any()
    np.testing.assert_allclose(b, a, equal_nan=True, **TOL)
    assert np.isnan(b[~bv]).all()


def test_volume_z_without_a_volume_mask(panel):
    (a, av), (b, bv) = _both_signals("volume_z_momentum", panel, with_mask=False)
    np.testing.assert_array_equal(bv, av)
    np.testing.assert_allclose(b, a, equal_nan=True, **TOL)
    with pytest.raises(ValueError, match="needs a volumes= panel"):
        TS.VolumeZMomentum().signal(torch.zeros(3, 4), torch.ones(3, 4, dtype=torch.bool))


def test_xs_zscore_equals_the_reference(panel):
    pm, mm, *_ = panel
    rng = np.random.default_rng(3)
    x = np.where(mm, rng.normal(size=pm.shape), np.nan)
    valid = mm.copy()
    valid[:, 5] = False                      # a month with no valid lane
    x[:3, 7] = 1.25                          # tied values
    valid[:, 9] = False
    valid[0, 9] = True                       # a single valid lane: zero std
    got = TS.xs_zscore(torch.as_tensor(x), torch.as_tensor(valid)).numpy()
    want = np.asarray(JS.xs_zscore(jnp.asarray(x), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def _jax_unfused(prices, mask, strategy, n_bins, mode, **panels):
    """csmom_tpu's strategy engine as separate steps: its signal, its
    ranking, its monthly tail."""
    ret, ret_valid = jax_returns(prices, mask)
    score, valid = strategy.signal(prices, mask, **panels)
    labels, _ = jax_rank(score, valid, n_bins=n_bins, mode=mode)
    return jax_assemble(ret, ret_valid, labels, n_bins, 12)


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.spread_valid.numpy(), np.asarray(want.spread_valid))
    np.testing.assert_array_equal(got.decile_counts.numpy(), np.asarray(want.decile_counts))
    for f in ("spread", "decile_means", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   equal_nan=True, err_msg=f, **TOL)


@pytest.mark.parametrize("name", ["momentum", "reversal", "low_volatility",
                                  "residual_momentum", "high_52w"])
@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_strategy_backtest_equals_the_reference(name, mode, panel60):
    pm, mm, *_ = panel60
    kw = PARAMS.get(name, {})
    got = TS.strategy_backtest(torch.as_tensor(pm), torch.as_tensor(mm),
                               TS.make_strategy(name, **kw), n_bins=5, mode=mode)
    want = JS.strategy_backtest(pm, mm, JS.make_strategy(name, **kw), n_bins=5, mode=mode)
    _assert_results_equal(got, want)


@pytest.mark.parametrize("name", ["volume_z_momentum", "zscore_combo"])
@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_zscore_strategies_equal_the_reference_signal_then_ranking(name, mode, panel60):
    """Scores that sum z-scores land data points exactly on qcut's edges;
    the port ranks them as csmom_tpu's signal and ranking do when run one
    after the other (its fused engine can bin such a point differently:
    ROADMAP.md, known differences)."""
    pm, mm, vol, vmask, _ = panel60
    kw = PARAMS.get(name, {})
    got = TS.strategy_backtest(torch.as_tensor(pm), torch.as_tensor(mm),
                               TS.make_strategy(name, **kw), n_bins=10, mode=mode,
                               volumes=torch.as_tensor(vol),
                               volumes_mask=torch.as_tensor(vmask))
    want = _jax_unfused(jnp.asarray(pm), jnp.asarray(mm), JS.make_strategy(name, **kw),
                        10, mode, volumes=jnp.asarray(vol),
                        volumes_mask=jnp.asarray(vmask))
    _assert_results_equal(got, want)


@pytest.mark.parametrize("name", ["momentum", "low_volatility"])
def test_strategy_backtest_with_sector_ids_equals_the_reference(name, panel60):
    pm, mm, *_ = panel60
    A = pm.shape[0]
    sid = np.random.default_rng(A).integers(-1, 4, size=A)
    kw = PARAMS.get(name, {})
    got = TS.strategy_backtest(torch.as_tensor(pm), torch.as_tensor(mm),
                               TS.make_strategy(name, **kw), n_bins=4, mode="rank",
                               sector_ids=torch.as_tensor(sid), n_sectors=4)
    want = JS.strategy_backtest(pm, mm, JS.make_strategy(name, **kw), n_bins=4,
                                mode="rank", sector_ids=sid.astype(np.int32), n_sectors=4)
    _assert_results_equal(got, want)
    assert (got.labels.numpy()[sid < 0] == -1).all()


@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_momentum_strategy_is_the_monthly_engine_bit_for_bit(mode, panel60):
    pm, mm, *_ = panel60
    p, m = torch.as_tensor(pm), torch.as_tensor(mm)
    via = TS.strategy_backtest(p, m, TS.Momentum(lookback=6, skip=1), n_bins=5, mode=mode)
    ded = monthly_spread_backtest(p, m, lookback=6, skip=1, n_bins=5, mode=mode)
    for f in dataclasses.fields(ded):
        a, b = getattr(via, f.name), getattr(ded, f.name)
        assert torch.equal(a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan()), f.name


def test_registry_round_trip_and_reprs():
    zoo = TS.available_strategies()
    assert set(BUILTIN) <= set(zoo)
    assert set(BUILTIN) <= set(JS.available_strategies())
    for name in BUILTIN:
        kw = PARAMS.get(name, {})
        t, j = TS.make_strategy(name, **kw), JS.make_strategy(name, **kw)
        assert repr(t) == repr(j)
        assert type(t) is zoo[name] and type(t).__name__ == type(j).__name__
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        assert hash(t) == hash(TS.make_strategy(name, **kw))
        assert TS.consumed_panels(t) == JS.consumed_panels(j)
    with pytest.raises(KeyError) as got:
        TS.make_strategy("no_such")
    with pytest.raises(KeyError) as want:
        JS.make_strategy("no_such")
    prefix = "\"unknown strategy 'no_such'; available: ["
    assert str(got.value).startswith(prefix) and str(want.value).startswith(prefix)
    for name in BUILTIN:
        assert repr(name) in str(got.value)
    with pytest.raises(TypeError, match="not a Strategy subclass"):
        TS.register_strategy("bad")(int)


def test_consumed_panels_of_combos():
    spec = "volume_z_momentum:0.5,momentum"
    t = TS.ZScoreCombo(components=spec)
    j = JS.ZScoreCombo(components=spec)
    assert TS.consumed_panels(t) == JS.consumed_panels(j) == {"volumes", "volumes_mask"}
    assert t.panel_names == j.panel_names


@pytest.mark.parametrize("spec", ["momentum:0.6,reversal:0.4", " momentum , high_52w:2",
                                  "low_volatility:-1.5,"])
def test_parse_combo_spec_equals_the_reference(spec):
    from csmom_tpu.strategy.builtin import parse_combo_spec as jax_parse

    assert repr(parse_combo_spec(spec)) == repr(jax_parse(spec))


@pytest.mark.parametrize("spec", ["", " , ", "momentum:x", "nope:1"])
def test_parse_combo_spec_errors_equal_the_reference(spec):
    from csmom_tpu.strategy.builtin import parse_combo_spec as jax_parse

    with pytest.raises((ValueError, KeyError)) as got:
        parse_combo_spec(spec)
    with pytest.raises((ValueError, KeyError)) as want:
        jax_parse(spec)
    assert type(got.value) is type(want.value)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def _panel_of(pm, ends):
    return Panel.from_dense(pm, [f"T{i:03d}" for i in range(pm.shape[0])], ends)


def _jax_panel_of(pm, ends):
    from csmom_tpu.panel.panel import Panel as JaxPanel

    return JaxPanel.from_dense(pm, [f"T{i:03d}" for i in range(pm.shape[0])], ends)


def test_user_registered_strategy_runs_through_run_monthly(panel60):
    """A plugin registered by name ranks through both backends of each
    package; the port's registration leaves the built-ins alone."""
    from csmom_tpu.registry import unregister_engine
    from csmom_tpu_torch.registry import unregister_engine as port_unregister

    @TS.register_strategy("test_torch_price_level")
    @dataclasses.dataclass(frozen=True)
    class PriceLevel(TS.Strategy):
        """Rank on the price level."""

        scale: float = 1.0

        def signal(self, prices, mask, **panels):
            return torch.where(mask, self.scale * prices, torch.nan), mask

    @JS.register_strategy("test_torch_price_level")
    @dataclasses.dataclass(frozen=True)
    class JaxPriceLevel(JS.Strategy):
        scale: float = 1.0

        def signal(self, prices, mask, **panels):
            return jnp.where(mask, self.scale * prices, jnp.nan), mask

    try:
        pm, mm, _, _, ends = panel60
        panel_ = _panel_of(pm, ends)
        assert set(BUILTIN) < set(TS.available_strategies())
        for backend in ("torch", "pandas"):
            got = run_monthly(panel_, n_bins=5, device="cpu", backend=backend,
                              strategy=TS.make_strategy("test_torch_price_level", scale=2.0))
            want = jax_run_monthly(_jax_panel_of(pm, ends), n_bins=5,
                                   backend="tpu" if backend == "torch" else "pandas",
                                   strategy=JS.make_strategy("test_torch_price_level",
                                                             scale=2.0))
            np.testing.assert_array_equal(got.labels, want.labels)
            assert (got.labels[mm] >= 0).all()
            np.testing.assert_allclose(got.spread, want.spread, equal_nan=True, **TOL)
            assert got.backend == ("torch:cpu" if backend == "torch" else "pandas")
    finally:
        unregister_engine("test_torch_price_level", kind="strategy")
        port_unregister("test_torch_price_level", kind="strategy")
    assert "test_torch_price_level" not in TS.available_strategies()


def test_run_monthly_forwards_only_panels_the_signal_reads(panel60):
    pm, mm, vol, vmask, ends = panel60
    panel_ = _panel_of(pm, ends)
    kw = dict(volumes=vol, volumes_mask=vmask)
    got = run_monthly(panel_, device="cpu", strategy=TS.VolumeZMomentum(), **kw)
    want = jax_run_monthly(_jax_panel_of(pm, ends), strategy=JS.VolumeZMomentum(), **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.spread, want.spread, equal_nan=True, **TOL)
    # "tpu" names the card engine in the reference's config files
    alias = run_monthly(panel_, device="cpu", backend="tpu",
                        strategy=TS.VolumeZMomentum(), **kw)
    np.testing.assert_array_equal(alias.spread, got.spread)


@pytest.mark.parametrize("case", ["panels_without_strategy", "unread_panel",
                                  "sectors_on_pandas", "sectors_without_count"])
def test_run_monthly_guards_equal_the_reference(case, panel60):
    pm, mm, vol, _, ends = panel60
    panel_ = _panel_of(pm, ends)
    sid = np.zeros(pm.shape[0], np.int32)
    calls = {
        "panels_without_strategy": (dict(volumes=vol), dict(volumes=vol)),
        "unread_panel": (dict(strategy=TS.Momentum(), volumes_maks=vol),
                         dict(strategy=JS.Momentum(), volumes_maks=vol)),
        "sectors_on_pandas": (dict(backend="pandas", sector_ids=sid, n_sectors=1),
                              dict(backend="pandas", sector_ids=sid, n_sectors=1)),
        "sectors_without_count": (dict(sector_ids=sid, n_sectors=0),
                                  dict(sector_ids=sid, n_sectors=0)),
    }
    port_kw, jax_kw = calls[case]
    with pytest.raises(Exception) as got:
        run_monthly(panel_, device="cpu", **port_kw)
    with pytest.raises(Exception) as want:
        jax_run_monthly(_jax_panel_of(pm, ends), **jax_kw)
    assert type(got.value) is type(want.value)
    assert type(got.value) in (TypeError, NotImplementedError, ValueError)
    if case != "sectors_on_pandas":  # the port names its own card engine
        assert str(got.value) == str(want.value)


def test_unknown_backend_raises(panel60):
    pm, _, _, _, ends = panel60
    with pytest.raises(ValueError, match="unknown backend 'tpu2'"):
        run_monthly(_panel_of(pm, ends), device="cpu", backend="tpu2")


def test_strategies_are_kind_strategy_registry_engines():
    """The zoo is the registry's kind-``strategy`` rows, in registration
    order, as in the reference: no table of its own beside them."""
    from csmom_tpu_torch import registry
    from csmom_tpu_torch.strategy import base

    zoo = TS.available_strategies()
    specs = registry.engine_specs("strategy")
    assert [s.name for s in specs] == list(zoo)
    assert sorted(zoo) == sorted(BUILTIN)
    for s in specs:
        assert s.strategy_cls is zoo[s.name]
        assert s.description == (s.strategy_cls.__doc__ or "").strip().splitlines()[0]
    assert not hasattr(base, "_STRATEGIES")
