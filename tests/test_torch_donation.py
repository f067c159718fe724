"""Buffer donation (``csmom_tpu_torch.utils.donation`` and the donated
surfaces) against csmom_tpu's donated entries on the CPU.

The same seeded numpy inputs go through each of the reference's donated
surfaces and the port's counterpart, f64:

- the outputs agree within ``rtol=1e-10, atol=1e-13`` (integers equal;
  an event result's per-bar PnL as ``tests/test_torch_event.py`` holds
  it), and equal the port's own plain call bit for bit;
- the reference's arrays report ``is_deleted()`` or a recorded "donated
  buffers were not usable" warning (the idiom of
  ``tests/test_aot_warmup.py``); the port's tensors report
  :func:`~csmom_tpu_torch.utils.donation.is_deleted` and read as empty;
- the plain surfaces consume nothing in either package;
- a tensor that cannot be donated warns and stays readable;
- a donated body releases each panel after its last use, before the
  call returns (a weak reference to the storage expires).
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest import event as ref_event
from csmom_tpu.backtest import grid as ref_grid
from csmom_tpu.serve.engine import serve_entry_fn_donated as ref_serve_donated
from csmom_tpu_torch.backtest import event, grid
from csmom_tpu_torch.registry import get_engine
from csmom_tpu_torch.serve.engine import serve_entry_fn, serve_entry_fn_donated
from csmom_tpu_torch.utils.donation import NOT_USABLE, consume, is_deleted
from tests.test_torch_event import assert_same_result

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-13)
JS, KS = [3, 6], [3, 6]


def _panel(seed, A=24, M=48):
    rng = np.random.default_rng(seed)
    prices = 100 * np.exp(np.cumsum(rng.normal(0.004, 0.06, (A, M)), axis=1))
    prices[: A // 6, : M // 5] = np.nan      # late listings
    return prices, np.isfinite(prices)


def _minute(seed, A=6, T=96):
    rng = np.random.default_rng(seed)
    price = 100 * np.exp(np.cumsum(rng.normal(0, 1e-3, (A, T)), axis=1))
    valid = rng.random((A, T)) > 0.25
    price = np.where(valid, price, np.nan)
    score = np.where(valid, rng.normal(0, 1e-4, (A, T)), np.nan)
    return price, valid, score, np.full(A, 1e6), np.full(A, 0.02)


def _leaves(x):
    """Numpy leaves of a result (tensor, jax array, dataclass), in order."""
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _leaves(getattr(x, f.name))]
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return [np.asarray(x)]
    return []


def _assert_close(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, **F64, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


def _assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _reference_donated(arrays, caught):
    """The reference's acceptance of a donated call (test_aot_warmup.py):
    an input deleted, or a declined donation declared."""
    declined = any("donated" in str(w.message).lower() for w in caught)
    return any(a.is_deleted() for a in arrays) or declined


def _donate(fn, *arrays):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*arrays)
    return out, caught


def _consumed(*tensors):
    return all(is_deleted(t) and t.numel() == 0 for t in tensors)


@pytest.mark.parametrize("mode", ["rank", "qcut"])
def test_grid_donated_matches_the_reference_and_consumes(mode):
    prices, mask = _panel(1)
    plain = grid.jk_grid_backtest(torch.from_numpy(prices), torch.from_numpy(mask),
                                  JS, KS, mode=mode, impl="plain")
    p, m = torch.from_numpy(prices.copy()), torch.from_numpy(mask.copy())
    got = grid.jk_grid_backtest(p, m, JS, KS, mode=mode, impl="plain",
                                donate_panels=True)
    rp, rm = jnp.array(prices), jnp.array(mask)
    want, caught = _donate(lambda a, b: ref_grid.jk_grid_backtest(
        a, b, np.array(JS), np.array(KS), mode=mode, donate_panels=True), rp, rm)
    _assert_close(got, want)
    _assert_bit_equal(got, plain)
    assert _consumed(p, m) and _reference_donated((rp, rm), caught)


def test_grid_net_of_costs_donated_matches_the_reference_and_consumes():
    prices, mask = _panel(2)
    tp, tm = torch.from_numpy(prices), torch.from_numpy(mask)
    g = grid.jk_grid_backtest(tp, tm, JS, KS, mode="rank", impl="plain")
    plain = grid.grid_net_of_costs(tp, tm, g, half_spread=0.001)
    p, m = tp.clone(), tm.clone()
    got = grid.grid_net_of_costs(p, m, g, half_spread=0.001, donate_panels=True)
    rg = ref_grid.jk_grid_backtest(jnp.asarray(prices), jnp.asarray(mask),
                                   np.array(JS), np.array(KS), mode="rank")
    rp, rm = jnp.array(prices), jnp.array(mask)
    want, caught = _donate(lambda a, b: ref_grid.grid_net_of_costs(
        a, b, rg, half_spread=0.001, donate_panels=True), rp, rm)
    _assert_close(got, want)
    _assert_bit_equal(got, plain)
    assert _consumed(p, m) and _reference_donated((rp, rm), caught)
    assert not is_deleted(tp) and tp.numel() == prices.size


@pytest.mark.parametrize("latency", [0, 3])
def test_event_donated_matches_the_reference_and_consumes(latency):
    price, valid, score, adv, vol = _minute(3)
    ta, tv = torch.from_numpy(adv), torch.from_numpy(vol)
    plain = event.event_backtest(torch.from_numpy(price), torch.from_numpy(valid),
                                 torch.from_numpy(score), ta, tv,
                                 latency_bars=latency)
    p, v, s = (torch.from_numpy(x.copy()) for x in (price, valid, score))
    got = event.event_backtest_donated(p, v, s, ta, tv, latency_bars=latency)
    rp, rv, rs = jnp.array(price), jnp.array(valid), jnp.array(score)
    want, caught = _donate(lambda a, b, c: ref_event.event_backtest_donated(
        a, b, c, jnp.asarray(adv), jnp.asarray(vol), latency_bars=latency),
        rp, rv, rs)
    assert_same_result(got, want)
    _assert_bit_equal(got, plain)
    assert _consumed(p, v, s) and _reference_donated((rp, rv, rs), caught)
    assert not is_deleted(ta) and ta.numel() == adv.size   # adv, vol: kept


@pytest.mark.parametrize("latency", [0, 2])
def test_hysteresis_donated_matches_the_reference_and_consumes(latency):
    price, valid, score, adv, vol = _minute(4)
    ta, tv = torch.from_numpy(adv), torch.from_numpy(vol)
    kw = dict(threshold_hi=5e-5, threshold_lo=1e-5, latency_bars=latency)
    plain = event.hysteresis_event_backtest(
        torch.from_numpy(price), torch.from_numpy(valid), torch.from_numpy(score),
        ta, tv, **kw)
    p, v, s = (torch.from_numpy(x.copy()) for x in (price, valid, score))
    got = event.hysteresis_event_backtest(p, v, s, ta, tv, donate_panels=True, **kw)
    rp, rv, rs = jnp.array(price), jnp.array(valid), jnp.array(score)
    want, caught = _donate(lambda a, b, c: ref_event.hysteresis_event_backtest(
        a, b, c, jnp.asarray(adv), jnp.asarray(vol), donate_panels=True, **kw),
        rp, rv, rs)
    assert_same_result(got, want)
    _assert_bit_equal(got, plain)
    assert _consumed(p, v, s) and _reference_donated((rp, rv, rs), caught)
    with pytest.raises(ValueError, match="takes no donation"):
        event.hysteresis_event_backtest(p, v, s, ta, tv, donate_panels=True,
                                        axis_name="assets")


@pytest.mark.parametrize("kind", ["momentum", "turnover", "backtest",
                                  "low_volatility", "zscore_combo"])
def test_serve_donated_matches_the_reference_and_consumes(kind):
    rng = np.random.default_rng(6)
    B, A, M = 3, 10, 40
    values = 100 * np.exp(np.cumsum(rng.normal(0.003, 0.05, (B, A, M)), axis=-1))
    mask = rng.random((B, A, M)) > 0.05
    params = (12, 1, 5, "rank")
    plain = serve_entry_fn(kind, *params)(torch.from_numpy(values),
                                          torch.from_numpy(mask))
    v, m = torch.from_numpy(values.copy()), torch.from_numpy(mask.copy())
    got = serve_entry_fn_donated(kind, *params)(v, m)
    rv, rm = jnp.array(values), jnp.array(mask)
    want, caught = _donate(ref_serve_donated(kind, *params), rv, rm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64,
                               equal_nan=True)
    assert got.numpy().tobytes() == plain.numpy().tobytes()
    assert _consumed(v, m) and _reference_donated((rv, rm), caught)
    assert serve_entry_fn_donated(kind, *params) is serve_entry_fn_donated(kind, *params)


@pytest.mark.parametrize("engine", ["grid.jk", "event.panel", "backtest"])
def test_spec_donated_computes_what_the_plain_call_computes(engine):
    """``EngineSpec.donated()`` answers for ``grid.jk``, ``event.panel``
    and every serve engine, as the reference's does
    (tests/test_registry.py pins it for a serve engine)."""
    from csmom_tpu.registry import get_engine as ref_get_engine

    if engine == "backtest":
        spec, ref_spec = get_engine(engine, kind="serve"), ref_get_engine(engine, kind="serve")
        params = dict(lookback=12, skip=1, n_bins=5, mode="rank")
        rng = np.random.default_rng(8)
        values = 100 * np.exp(np.cumsum(rng.normal(0, 0.05, (2, 8, 30)), axis=-1))
        args = (values, np.ones(values.shape, bool))
        plain_fn = serve_entry_fn(engine, 12, 1, 5, "rank")
        ref_args = args
    elif engine == "grid.jk":
        spec, ref_spec = get_engine(engine, kind="compile"), ref_get_engine(engine, kind="compile")
        params = {}
        prices, mask = _panel(9)
        args = (prices, mask, np.array(JS), np.array(KS), 1)
        plain_fn = lambda p, m, j, k, s: grid.jk_grid_backtest(  # noqa: E731
            p, m, j, k, s, mode="rank", impl="plain")
        ref_args = args
    else:
        spec, ref_spec = get_engine(engine, kind="compile"), ref_get_engine(engine, kind="compile")
        params = {}
        args = _minute(9)
        plain_fn = event.event_backtest
        ref_args = args
    donated = spec.donated(**params)
    tensors = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
               for a in args]
    plain = plain_fn(*[t.clone() if torch.is_tensor(t) else t for t in tensors])
    # the reference's donated grid entry is its jitted body: every
    # static given, impl named by the reference's name for the port's
    statics = dict(n_bins=10, mode="rank", max_hold=6, freq=12)
    kw = dict(statics, impl="plain") if engine == "grid.jk" else {}
    got = donated(*tensors, **kw)
    _assert_bit_equal(got, plain)
    assert _consumed(tensors[0], tensors[1])
    ref_kw = dict(statics, impl="xla") if engine == "grid.jk" else {}
    want = ref_spec.donated(**params)(
        *[jnp.array(a) if isinstance(a, np.ndarray) else a for a in ref_args], **ref_kw)
    (assert_same_result if engine == "event.panel" else _assert_close)(got, want)
    if engine != "backtest":
        with pytest.raises(NotImplementedError, match="no donated-buffer variant"):
            get_engine("grid.net_core", kind="compile").donated()


def test_the_plain_surfaces_consume_nothing_in_either_package():
    prices, mask = _panel(10)
    p, m = torch.from_numpy(prices), torch.from_numpy(mask)
    g = grid.jk_grid_backtest(p, m, JS, KS, mode="rank", impl="plain")
    grid.grid_net_of_costs(p, m, g)
    price, valid, score, adv, vol = (torch.from_numpy(x) for x in _minute(10))
    event.event_backtest(price, valid, score, adv, vol)
    event.hysteresis_event_backtest(price, valid, score, adv, vol)
    serve_entry_fn("momentum", 12, 1, 5, "rank")(p[None], m[None])
    for t in (p, m, price, valid, score):
        assert not is_deleted(t) and t.numel() > 0
    rp, rm = jnp.asarray(prices), jnp.asarray(mask)
    ref_grid.jk_grid_backtest(rp, rm, np.array(JS), np.array(KS), mode="rank")
    assert not rp.is_deleted() and not rm.is_deleted()


def test_a_tensor_that_cannot_be_donated_warns_and_stays_readable():
    price, valid, score, adv, vol = (torch.from_numpy(x) for x in _minute(11))
    plain = event.event_backtest(price, valid, score, adv, vol)
    base = price.clone()
    view = base[:, :]                         # a view: its base keeps the memory
    grad = score.clone().requires_grad_(True)
    for args, why, kept in (
            ((view, valid.clone(), score.clone()), "view of a larger storage", 0),
            ((price.clone(), valid.clone(), grad), "requires grad", 2)):
        with warnings.catch_warnings(record=True) as caught, torch.no_grad():
            warnings.simplefilter("always")
            got = event.event_backtest_donated(*args, adv, vol)
        msgs = [str(w.message) for w in caught]
        assert any(NOT_USABLE in m and why in m for m in msgs), msgs
        # the reference's test idiom reads the port's warning too
        assert any("donated" in m.lower() for m in msgs)
        _assert_bit_equal(got, plain)
        assert not is_deleted(args[kept]) and args[kept].numel() == price.numel()
        assert all(_consumed(a) for i, a in enumerate(args) if i != kept)
    # one tensor at two positions: both are left as they were
    twice = price.clone()
    with pytest.warns(UserWarning, match="shares its storage"):
        got = event.event_backtest_donated(twice, valid.clone(), twice, adv, vol)
    _assert_bit_equal(got, event.event_backtest(price, valid, price, adv, vol))
    assert not is_deleted(twice) and twice.numel() == price.numel()
    # a host array is no tensor: the caller's array is left as it was
    arr = np.arange(4.0)
    with pytest.warns(UserWarning, match=NOT_USABLE):
        (out,) = consume(arr)
    assert out is arr


def test_consume_contract():
    t = torch.arange(6.0)
    same_values = t.clone()
    (alias,) = consume(t)
    assert is_deleted(t) and t.shape == (0,) and t.dtype == torch.float32
    assert t.numel() == 0 and t.sum().item() == 0.0     # reads as empty
    assert alias.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert not is_deleted(alias) and not is_deleted(same_values)
    with pytest.raises(RuntimeError, match="consumed by an earlier"):
        consume(t)
    with pytest.raises(ValueError, match="one device"):
        consume(torch.ones(2), torch.ones(2, device="meta"))
    with torch.inference_mode():
        inf = torch.ones(3)
    (alias,) = consume(inf)
    assert is_deleted(inf) and alias.tolist() == [1.0, 1.0, 1.0]


def _storage_ref(t):
    return t.untyped_storage()._weak_ref()


def _expired(ref) -> bool:
    return torch.UntypedStorage._expired(ref)


def test_a_donated_grid_releases_its_panels_before_the_ranking(monkeypatch):
    prices, mask = _panel(12)
    for donate in (False, True):
        p, m = torch.from_numpy(prices.copy()), torch.from_numpy(mask.copy())
        refs = [_storage_ref(p), _storage_ref(m)]
        seen = []
        real = grid.decile_assign_panel

        def spy(*a, **kw):
            seen.append([_expired(r) for r in refs])
            return real(*a, **kw)

        monkeypatch.setattr(grid, "decile_assign_panel", spy)
        grid.jk_grid_backtest(p, m, JS, KS, mode="rank", impl="plain",
                              donate_panels=donate)
        monkeypatch.setattr(grid, "decile_assign_panel", real)
        assert seen == [[donate, donate]]
        assert [_expired(r) for r in refs] == [donate, donate]


def test_a_donated_event_releases_score_first_then_the_panels(monkeypatch):
    price, valid, score, adv, vol = _minute(13)
    ta, tv = torch.from_numpy(adv), torch.from_numpy(vol)
    for fn in (event.event_backtest_donated,
               lambda *a: event.hysteresis_event_backtest(*a, donate_panels=True)):
        p, v, s = (torch.from_numpy(x.copy()) for x in (price, valid, score))
        refs = {"price": _storage_ref(p), "valid": _storage_ref(v),
                "score": _storage_ref(s)}
        seen = {}
        real_impact = event.square_root_impact

        def impact_spy(*a, **kw):
            seen["at impact"] = {k: _expired(r) for k, r in refs.items()}
            return real_impact(*a, **kw)

        monkeypatch.setattr(event, "square_root_impact", impact_spy)
        fn(p, v, s, ta, tv)
        monkeypatch.setattr(event, "square_root_impact", real_impact)
        # score goes with the trade decisions; price and valid after the
        # settle's last use, before the call returns
        assert seen["at impact"] == {"price": False, "valid": False, "score": True}
        assert all(_expired(r) for r in refs.values())
