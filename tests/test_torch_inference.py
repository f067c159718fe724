"""The port's inference layer against csmom_tpu in float64: walk-forward
(J, K) selection and block-bootstrap CIs (BASELINE config 5), the
host-side tables, the host entry points' new options, and the research
fingerprints chip_smoke.py pins for the card."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.analytics import bootstrap as jboot
from csmom_tpu.analytics import tables as jtables
from csmom_tpu.backtest import walkforward as jwf
from csmom_tpu.backtest.grid import jk_grid_backtest as jax_grid
from csmom_tpu_torch import random
from csmom_tpu_torch.analytics import bootstrap, tables
from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
from csmom_tpu_torch.backtest import walkforward
from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.backtest.monthly import sector_neutral_backtest
from csmom_tpu_torch.panel.panel import Panel
from csmom_tpu_torch.workloads import month_panel

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def grids():
    """A 16-cell grid on tests/test_pallas.py's late-listing panel."""
    rng = np.random.default_rng(151)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.004, 0.06, size=(40, 120)), axis=1))
    mask = np.ones((40, 120), bool)
    mask[:5, :30] = False
    Js = Ks = np.array([3, 6, 9, 12])
    res = jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), Js, Ks,
                           n_bins=5, mode="rank")
    jres = jax_grid(jnp.asarray(prices), jnp.asarray(mask), Js, Ks, n_bins=5,
                    mode="rank")
    return prices, mask, res, jres


def _score_gap(sh, choice, min_months=24):
    """Smallest margin of the chosen cell's score over the runner-up."""
    sh = np.where(np.isfinite(sh), sh, -np.inf)
    gaps = []
    for m, c in enumerate(choice):
        if c >= 0:
            s = np.sort(sh[:, m])[::-1]
            if np.isfinite(s[1]):
                gaps.append(s[0] - s[1])
    return min(gaps)


def test_walk_forward_matches_jax(grids):
    """Selection is an argmax over expanding Sharpes (the first maximum in
    both libraries): the choices are equal on this panel, where the closest
    two cells' scores differ by far more than their rounding."""
    prices, mask, res, jres = grids
    for min_months in (12, 24):
        wf = walkforward.walk_forward_select(res.spreads, res.spread_valid,
                                             min_months=min_months)
        jw = jwf.walk_forward_select(jres.spreads, jres.spread_valid,
                                     min_months=min_months)
        choice = wf.choice.numpy()
        np.testing.assert_array_equal(choice, np.asarray(jw.choice))
        assert wf.choice.dtype == torch.int32 and (choice >= 0).sum() > 50
        assert len(set(choice[choice >= 0])) > 1
        gap = _score_gap(wf.insample_sharpe.numpy(), choice)
        assert gap > 1e-6, f"smallest score gap {gap}"
        for k in ("insample_sharpe", "oos_spread", "mean_spread", "ann_sharpe",
                  "tstat", "tstat_nw"):
            np.testing.assert_allclose(getattr(wf, k).numpy(), np.asarray(getattr(jw, k)),
                                       err_msg=k, **TOL)
        np.testing.assert_array_equal(wf.oos_valid.numpy(), np.asarray(jw.oos_valid))
    wf2, g2 = walkforward.walk_forward_grid_backtest(
        torch.as_tensor(prices), torch.as_tensor(mask), [3, 6, 9, 12], [3, 6, 9, 12],
        n_bins=5, mode="rank")
    assert torch.equal(wf2.choice, walkforward.walk_forward_select(
        res.spreads, res.spread_valid).choice)
    assert torch.equal(g2.spread_valid, res.spread_valid)


@pytest.mark.parametrize("index_dtype,jdtype", [(torch.int64, None),
                                                (torch.int32, jnp.int32)])
def test_block_bootstrap_indices_and_stats(grids, index_dtype, jdtype):
    """One key draws the reference's resample indices: int64 as it draws
    them with 64-bit types on (this suite), int32 as in production."""
    _, _, res, jres = grids
    jkey, key = jax.random.PRNGKey(3), random.PRNGKey(3)
    idx = bootstrap.circular_block_indices(key, 50, 120, 6, index_dtype=index_dtype)
    if jdtype is None:
        jidx = np.asarray(jboot.circular_block_indices(jkey, 50, 120, 6))
    else:  # the reference's recipe with an int32 draw
        starts = jax.random.randint(jkey, (50, 20), 0, 120, dtype=jdtype)
        jidx = np.asarray(((starts[:, :, None] + jnp.arange(6)) % 120)
                          .reshape(50, -1)[:, :120])
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), jidx)
    if jdtype is not None:
        return
    spread, valid = res.spreads[3, 1], res.spread_valid[3, 1]
    b = bootstrap.block_bootstrap(spread, valid, key, n_samples=300,
                                  index_dtype=torch.int64)
    jb = jboot.block_bootstrap(jres.spreads[3, 1], jres.spread_valid[3, 1], jkey,
                               n_samples=300)
    g = bootstrap.block_bootstrap_grid(res.spreads, res.spread_valid, key,
                                       n_samples=100, index_dtype=torch.int64)
    jg = jboot.block_bootstrap_grid(jres.spreads, jres.spread_valid, jkey,
                                    n_samples=100)
    assert g.mean_samples.shape == (100, 4, 4) and g.mean_ci.shape == (2, 4, 4)
    for got, want in ((b, jb), (g, jg)):
        for k in ("mean_samples", "sharpe_samples", "mean_point", "sharpe_point",
                  "mean_ci", "sharpe_ci"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)), err_msg=k, **TOL)
    with pytest.raises(ValueError, match="block_len"):
        bootstrap.circular_block_indices(key, 2, 10, 0)


def test_tables_match_jax(grids):
    _, _, res, jres = grids
    Js = Ks = [3, 6, 9, 12]
    # the reference compiles its statistics once per series shape and lag,
    # so its per-cell table runs on a 2 x 2 corner of the grid (the port's
    # whole-grid statistics are held to the reference elsewhere)
    for got, want in zip(tables.jk_grid_table(res.spreads[:2, 2:], res.spread_valid[:2, 2:],
                                              Js[:2], Ks[2:]),
                         jtables.jk_grid_table(jres.spreads[:2, 2:],
                                               jres.spread_valid[:2, 2:], Js[:2], Ks[2:])):
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)
        assert list(got.index) == Js[:2] and got.index.name == "J"
    lo, hi = tables.jk_grid_ci_table(res.spreads, res.spread_valid, Js, Ks,
                                     n_samples=60, index_dtype=torch.int64)
    jlo, jhi = jtables.jk_grid_ci_table(np.asarray(jres.spreads),
                                        np.asarray(jres.spread_valid), Js, Ks,
                                        n_samples=60)
    np.testing.assert_allclose(lo.to_numpy(), jlo.to_numpy(), **TOL)
    np.testing.assert_allclose(hi.to_numpy(), jhi.to_numpy(), **TOL)
    assert (lo.to_numpy() <= hi.to_numpy()).all()

    rng = np.random.default_rng(6)
    means = rng.normal(0, 0.05, size=(5, 120))
    counts = rng.integers(0, 4, size=(5, 120))
    means = np.where(counts > 0, means, np.nan)
    spread = np.where((counts[0] > 0) & (counts[4] > 0), means[4] - means[0], np.nan)
    got = tables.decile_table(means, counts, spread)
    want = jtables.decile_table(means, counts, spread)
    assert list(got.index) == list(want.index) == [f"R{b}" for b in range(1, 6)] + ["R5-R1"]
    np.testing.assert_allclose(got.to_numpy(dtype=float), want.to_numpy(dtype=float), **TOL)


def test_host_entry_points_research_options():
    """run_monthly's sectors and run_grid's hist mode and matmul impls on
    the CPU, with the reference's refusal of sectors without a count."""
    pm, mm, ends = month_panel(60, 800, device="cpu", dtype=torch.float64)
    panel = Panel(values=pm.numpy(), mask=mm.numpy(),
                  tickers=tuple(f"S{i}" for i in range(60)), times=ends)
    sid = np.random.default_rng(2).integers(-1, 4, size=60)
    rep = run_monthly(panel, mode="rank", n_bins=5, sector_ids=sid, n_sectors=4,
                      device="cpu")
    res = sector_neutral_backtest(pm, mm, torch.as_tensor(sid), 4, mode="rank", n_bins=5)
    np.testing.assert_array_equal(rep.labels, res.labels.numpy())
    assert rep.mean_spread == float(res.mean_spread) and np.isfinite(rep.mean_spread)
    with pytest.raises(ValueError, match="n_sectors"):
        run_monthly(panel, sector_ids=sid, device="cpu")

    rank = run_grid(panel, Js=(3, 6), Ks=(1, 3), mode="rank", device="cpu")
    hist = run_grid(panel, Js=(3, 6), Ks=(1, 3), mode="hist", device="cpu")
    np.testing.assert_array_equal(hist.spreads, rank.spreads)
    for impl in ("matmul", "matmul_bf16"):
        g = run_grid(panel, Js=(3, 6), Ks=(1, 3), mode="hist", impl=impl, device="cpu")
        np.testing.assert_array_equal(g.spread_valid, rank.spread_valid)
        if impl == "matmul":
            np.testing.assert_allclose(g.spreads, rank.spreads, **TOL)


def _jax_research_fingerprints():
    """The reference's values of chip_smoke.RESEARCH, recomputed."""
    from csmom_tpu.backtest.grid import grid_break_even_bps, grid_net_of_costs
    from csmom_tpu.backtest.monthly import net_of_costs
    from csmom_tpu.backtest.monthly import sector_neutral_backtest as jsector
    from csmom_tpu.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu.panel.synthetic import synthetic_daily_panel

    smoke = _chip_smoke()
    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    pm, mm = month_end_aggregate(jnp.asarray(daily.values), jnp.asarray(daily.mask),
                                 seg, len(ends))
    sid = jnp.asarray(smoke.golden_sector_ids(40), jnp.int32)
    sec = jsector(pm, mm, sid, smoke.GOLDEN_SECTORS, lookback=12, skip=1)
    _, net_mean, net_sharpe = net_of_costs(sec, half_spread=0.001)
    Js = Ks = (3, 6, 9, 12)
    g = jax_grid(pm, mm, np.array(Js), np.array(Ks), skip=1, mode="rank")
    unit = grid_net_of_costs(pm, mm, g, half_spread=1.0)
    be, _ = grid_break_even_bps(pm, mm, g, unit=unit)
    wf = jwf.walk_forward_select(g.spreads, g.spread_valid)
    lo, hi = jtables.jk_grid_ci_table(g.spreads, g.spread_valid, Js, Ks,
                                      key=jax.random.PRNGKey(0), n_samples=200)
    key = jax.random.PRNGKey(0)
    draws = {
        "randint32": jax.random.randint(key, (200, 116), 0, 696, dtype=jnp.int32),
        "randint64": jax.random.randint(key, (200, 116), 0, 696, dtype=jnp.int64),
        "uniform32": jax.random.uniform(key, (200, 116), dtype=jnp.float32),
    }
    got = {
        "sector_valid": int(np.asarray(sec.spread_valid).sum()),
        "sector_mean_spread": float(sec.mean_spread),
        "sector_nw_t": float(sec.tstat_nw),
        "net10_mean": float(net_mean),
        "net10_sharpe": float(net_sharpe),
        "grid_unit_net_mean": np.asarray(unit.mean_spread).ravel().tolist(),
        "grid_break_even_bps": np.asarray(be).ravel().tolist(),
        "wf_choice": np.asarray(wf.choice).tolist(),
        "wf_oos_mean": float(wf.mean_spread),
        "ci_lo": lo.to_numpy().ravel().tolist(),
        "ci_hi": hi.to_numpy().ravel().tolist(),
    }
    for name, d in draws.items():
        d = np.asarray(d)
        got[f"{name}_sum"] = float(d.astype(np.float64).sum())
        got[f"{name}_head"] = d.ravel()[:8].tolist()
    return got


def test_research_fingerprints_pinned_for_the_card():
    """chip_smoke.py's RESEARCH pins are the reference's outputs, and the
    port reproduces them here on the CPU with the function the smoke runs
    on the card."""
    smoke = _chip_smoke()
    smoke.check_research(_jax_research_fingerprints())
    smoke.check_research(smoke.research_fingerprints(torch.device("cpu")))


def test_new_entry_options_raise_without_a_card():
    """The new options keep the default device: cuda, raising without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    panel = Panel(values=np.ones((3, 4)), mask=np.ones((3, 4), bool),
                  tickers=("a", "b", "c"), times=np.arange(4).astype("datetime64[D]"))
    for call in (lambda: run_monthly(panel, sector_ids=[0, 1, -1], n_sectors=2),
                 lambda: run_grid(panel, mode="hist"),
                 lambda: run_grid(panel, impl="matmul_bf16")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
