"""The port's live-panel streaming (``csmom_tpu_torch.stream``) against
``csmom_tpu.stream`` on the same seeded inputs.

- The reference's ``tests/test_stream.py`` properties on the port's
  copies: immutable versioned snapshots, the closed tick book under every
  arrival disorder, and the incremental updaters equal to the full-panel
  numpy mirrors bit for bit after any seeded interleaving of in-order,
  late, duplicate and dropped ticks, in float32 and float64.
- The same seeded feed through both packages' ring, ingestor and
  updaters gives equal outputs (bit for bit, NaN where NaN) and equal
  books.
- The port's momentum mirror equals its own ``signals.momentum.momentum``
  bit for bit on the CPU; its turnover mirror equals
  ``signals.turnover.turnover_features`` within float-association
  tolerance (rtol 1e-5 in f32, 1e-12 in f64: the engine's cumsum may
  associate differently from a sequential sum), validity exactly.
"""

import random

import numpy as np
import pytest
import torch

from csmom_tpu.stream import incremental as ref_incremental
from csmom_tpu.stream import ingest as ref_ingest
from csmom_tpu.stream import ring as ref_ring
from csmom_tpu_torch.stream import incremental, ingest, ring
from csmom_tpu_torch.stream.incremental import (
    IncrementalMomentum,
    IncrementalTurnover,
    full_momentum_np,
    full_turnover_np,
    nan_equal,
)
from csmom_tpu_torch.stream.ingest import Tick
from csmom_tpu_torch.stream.ring import LiveRing

torch.set_num_threads(2)

PERIOD = 60 * 10**9  # one-minute bars in ns
PORT = (ring, ingest, incremental)
REF = (ref_ring, ref_ingest, ref_incremental)


def _bar(i: int) -> int:
    return 1_700_000_000_000_000_000 + i * PERIOD


# -------------------------------------------------------------------- ring --

def test_ring_append_write_version_monotone():
    r = LiveRing(["a", "b"], capacity=4, fields=("price",))
    v0 = r.version
    i = r.append_bar(_bar(0))
    assert r.version > v0
    v1 = r.version
    r.write("price", "a", i, 10.0)
    assert r.version > v1
    assert r.cell_written("price", "a", i)
    assert not r.cell_written("price", "b", i)


def test_ring_snapshot_is_immutable_and_pinned():
    r = LiveRing(["a", "b"], capacity=4, fields=("price",))
    i = r.append_bar(_bar(0))
    r.write("price", "a", i, 10.0)
    snap = r.snapshot()
    v = snap.version
    j = r.append_bar(_bar(1))
    r.write("price", "a", j, 11.0)
    assert snap.version == v and snap.n_bars == 1
    assert snap.values["price"][0, 0] == 10.0
    with pytest.raises(ValueError):
        snap.values["price"][0, 0] = 99.0  # read-only


def test_ring_wraps_counts_evictions_and_refuses_old_bars():
    r = LiveRing(["a"], capacity=3, fields=("price",))
    for b in range(5):
        i = r.append_bar(_bar(b))
        r.write("price", "a", i, float(b))
    assert (r.n_bars, r.evictions, r.first_bar_index) == (3, 2, 2)
    snap = r.snapshot()
    assert snap.values["price"][0].tolist() == [2.0, 3.0, 4.0]
    assert snap.bar_times.tolist() == [_bar(2), _bar(3), _bar(4)]
    assert not r.in_window(1)
    with pytest.raises(ValueError):
        r.append_bar(_bar(0))


def test_ring_stale_gap_bar_clears_on_real_write():
    r = LiveRing(["a"], capacity=4, fields=("price",))
    r.append_bar(_bar(0))
    g = r.append_bar(_bar(1), stale=True)
    assert r.stats()["stale_bars"] == 1
    r.write("price", "a", g, 5.0)
    assert r.stats()["stale_bars"] == 0


# ------------------------------------------------------------------ ingest --

def _mk(mods=PORT, A=3, capacity=32, lateness=2):
    ring_m, ingest_m, _ = mods
    tickers = [f"a{i}" for i in range(A)]
    r = ring_m.LiveRing(tickers, capacity=capacity, fields=("price", "volume"))
    ing = ingest_m.StreamIngestor(r, ingest_m.WatermarkPolicy(
        bar_period_ns=PERIOD, allowed_lateness_bars=lateness))
    return r, ing


# (ticks as (asset, bar, price), lateness, expected outcomes)
_INGEST_CASES = {
    "in_order": ([("a0", 0, 10.0), ("a1", 0, 11.0), ("a0", 1, 10.5)], 2,
                 ["applied", "applied", "applied"]),
    "duplicate": ([("a0", 0, 10.0), ("a0", 0, 99.0)], 2,
                  ["applied", "deduped"]),
    "late_merges": ([("a0", 0, 10.0), ("a0", 2, 12.0), ("a1", 1, 11.0)], 3,
                    ["applied", "applied", "merged_late"]),
    "beyond_watermark": ([("a0", 0, 10.0), ("a0", 5, 15.0), ("a1", 1, 11.0)],
                         1, ["applied", "applied", "quarantined"]),
    "gap_bars": ([("a0", 0, 10.0), ("a0", 3, 13.0)], 2,
                 ["applied", "applied"]),
    "closed_book": ([("a0", 0, 10.0), ("a0", 0, 10.0), ("a0", 4, 14.0),
                     ("a1", 3, 13.0), ("a1", 0, 10.0)], 1,
                    ["applied", "deduped", "applied", "merged_late",
                     "quarantined"]),
    "nan_price_does_not_poison_dedupe": (
        [("a0", 0, 10.0), ("a1", 0, float("nan")), ("a1", 0, 11.0)], 2,
        ["applied", "quarantined", "applied"]),
    "inf_price_does_not_advance_the_grid": (
        [("a0", 0, 10.0), ("a0", 5, float("inf")), ("a0", 1, 11.0)], 2,
        ["applied", "quarantined", "applied"]),
}


@pytest.mark.parametrize("case", sorted(_INGEST_CASES))
def test_ingest_outcomes_books_and_panel_equal_the_reference(case):
    """Each disorder lands as the reference's outcome, with the same
    books, the same ring version and the same snapshot (NaN in the same
    cells, stale bars materialized, never carried)."""
    ticks, lateness, want = _INGEST_CASES[case]
    got = {}
    for name, mods in (("port", PORT), ("ref", REF)):
        r, ing = _mk(mods, lateness=lateness)
        outs = [ing.offer(mods[1].Tick(a, _bar(b), p, 100.0))
                for a, b, p in ticks]
        snap = r.snapshot()
        got[name] = (outs, ing.accounting(), r.version, r.stats(),
                     snap.values["price"], snap.mask["price"], snap.stale,
                     [q["reason"] for q in ing.quarantine])
        assert ing.invariant_violations() == []
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0] == want
    assert port[1:4] == ref[1:4]
    for a, b in zip(port[4:7], ref[4:7]):
        assert nan_equal(a, b)
    assert port[7] == ref[7]


def test_ingest_gap_is_masked_nan_never_carried():
    r, ing = _mk()
    ing.offer(Tick("a0", _bar(0), 10.0))
    ing.offer(Tick("a0", _bar(3), 13.0))
    snap = r.snapshot()
    assert ing.gap_bars == 2 and snap.n_bars == 4
    assert snap.stale.tolist() == [False, True, True, False]
    assert not snap.mask["price"][0, 1] and np.isnan(snap.values["price"][0, 1])


# ---------------------------------------------- incremental property tests --

def _drive(mods, seed: int, dtype, A=5, B=40, lateness=2, lookback=6,
           skip=1, turn_lookback=3, capacity=None):
    """One seeded disordered feed (cell gaps, late within and beyond the
    allowance, duplicates, whole-bar gaps) through ``mods``' ring,
    ingestor and updaters.  After every closed bar the incremental state
    must equal the full-panel mirror bit for bit; returns each bar's
    outputs, the books and the updaters' counters."""
    ring_m, ingest_m, inc_m = mods
    rng = random.Random(seed)
    r = np.random.default_rng(seed)
    prices = (100.0 * np.exp(np.cumsum(r.normal(0, 0.02, (A, B)),
                                       axis=1))).astype(dtype)
    vols = r.lognormal(8.0, 0.5, (A, B)).astype(dtype)
    tickers = [f"a{i}" for i in range(A)]
    lr = ring_m.LiveRing(tickers, capacity=capacity or B,
                         fields=("price", "volume"), dtype=dtype)
    ing = ingest_m.StreamIngestor(lr, ingest_m.WatermarkPolicy(
        bar_period_ns=PERIOD, allowed_lateness_bars=lateness))
    mom = inc_m.IncrementalMomentum(A, lookback=lookback, skip=skip,
                                    dtype=dtype)
    turn = inc_m.IncrementalTurnover(A, shares=np.ones(A),
                                     lookback=turn_lookback, dtype=dtype)
    held, trail = [], []
    outcomes = {"dropped": 0}

    def _offer(t):
        out = ing.offer(t)
        if out == "merged_late":
            mom.mark_dirty()
            turn.mark_dirty()
        outcomes[out] = outcomes.get(out, 0) + 1

    for b in range(B):
        if rng.random() < 0.05 and 0 < b < B - 1:
            outcomes["dropped"] += A
            continue
        for a in rng.sample(range(A), A):
            t = ingest_m.Tick(tickers[a], _bar(b), float(prices[a, b]),
                              float(vols[a, b]))
            u = rng.random()
            if u < 0.05:
                outcomes["dropped"] += 1
                continue
            if u < 0.20:
                held.append((b + rng.randint(1, lateness + 2), t))
                continue
            _offer(t)
            if u < 0.28:
                _offer(t)
        for h in list(held):
            if h[0] <= b:
                _offer(h[1])
                held.remove(h)
        if lr.next_bar_index == 0:
            continue
        snap = lr.snapshot()
        mom.sync(snap)
        turn.sync(snap)
        ref_m, ref_mok = inc_m.full_momentum_np(
            np.asarray(snap.values["price"], dtype), snap.mask["price"],
            lookback, skip)
        ref_t, ref_tok = inc_m.full_turnover_np(
            np.asarray(snap.values["volume"], dtype), snap.mask["volume"],
            np.ones(A), turn_lookback)
        cur_m, cur_mok = mom.current()
        cur_t, cur_tok = turn.current()
        if snap.first_bar_index == 0:   # anchored: the mirror is bitwise
            assert nan_equal(cur_m, ref_m[:, -1]), (seed, b, "momentum")
            assert np.array_equal(cur_mok, ref_mok[:, -1])
            assert nan_equal(cur_t, ref_t[:, -1]), (seed, b, "turnover")
            assert np.array_equal(cur_tok, ref_tok[:, -1])
        trail.append((cur_m, cur_mok, cur_t, cur_tok))
        if b % 8 == 7:
            assert not mom.reconcile(snap)["drift"]
            assert not turn.reconcile(snap)["drift"]
    assert ing.invariant_violations() == []
    counters = (mom.stats(), turn.stats(), ing.accounting(), lr.stats())
    return trail, outcomes, counters


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_incremental_equals_full_recompute_and_the_reference(seed, dtype):
    """The reference's property test on the port, then the same feed
    through the reference: every bar's outputs bit for bit, and the
    same books and rebuild counts."""
    trail, outcomes, counters = _drive(PORT, seed, dtype)
    assert outcomes.get("merged_late", 0) > 0
    assert outcomes.get("deduped", 0) > 0 and outcomes["dropped"] > 0
    assert counters[0]["rebuilds"] > 0
    assert counters[0]["drift_events"] == counters[1]["drift_events"] == 0
    ref_trail, ref_outcomes, ref_counters = _drive(REF, seed, dtype)
    assert outcomes == ref_outcomes and counters == ref_counters
    assert len(trail) == len(ref_trail)
    for got, want in zip(trail, ref_trail):
        for g, w in zip(got, want):
            assert nan_equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_wrapped_ring_reconciles_without_drift_like_the_reference(dtype):
    """A ring smaller than the feed: syncs past evicted bars rebuild,
    reconciles re-anchor (counted, not drift), and both packages agree
    bar for bar."""
    trail, _, counters = _drive(PORT, 3, dtype, B=48, capacity=16)
    assert counters[0]["reanchors"] > 0 and counters[1]["reanchors"] > 0
    assert counters[0]["drift_events"] == counters[1]["drift_events"] == 0
    ref_trail, _, ref_counters = _drive(REF, 3, dtype, B=48, capacity=16)
    assert counters == ref_counters
    for got, want in zip(trail, ref_trail):
        for g, w in zip(got, want):
            assert nan_equal(g, w)


def test_sync_rebuilds_when_ring_window_moves_past_consumed():
    A, cap = 3, 8
    lr = LiveRing([f"a{i}" for i in range(A)], capacity=cap,
                  fields=("price",), dtype=np.float64)
    mom = IncrementalMomentum(A, lookback=2, skip=0, dtype=np.float64)
    r = np.random.default_rng(5)

    def _bar_full(b):
        i = lr.append_bar(_bar(b))
        for a in range(A):
            lr.write("price", a, i, float(100 + r.normal()))

    for b in range(4):
        _bar_full(b)
    mom.sync(lr.snapshot())
    assert mom.consumed == 4 and mom.rebuilds == 0
    for b in range(4, 14):
        _bar_full(b)
    snap = lr.snapshot()
    assert snap.first_bar_index > mom.consumed
    mom.sync(snap)
    assert mom.rebuilds == 1
    ref_m, ref_ok = full_momentum_np(np.asarray(snap.values["price"]),
                                     snap.mask["price"], 2, 0)
    cur_m, cur_ok = mom.current()
    assert nan_equal(cur_m, ref_m[:, -1]) and np.array_equal(cur_ok, ref_ok[:, -1])


@pytest.mark.parametrize("wrap", [False, True], ids=["anchored", "wrapped"])
def test_reconcile_detects_seeded_drift_and_rebuilds(wrap):
    """Corrupted running state is counted as drift and rebuilt, in the
    anchored regime and across a re-anchor (which must not become a
    blind spot)."""
    A = 3
    lr = LiveRing([f"a{i}" for i in range(A)], capacity=8 if wrap else 32,
                  fields=("price",), dtype=np.float64)
    mom = IncrementalMomentum(A, lookback=2, skip=0, dtype=np.float64)
    for b in range(20):
        i = lr.append_bar(_bar(b))
        for a in range(A):
            lr.write("price", a, i, float(100 + a + 0.5 * b))
        for g in range(mom.consumed, lr.next_bar_index):
            mom.update(*lr.column("price", g))
    snap = lr.snapshot()
    if not wrap:
        assert mom.reconcile(snap)["drift"] is False
    mom._mom = mom._mom + 1.0  # sabotage the running output state
    verdict = mom.reconcile(snap)
    assert verdict["drift"] is True and verdict["reanchored"] is wrap
    assert mom.drift_events == 1
    assert mom.reconcile(lr.snapshot())["drift"] is False


def test_turnover_reanchor_residue_is_not_drift():
    """f32 prefix sums from global bar 0 against a window-anchored
    recompute differ by cancellation residue: a re-anchor, not drift."""
    A = 4
    lr = LiveRing([f"a{i}" for i in range(A)], capacity=16,
                  fields=("volume",), dtype=np.float32)
    turn = IncrementalTurnover(A, shares=np.ones(A), lookback=3,
                               dtype=np.float32)
    for b in range(60):
        i = lr.append_bar(_bar(b))
        for a in range(A):
            lr.write("volume", a, i,
                     float(1e7 * (1.0 + 0.001 * ((a * 7 + b * 13) % 17))))
        for g in range(turn.consumed, lr.next_bar_index):
            turn.update(*lr.column("volume", g))
    snap = lr.snapshot()
    live_val, _ = turn.current()
    ref_val, _ = full_turnover_np(np.asarray(snap.values["volume"]),
                                  snap.mask["volume"], np.ones(A), 3)
    assert not nan_equal(live_val, ref_val[:, -1])
    verdict = turn.reconcile(snap)
    assert verdict["drift"] is False and verdict["reanchored"] is True
    assert nan_equal(turn.current()[0], ref_val[:, -1])


# ------------------------------------------- mirrors against the engines --

def _gappy_panel(seed, A, T, dtype):
    r = np.random.default_rng(seed)
    prices = (100.0 * np.exp(np.cumsum(r.normal(0, 0.03, (A, T)),
                                       axis=1))).astype(dtype)
    mask = r.random((A, T)) > 0.12
    mask[:, 0] = True
    mask[0, T // 2:] = False   # delists mid-panel
    mask[1, :T // 3] = False   # lists late
    return np.where(mask, prices, np.nan).astype(dtype), mask


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_momentum_mirror_equals_the_ports_engine_bit_for_bit(dtype):
    from csmom_tpu_torch.signals.momentum import momentum

    values, mask = _gappy_panel(11, 6, 48, dtype)
    ref_m, ref_ok = full_momentum_np(values, mask, 6, 1)
    got_m, got_ok = momentum(torch.from_numpy(values), torch.from_numpy(mask),
                             lookback=6, skip=1)
    assert np.array_equal(got_ok.numpy(), ref_ok)
    assert nan_equal(got_m.numpy(), ref_m)
    # and the port's mirror is the reference's, bit for bit
    assert nan_equal(ref_m, ref_incremental.full_momentum_np(values, mask, 6, 1)[0])


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_turnover_mirror_equals_the_ports_engine_to_association(dtype, rtol):
    from csmom_tpu_torch.signals.turnover import turnover_features

    values, mask = _gappy_panel(13, 6, 48, dtype)
    vols = np.where(mask, np.abs(values) * 37.0, np.nan).astype(dtype)
    shares = np.ones(6)
    ref_t, ref_ok = full_turnover_np(vols, mask, shares, 3)
    got_t, got_ok = turnover_features(torch.from_numpy(vols),
                                      torch.from_numpy(mask),
                                      shares.astype(dtype), lookback=3)["turn_avg"]
    assert np.array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_allclose(got_t.numpy()[ref_ok], ref_t[ref_ok], rtol=rtol)
    assert nan_equal(ref_t, ref_incremental.full_turnover_np(vols, mask, shares, 3)[0])
