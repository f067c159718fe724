"""Event-time replay: drive a tick log through ingest -> update -> serve.

Counterpart of ``csmom_tpu.stream.replay``.  A synthetic bar-tick log is
driven through the watermark ingestor, the incremental updaters and the
signal service, deterministically (one seed reproduces the exact
stream), on the event-time clock (ordering and lateness come from tick
stamps; the wall is read only to report throughput), and
chaos-injectable (late, out-of-order, duplicate and gap ticks and an
ingest-serve version skew are fault-plan actions interpreted at the
``stream.tick`` / ``stream.serve`` checkpoints).

The run's artifact (kind ``replay``, ``GPU_REPLAY_<run>.json`` when the
CLI lands it) carries two closed books the schema refuses to bend:

- tick accounting: ``applied + merged_late + quarantined + deduped ==
  offered`` and ``offered == generated + duplicated - dropped_gap``;
- version reconciliation: every served response's ``panel_version`` is
  one the ingestor issued, and a request whose snapshot version skews
  beyond the allowed window is refused and counted (``skew_refusals``).

Engines: ``engine="torch"`` (the reference's ``"jax"`` means the same)
serves from :class:`~csmom_tpu_torch.serve.engine.TorchEngine` on
``device`` (None = cuda, raising without a card and naming
``device="cpu"``) and reconciles against the port's
``signals.momentum.momentum`` and ``signals.turnover.turnover_features``
on that device at the padded ``(a_bucket, bars)`` shape; ``"stub"``
serves from the numpy stub and reconciles against the numpy mirrors
only.

``compile.in_window_fresh_compiles`` counts the kernel libraries built
or loaded since the warm-up (:func:`csmom_tpu_torch.ops.build.
libraries_built_or_loaded`), as the serve artifact does: 0 means the
replay window ran on what the warm-up built.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import random

import numpy as np

from csmom_tpu_torch.serve.loadgen import _percentiles, write_artifact
from csmom_tpu_torch.stream.incremental import (
    IncrementalMomentum,
    IncrementalTurnover,
)
from csmom_tpu_torch.stream.ingest import StreamIngestor, Tick, WatermarkPolicy
from csmom_tpu_torch.stream.ring import LiveRing
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["ReplayConfig", "REPLAY_BARS", "REPLAY_SMOKE_BARS",
           "builtin_fault_plan", "run_replay", "synth_tick_log",
           "write_artifact"]

SCHEMA_VERSION = 1

# the canonical replay panel lengths (the full and the smoke preset); the
# reconcile runs the signal engines at exactly these time axes
REPLAY_BARS = 96
REPLAY_SMOKE_BARS = 32


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """One replay run (everything the artifact needs to be replayed)."""

    run_id: str = "smoke"
    seed: int = 0
    n_assets: int = 8
    bars: int = REPLAY_SMOKE_BARS
    # ring capacity in bars.  None = the default 3/4 of the log (floored
    # at the serve window), so every replay wraps the ring and exercises
    # the window-slide reconcile path; capacity == bars keeps every bar
    # (the reference's REPLAY_r12.json configuration)
    capacity: int | None = None
    bar_period_ns: int = 60_000_000_000        # one-minute bars
    t0_ns: int = 1_700_000_000_000_000_000     # event-time origin
    allowed_lateness_bars: int = 3
    max_delay_bars: int = 6                    # chaos tick_late delays
    engine: str = "stub"                       # "torch" ("jax") | "stub"
    device: str | None = None                  # the torch engine's device
    profile: str = "serve-smoke"               # serve bucket profile
    serve_every_bars: int = 4
    requests_per_probe: int = 2
    deadline_s: float = 3.0
    reconcile_every_bars: int = 8
    lookback: int = 12
    skip: int = 1
    turn_lookback: int = 3
    dtype: str = "float32"
    max_version_skew: int = 0                  # the feed is synchronous

    def resolved_capacity(self) -> int:
        """The ring capacity this run uses (see ``capacity``)."""
        if self.capacity is not None:
            return int(self.capacity)
        from csmom_tpu_torch.serve.buckets import bucket_spec

        months = bucket_spec(self.profile).months
        return max(months, (3 * self.bars) // 4)

    def validate(self) -> None:
        from csmom_tpu_torch.serve.buckets import bucket_spec

        if self.engine not in ("torch", "jax", "stub"):
            raise ValueError(f"unknown replay engine {self.engine!r}: use "
                             "'torch' (or 'jax') or 'stub'")

        spec = bucket_spec(self.profile)
        if self.bars < spec.months:
            raise ValueError(
                f"bars={self.bars} < serve months {spec.months} "
                f"(profile {self.profile!r}): the serve leg could never "
                "slice a scoring window")
        if self.resolved_capacity() < spec.months:
            raise ValueError(
                f"capacity={self.resolved_capacity()} < serve months "
                f"{spec.months}: a snapshot window could never carry a "
                "full scoring history")
        if self.n_assets > spec.max_assets:
            raise ValueError(
                f"n_assets={self.n_assets} exceeds the largest serve "
                f"bucket ({spec.max_assets})")
        if self.bars < self.lookback + self.skip + 1:
            raise ValueError("bars too short for the momentum window")


def synth_tick_log(cfg: ReplayConfig) -> list:
    """Deterministic bar-ordered tick log: one (price, volume) tick per
    asset per bar, asset order seeded-shuffled within each bar.  Faults
    (not this generator) create the disorder a real feed would."""
    rng = random.Random(cfg.seed)
    r = np.random.default_rng(cfg.seed)
    A, B = cfg.n_assets, cfg.bars
    steps = r.normal(0.0, 0.01, size=(A, B))
    prices = 100.0 * np.exp(np.cumsum(steps, axis=1))
    volumes = r.lognormal(mean=10.0, sigma=0.4, size=(A, B))
    tickers = [f"S{i:03d}" for i in range(A)]
    out = []
    seq = 0
    for b in range(B):
        order = list(range(A))
        rng.shuffle(order)
        bar_time = cfg.t0_ns + b * cfg.bar_period_ns
        for a in order:
            out.append(Tick(asset=tickers[a], bar_time=bar_time,
                            price=float(prices[a, b]),
                            volume=float(volumes[a, b]), seq=seq))
            seq += 1
    return out


def builtin_fault_plan(cfg: ReplayConfig):
    """The canonical replay fault plan: late + out-of-order ticks (a
    deterministic delay cycle straddling the lateness allowance, so both
    merge AND quarantine outcomes occur), duplicates, one whole-bar gap,
    and exactly one ingest-serve version-skew event."""
    from csmom_tpu_torch.chaos.plan import Fault, FaultPlan

    A, B = cfg.n_assets, cfg.bars
    total = A * B
    gap_bar = max(cfg.lookback + cfg.skip + 2, int(B * 0.7))
    return FaultPlan(
        name="replay-builtin-faults", seed=cfg.seed + 12, faults=(
            Fault(point="stream.tick", action="tick_late",
                  after=int(total * 0.35), max_fires=6),
            Fault(point="stream.tick", action="tick_late",
                  after=int(total * 0.55), max_fires=5),
            Fault(point="stream.tick", action="tick_dup",
                  after=int(total * 0.45), max_fires=4),
            Fault(point="stream.tick", action="tick_drop",
                  after=gap_bar * A, max_fires=A),
            Fault(point="stream.serve", action="version_skew",
                  after=2, max_fires=1),
        ))


# ------------------------------------------------------------------- run ---

def _delay_cycle(lateness: int, max_delay: int):
    """Deterministic tick_late delays straddling the watermark: delays
    <= lateness merge late, delays > lateness quarantine — a fault plan
    that fires tick_late more than twice provably exercises BOTH paths."""
    lo = max(1, lateness)
    hi = max(lateness + 2, min(max_delay, lateness + 3))
    return itertools.cycle([lo, hi, max(1, lateness - 1), hi + 1])


def _pad_for_engine(values, mask, a_bucket: int, bars: int, dtype):
    """Left-pad the time axis and bottom-pad the asset axis up to the
    ``(a_bucket, bars)`` reconcile shape.  Padding is masked, so the
    padded engines' last column equals the unpadded recompute for the
    real rows (row-independent signals; leading masked columns shift
    indices, never trailing-window values)."""
    A, T = values.shape
    out_v = np.full((a_bucket, bars), np.nan, dtype)
    out_m = np.zeros((a_bucket, bars), bool)
    out_v[:A, bars - T:] = values
    out_m[:A, bars - T:] = mask
    return out_v, out_m


class _EngineReconciler:
    """Reconciliation against the port's signal engines on the service's
    device (``signals.momentum.momentum`` and ``signals.turnover.
    turnover_features``), always at the padded ``(a_bucket, bars)`` shape:
    the incremental state is held against the batch engines themselves,
    not only against the numpy mirrors."""

    def __init__(self, cfg: ReplayConfig, a_bucket: int, device):
        self.cfg = cfg
        self.a_bucket = a_bucket
        self.device = device
        self.checks = 0
        self.max_abs_diff = 0.0

    def warm(self) -> None:
        z = np.zeros((self.a_bucket, self.cfg.bars),
                     np.dtype(self.cfg.dtype))
        m = np.zeros((self.a_bucket, self.cfg.bars), bool)
        self._mom(z, m)
        self._turn(z, m)

    def _run(self, fn, v, m):
        """``fn`` on the device; the device is synchronized before the
        result is read back."""
        import torch

        out, ok = fn(torch.from_numpy(v).to(self.device),
                     torch.from_numpy(m).to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out.cpu().numpy(), ok.cpu().numpy()

    def _mom(self, v, m):
        from csmom_tpu_torch.signals.momentum import momentum

        return self._run(lambda tv, tm: momentum(
            tv, tm, lookback=self.cfg.lookback, skip=self.cfg.skip), v, m)

    def _turn(self, v, m):
        from csmom_tpu_torch.signals.turnover import turnover_features

        shares = np.ones(self.a_bucket, v.dtype)
        return self._run(lambda tv, tm: turnover_features(
            tv, tm, shares, lookback=self.cfg.turn_lookback)["turn_avg"],
            v, m)

    def check(self, snapshot, mom_cur, turn_cur) -> None:
        dt = np.dtype(self.cfg.dtype)
        A = snapshot.n_assets
        pv, pm = _pad_for_engine(
            np.asarray(snapshot.values["price"], dt),
            snapshot.mask["price"], self.a_bucket, self.cfg.bars, dt)
        mom, _ = self._mom(pv, pm)
        vv, vm = _pad_for_engine(
            np.asarray(snapshot.values["volume"], dt),
            snapshot.mask["volume"], self.a_bucket, self.cfg.bars, dt)
        turn, _ = self._turn(vv, vm)
        for ref, cur in ((mom[:A, -1], mom_cur), (turn[:A, -1], turn_cur)):
            both = np.isfinite(ref) & np.isfinite(cur)
            if both.any():
                d = float(np.max(np.abs(ref[both] - cur[both])))
                self.max_abs_diff = max(self.max_abs_diff, d)
        self.checks += 1


def run_replay(cfg: ReplayConfig) -> dict:
    """Drive the full loop; returns the replay artifact object.  A torch
    engine on the default device raises without a card, naming
    ``device="cpu"``."""
    from csmom_tpu_torch.chaos.inject import checkpoint
    from csmom_tpu_torch.obs import metrics, span
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    cfg.validate()
    torch_engine = cfg.engine != "stub"
    dt = np.dtype(cfg.dtype)
    log = synth_tick_log(cfg)
    tickers = sorted({t.asset for t in log})
    ring = LiveRing(tickers, capacity=cfg.resolved_capacity(),
                    fields=("price", "volume"), dtype=dt)
    ing = StreamIngestor(ring, WatermarkPolicy(
        bar_period_ns=cfg.bar_period_ns,
        allowed_lateness_bars=cfg.allowed_lateness_bars))
    mom_upd = IncrementalMomentum(len(tickers), lookback=cfg.lookback,
                                  skip=cfg.skip, dtype=dt)
    turn_upd = IncrementalTurnover(len(tickers),
                                   shares=np.ones(len(tickers)),
                                   lookback=cfg.turn_lookback, dtype=dt)

    svc = SignalService(ServeConfig(
        profile=cfg.profile, engine="torch" if torch_engine else "stub",
        device=cfg.device if torch_engine else None,
        default_deadline_s=cfg.deadline_s))
    svc.attach_live_version(lambda: ring.version,
                            max_skew=cfg.max_version_skew)
    svc.start()
    spec = svc.spec
    a_bucket = spec.asset_bucket_for(len(tickers))

    engine_rec = None
    builds0 = None
    if torch_engine:
        from csmom_tpu_torch.ops import build

        engine_rec = _EngineReconciler(cfg, a_bucket, svc.engine.device)
        engine_rec.warm()  # after this, the window must build nothing
        builds0 = build.libraries_built_or_loaded()

    delays = _delay_cycle(cfg.allowed_lateness_bars, cfg.max_delay_bars)
    held: list = []               # (release_bar, tick) — late/ooo buffer
    dropped_gap = 0
    duplicated = 0
    requests: list = []           # (request, snapshot_last_bar_time)
    bar_clock: list = []          # (mono wall, ingest frontier bar time)
    held_snapshot = None          # the stale snapshot a skew event serves
    skew_events = 0               # probes that served from a stale snapshot
    skew_attempts = 0             # stale-version REQUESTS submitted

    by_bar: dict = {}
    for t in log:
        by_bar.setdefault(t.bar_time, []).append(t)
    bar_times = sorted(by_bar)

    def _on_merge_or_outcome(outcome: str) -> None:
        if outcome == "merged_late":
            mom_upd.mark_dirty()
            turn_upd.mark_dirty()
        metrics.counter(f"replay.{outcome}").inc()

    def _release(upto_bar_idx: int) -> None:
        still = []
        for rel, tick in held:
            if rel <= upto_bar_idx:
                _on_merge_or_outcome(ing.offer(tick))
            else:
                still.append((rel, tick))
        held[:] = still

    def _probe(bar_idx: int) -> None:
        nonlocal held_snapshot, skew_events, skew_attempts
        snap = ring.snapshot()
        mom_upd.sync(snap)
        turn_upd.sync(snap)
        if snap.n_bars < spec.months:
            return
        if held_snapshot is None:
            held_snapshot = snap
        fired = checkpoint("stream.serve", bar=bar_idx,
                           version=snap.version)
        use = snap
        if fired == "version_skew" and held_snapshot.version < snap.version:
            use = held_snapshot      # serve from a stale panel: must refuse
            skew_events += 1
        for k in range(cfg.requests_per_probe):
            kind = "momentum" if k % 2 == 0 else "turnover"
            field = "price" if kind == "momentum" else "volume"
            v, m = use.window(field, spec.months)
            if use is held_snapshot and use is not snap:
                skew_attempts += 1
            requests.append((svc.submit(
                kind, np.asarray(v, np.dtype(spec.dtype)), m,
                deadline_s=cfg.deadline_s, panel_version=use.version),
                use.last_bar_time))

    def _reconcile(bar_idx: int) -> None:
        snap = ring.snapshot()
        mom_upd.reconcile(snap)
        turn_upd.reconcile(snap)
        if engine_rec is not None:
            engine_rec.check(snap, mom_upd.current()[0],
                             turn_upd.current()[0])

    t_start = mono_now_s()
    with span("replay.run", root=True, run=cfg.run_id, bars=cfg.bars):
        for b, bt in enumerate(bar_times):
            for tick in by_bar[bt]:
                fired = checkpoint("stream.tick", seq=tick.seq, bar=b)
                if fired == "tick_drop":
                    dropped_gap += 1
                    continue
                if fired == "tick_late":
                    held.append((b + next(delays), tick))
                    continue
                outcome = ing.offer(tick)
                _on_merge_or_outcome(outcome)
                if fired == "tick_dup":
                    duplicated += 1
                    _on_merge_or_outcome(ing.offer(tick))
            _release(b)
            bar_clock.append((mono_now_s(), ring.last_bar_time))
            # consume the bar(s) just closed into the running updaters
            snap_needed = mom_upd.dirty or turn_upd.dirty
            if not snap_needed:
                for g in range(mom_upd.consumed, ring.next_bar_index):
                    pv, pm = ring.column("price", g)
                    vv, vm = ring.column("volume", g)
                    mom_upd.update(pv, pm)
                    turn_upd.update(vv, vm)
            else:
                snap = ring.snapshot()
                mom_upd.sync(snap)
                turn_upd.sync(snap)
            if (b + 1) % cfg.serve_every_bars == 0:
                _probe(b)
            if b and (b + 1) % cfg.reconcile_every_bars == 0:
                _reconcile(b)
        # end of log: flush the late buffer, close the books.  A flushed
        # tick for the FINAL bar lands as 'applied' — but that bar was
        # already consumed, so it dirties the updaters exactly like a
        # merge (the final reconcile would otherwise read it as drift)
        for rel, tick in held:
            _on_merge_or_outcome(ing.offer(tick))
            mom_upd.mark_dirty()
            turn_upd.mark_dirty()
        held.clear()
        _reconcile(len(bar_times))
        give_up = mono_now_s() + 30.0
        for r, _ in requests:
            r.wait(timeout=max(0.0, give_up - mono_now_s()))
        svc.stop(drain=True)
    wall_s = mono_now_s() - t_start

    # served-response staleness: how far ingest had moved past each
    # response's snapshot by the time the response completed — measured
    # against the per-bar ingest clock, served requests only (a refused
    # skew probe's lag is the injected fault, not serving staleness)
    walls = [w for w, _ in bar_clock]
    staleness_ms: list = []
    for r, snap_last in requests:
        if r.state != "served" or r.t_done_s is None:
            continue
        i = bisect.bisect_right(walls, r.t_done_s) - 1
        frontier = bar_clock[i][1] if i >= 0 else snap_last
        staleness_ms.append(max(0, frontier - snap_last) / 1e6)

    fresh = 0
    if builds0 is not None:
        fresh = build.libraries_built_or_loaded() - builds0
    return build_artifact(
        cfg, ing, ring, svc, [r for r, _ in requests], wall_s,
        generated=len(log), dropped_gap=dropped_gap, duplicated=duplicated,
        staleness_ms=staleness_ms, skew_events=skew_events,
        skew_attempts=skew_attempts,
        mom_upd=mom_upd, turn_upd=turn_upd, engine_rec=engine_rec,
        fresh_compiles=fresh,
    )


def build_artifact(cfg, ing, ring, svc, requests, wall_s, *, generated,
                   dropped_gap, duplicated, staleness_ms, skew_events,
                   skew_attempts, mom_upd, turn_upd, engine_rec,
                   fresh_compiles) -> dict:
    """The replay artifact: closed tick books, version reconciliation,
    serve books, reconcile evidence: everything the ``replay`` schema
    kind enforces.  ``extra.engine`` reads ``torch`` or ``stub``."""
    from csmom_tpu_torch.serve.loadgen import _platform

    engine = "stub" if cfg.engine == "stub" else "torch"
    acct = ing.accounting()
    sacct = svc.accounting()
    served = [r for r in requests if r.state == "served"]
    versions = [r.panel_version for r in served
                if r.panel_version is not None]
    ring_stats = ring.stats()
    tps = round(acct["offered"] / wall_s, 3) if wall_s > 0 else 0.0
    workload = (
        f"replay {cfg.bars}x{cfg.n_assets} {cfg.bar_period_ns // 10**9}s-"
        f"bars seed {cfg.seed}, lateness {cfg.allowed_lateness_bars} bars, "
        f"serve profile {cfg.profile} ({cfg.dtype}, {engine} engine)"
    )
    extra = {
        "platform": _platform(svc),
        "engine": engine,
        "workload": workload,
        "warm_report": svc.warm_report,
    }
    if cfg.profile == "serve-smoke":
        extra["smoke"] = ("smoke-bucket replay: pipeline-shaped, workload "
                          "reduced — NOT a performance capture")
    reconcile = {
        "count": mom_upd.reconciliations + turn_upd.reconciliations,
        "drift_events": mom_upd.drift_events + turn_upd.drift_events,
        "rebuilds": mom_upd.rebuilds + turn_upd.rebuilds,
        # window-slide re-anchors (the ring wrapped past the prefix
        # anchor): expected whenever bars > capacity, and not drift
        "reanchors": mom_upd.reanchors + turn_upd.reanchors,
        "engine_checks": 0 if engine_rec is None else engine_rec.checks,
        "engine_max_abs_diff": (
            0.0 if engine_rec is None
            else round(engine_rec.max_abs_diff, 12)),
    }
    return {
        "kind": "replay",
        "schema_version": SCHEMA_VERSION,
        "run_id": cfg.run_id,
        "metric": "replay_ticks_per_s",
        "value": tps,
        "unit": "ticks/s",
        "vs_baseline": 1.0,
        "wall_s": round(wall_s, 4),
        "ticks": {
            "generated": generated,
            "offered": acct["offered"],
            "applied": acct["applied"],
            "merged_late": acct["merged_late"],
            "quarantined": acct["quarantined"],
            "deduped": acct["deduped"],
            "dropped_gap": dropped_gap,
            "duplicated": duplicated,
        },
        "panel": {
            "version_final": ring_stats["version"],
            "bars_appended": ring_stats["bars_appended"],
            "bars_in_window": ring_stats["bars_in_window"],
            "capacity": ring_stats["capacity"],
            "evictions": ring_stats["evictions"],
            "gap_bars": acct["gap_bars"],
            "stale_bars": ring_stats["stale_bars"],
            "unfilled_cells": ring_stats["unfilled_cells"],
            "merge_version_bumps": acct["merge_version_bumps"],
        },
        "versions": {
            "ingest_final": ring_stats["version"],
            "serve_min": min(versions) if versions else None,
            "serve_max": max(versions) if versions else None,
            "skew_events": skew_events,        # stale-snapshot probes
            "skew_attempts": skew_attempts,    # stale-version requests
            "skew_refusals": sacct.get("rejected_version_skew", 0),
        },
        "serve": {
            "requests": sacct,
            "latency_ms": {"total": _percentiles(
                [r.total_s for r in served if r.total_s is not None])},
        },
        "staleness_ms": dict(
            _percentiles([s / 1e3 for s in staleness_ms]),
            max=round(max(staleness_ms), 3) if staleness_ms else None,
            n=len(staleness_ms),
        ),
        "reconcile": reconcile,
        "compile": {
            "in_window_fresh_compiles": fresh_compiles,
            "note": "kernel libraries built or loaded since the warm-up "
                    "(the serve buckets and the reconcile engines): 0 = the "
                    "whole replay window ran on what the warm-up built",
        },
        "offered": {
            "seed": cfg.seed,
            "n_assets": cfg.n_assets,
            "bars": cfg.bars,
            "bar_period_ms": cfg.bar_period_ns / 1e6,
            "allowed_lateness_bars": cfg.allowed_lateness_bars,
            "serve_every_bars": cfg.serve_every_bars,
            "reconcile_every_bars": cfg.reconcile_every_bars,
            "deadline_ms": round(1e3 * cfg.deadline_s, 3),
        },
        "extra": extra,
    }
