"""Deterministic open-loop load generator + the serve artifact writer.

Counterpart of ``csmom_tpu.serve.loadgen``'s in-process half, copied
but for the artifact's platform, its compile note and its file prefix.
Open-loop: arrivals fire on the schedule's clock, not the service's, so
overload shows as queue growth, expiry and backpressure rejection
rather than a throttled generator (no coordinated omission).

Determinism: one seeded ``random.Random`` drives arrival times
(exponential inter-arrivals per schedule segment), the endpoint mix,
the SLO-class mix, universe sizes, panel reuse and the synthetic panels,
so ``(schedule, seed)`` alone gives the same request stream as the
reference's, bit for bit.

Schedules are explicit (``"2x30,2x60"`` = 2 s at 30 req/s, then 2 s at
60) or named: ``bursty`` (quiet baseline and hard bursts), ``diurnal``
(a compressed day) and ``adversarial`` (universe sizes on the bucket
boundaries).  A named schedule also presets the load shape that makes
it meaningful: a heavy ``bulk`` share, reused panels (cache hits) and a
mid-run panel-version bump (cache invalidation, zero stale hits).

The run lands as ``GPU_SERVE_<run>.json`` (the reference's serve schema,
v4): throughput and offered load, request books globally, per SLO class
and per endpoint, the cache book, p50/p95/p99 queue, service and total
latency, the batch-size histogram with padding and fire reasons, the
in-window kernel-build count, and bounded per-request latency samples.
Its ``extra.platform`` is ``"gpu"``, ``"cpu"`` or ``"stub"``.

:func:`run_pool_loadgen` drives the multi-process pool through its
router with the same seeded stream and lands ``GPU_SERVE_POOL_<run>.json``
(the reference's ``serve_pool`` schema v1): the router's closed
cross-process books, availability, the hedge arithmetic, total latency,
the fleet's lifecycle events, each worker's stats, and the sum of the
workers' in-window kernel builds.

:func:`run_fabric_loadgen` drives the three-tier fabric through a
:class:`~csmom_tpu_torch.serve.fabric.FabricClient` and lands
``GPU_SERVE_FABRIC_<run>.json`` (the reference's ``serve_fabric`` schema
v1): the client tier's closed books, per-replica router books, the
worker fleet, and the pool-level cache hit rate.

Both multi-process runs open an armed fleet observatory's demand book
(:mod:`csmom_tpu_torch.obs.fleet`) as their load starts, and their
artifacts say in ``extra.observatory_armed`` whether it was armed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import time

import numpy as np

from csmom_tpu_torch.obs import fleet as obs_fleet
from csmom_tpu_torch.registry import serve_surface, workload_kinds
from csmom_tpu_torch.serve.service import ServeConfig, SignalService
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["LoadConfig", "NAMED_SCHEDULES", "arrival_offsets",
           "build_artifact", "build_fabric_artifact", "build_pool_artifact",
           "parse_schedule", "resolve_schedule", "run_fabric_loadgen",
           "run_loadgen", "run_pool_loadgen", "synth_panel",
           "write_artifact"]

# the reference's serve schema: v3 added per-endpoint books and latency
# (endpoint names validated against the registry), v4 per-class error-
# budget burn and bounded per-request latency samples
SCHEMA_VERSION = 4
# the reference's serve_pool schema
POOL_SCHEMA_VERSION = 1
FABRIC_SCHEMA_VERSION = 1

# the reference's per-worker cache hit rate (its SERVE_MESH_r15.json),
# the baseline its fabric artifact records beside the pool-level rate
# that consistent-hash routing produces
R15_PER_WORKER_HIT_RATE = 0.246

# the default class mix
_DEFAULT_MIX = (("interactive", 0.6), ("standard", 0.15), ("bulk", 0.25))

# named schedules: segment string + the load shape that makes the
# schedule meaningful.  All well under 4 s of wall.
NAMED_SCHEDULES = {
    # quiet baseline punctuated by hard bursts: the bursts outrun the
    # bulk quota (rejected_quota > 0) while interactive stays inside its
    # budget; panels repeat within a version epoch (cache hits) and the
    # panel version bumps mid-run (invalidation, zero stale hits)
    "bursty": {
        "schedule": "0.5x8,0.3x240,0.5x8,0.3x300,0.5x10,0.3x260,0.4x8",
        "class_mix": (("interactive", 0.45), ("standard", 0.15),
                      ("bulk", 0.4)),
        "reuse_fraction": 0.35,
        "version_bumps": 1,
        "use_class_deadlines": True,
    },
    # a compressed trading day: ramp to a midday peak and back down
    "diurnal": {
        "schedule": "0.35x10,0.35x40,0.35x90,0.35x140,0.35x90,"
                    "0.35x40,0.35x10",
        "class_mix": (("interactive", 0.5), ("standard", 0.2),
                      ("bulk", 0.3)),
        "reuse_fraction": 0.25,
        "version_bumps": 1,
        "use_class_deadlines": True,
    },
    # universe sizes hugging the bucket-grid boundaries: every request
    # lands exactly AT a bucket edge or one past it, maximizing padding
    # pressure and bucket churn — the worst honest case for pad_fraction
    "adversarial": {
        "schedule": "1.6x70",
        "class_mix": _DEFAULT_MIX,
        "boundary_hug": True,
        "use_class_deadlines": True,
    },
}


@dataclasses.dataclass(frozen=True)
class Segment:
    duration_s: float
    rps: float


def parse_schedule(spec: str) -> tuple:
    """``"2x25,3x60"`` -> (Segment(2, 25), Segment(3, 60)): run 2 s at
    25 req/s, then 3 s at 60 req/s.  Named schedules resolve first via
    :func:`resolve_schedule`."""
    if spec in NAMED_SCHEDULES:
        spec = NAMED_SCHEDULES[spec]["schedule"]
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            dur, _, rate = part.partition("x")
            out.append(Segment(float(dur), float(rate)))
        except ValueError:
            raise ValueError(
                f"bad schedule segment {part!r}: use DURxRPS, e.g. 2x25, "
                f"or a named schedule ({', '.join(sorted(NAMED_SCHEDULES))})"
            ) from None
    if not out:
        raise ValueError(f"empty schedule {spec!r}")
    return tuple(out)


def resolve_schedule(spec: str) -> tuple:
    """``(schedule_str, schedule_kind, preset_overrides)`` for a CLI
    ``--schedule`` value: named schedules expand to their segments and
    carry the LoadConfig preset that makes them meaningful; an explicit
    DURxRPS string passes through with kind ``custom``."""
    if spec in NAMED_SCHEDULES:
        preset = dict(NAMED_SCHEDULES[spec])
        schedule = preset.pop("schedule")
        return schedule, spec, preset
    return spec, "custom", {}


def schedule_duration_s(segments: tuple) -> float:
    return sum(seg.duration_s for seg in segments)


def arrival_offsets(segments: tuple, rng: random.Random) -> list:
    """Seeded Poisson arrival offsets (seconds from start) covering every
    segment — the deterministic request clock."""
    out: list = []
    t0 = 0.0
    for seg in segments:
        if seg.rps <= 0:
            t0 += seg.duration_s
            continue
        t = t0 + rng.expovariate(seg.rps)
        while t < t0 + seg.duration_s:
            out.append(t)
            t += rng.expovariate(seg.rps)
        t0 += seg.duration_s
    return out


def synth_panel(rng: random.Random, n_assets: int, months: int,
                kind: str) -> tuple:
    """One deterministic request panel: a positive random walk (prices)
    or positive level noise (volume), with a seeded sprinkle of masked
    gaps so the mask path is always exercised.  The family is the
    REGISTERED endpoint's declaration (``panel_family``), so a new
    endpoint states what its synthetic workload looks like at
    registration instead of patching the generator."""
    r = np.random.default_rng(rng.getrandbits(32))
    try:
        family = serve_surface(kind).panel_family
    except (KeyError, ValueError):
        family = "price"  # an unknown kind still gets a well-formed panel
    if family == "volume":
        values = r.lognormal(mean=12.0, sigma=0.5,
                             size=(n_assets, months)).astype(np.float32)
    else:
        steps = r.normal(0.0, 0.04, size=(n_assets, months)).astype(np.float32)
        values = 100.0 * np.exp(np.cumsum(steps, axis=1), dtype=np.float32)
    mask = r.random((n_assets, months)) > 0.02
    mask[:, 0] = True  # every asset observed at least once, from the start
    values = np.where(mask, values, np.nan).astype(np.float32)
    return values, mask


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One load-generation run (everything the artifact must replay)."""

    schedule: str = "2x40"
    seed: int = 0
    kinds: tuple | None = None          # None = every registered workload
    deadline_s: float | None = 0.5
    interactive_fraction: float = 0.7   # legacy 2-class knob (see mix())
    class_mix: tuple | None = None      # ((class, weight), ...) wins
    schedule_kind: str = "custom"       # "bursty"/"diurnal"/... or custom
    reuse_fraction: float = 0.0         # P(reuse a recent panel) -> hits
    version_bumps: int = 0              # mid-run panel_version bumps
    use_class_deadlines: bool = False   # None deadline -> class budget
    boundary_hug: bool = False          # adversarial bucket-edge sizes
    max_assets: int | None = None       # default: the spec's largest bucket
    run_id: str = "smoke"

    def resolved_kinds(self) -> tuple:
        """The endpoint mix: explicit ``kinds`` wins; the default is
        surface (d) — every registered servable engine that opted into
        the synthetic workload, so a newly registered endpoint joins
        the load mix with no loadgen edit."""
        return tuple(self.kinds) if self.kinds else workload_kinds()

    def mix(self) -> tuple:
        """The effective class mix: explicit ``class_mix`` wins; else the
        legacy two-way split (``batch`` spelled as its alias target)."""
        if self.class_mix:
            return tuple(self.class_mix)
        f = self.interactive_fraction
        return (("interactive", f), ("bulk", 1.0 - f))


def _pick_class(mix: tuple, rng: random.Random) -> str:
    total = sum(w for _, w in mix) or 1.0
    x = rng.random() * total
    acc = 0.0
    for name, w in mix:
        acc += w
        if x <= acc:
            return name
    return mix[-1][0]


def _boundary_sizes(spec, max_assets: int) -> list:
    """Bucket-boundary-hugging universe sizes: exactly AT each asset
    bucket (zero asset padding) and one PAST each non-largest bucket
    (forcing the next bucket — maximum padding), clipped to the cap."""
    sizes = set()
    for i, a in enumerate(spec.asset_buckets):
        if a <= max_assets:
            sizes.add(a)
        if i + 1 < len(spec.asset_buckets) and a + 1 <= max_assets:
            sizes.add(a + 1)
    return sorted(sizes) or [max_assets]


# bounded per-request latency sample lists persisted into the artifact
# (extra.samples): enough for obs.regress's block bootstrap to put a CI
# behind every serve p99 row, small enough that a committed artifact
# stays reviewable.  Deterministic: seeded index sample, chronological
# order kept (the block bootstrap assumes consecutive samples share
# state).
SAMPLE_CAP = 512
CLASS_SAMPLE_CAP = 256


def _bounded_samples(values_ms: list, cap: int, seed: int) -> list:
    if len(values_ms) <= cap:
        return [round(v, 4) for v in values_ms]
    idx = sorted(random.Random(seed).sample(range(len(values_ms)), cap))
    return [round(values_ms[i], 4) for i in idx]


def _latency_samples(load: "LoadConfig", requests: list,
                     scope_prefixes: bool = True) -> dict:
    """``extra.samples`` for a serve artifact: total-latency ms per
    request, globally plus per SLO class and per endpoint (scope-keyed,
    so each row has its OWN distribution)."""
    served = [r for r in requests
              if r.state == "served" and r.total_s is not None]
    out = {"serve_total_ms": _bounded_samples(
        [1e3 * r.total_s for r in served], SAMPLE_CAP, load.seed)}
    if not scope_prefixes:
        return out
    for name in sorted({r.priority for r in served}):
        out[f"class:{name}"] = _bounded_samples(
            [1e3 * r.total_s for r in served if r.priority == name],
            CLASS_SAMPLE_CAP, load.seed + 1)
    for kind in load.resolved_kinds():
        mine = [1e3 * r.total_s for r in served if r.kind == kind]
        if mine:
            out[f"ep:{kind}"] = _bounded_samples(mine, CLASS_SAMPLE_CAP,
                                                 load.seed + 2)
    return out


def _percentiles(samples: list) -> dict:
    """Nearest-rank p50/p95/p99 in milliseconds (None when unobserved).

    Nearest-rank is ``ceil(q*N) - 1`` (0-based): with N=2 the p50 is the
    FIRST sample, with N=100 the p99 is the 99th — ``int(q*N)`` would be
    one rank high exactly when q*N is integral, a bias that shifts with
    sample count and would feed the regression gate noise."""
    if not samples:
        return {"p50": None, "p95": None, "p99": None}
    s = sorted(samples)

    def pick(q):
        return round(1e3 * s[max(0, math.ceil(q * len(s)) - 1)], 3)

    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


def run_loadgen(service: SignalService, load: LoadConfig) -> dict:
    """Drive ``service`` with the seeded open-loop schedule; returns the
    artifact object (not yet written).

    The service must be started; it is drained and stopped before the
    books are closed, so the accounting invariant is evaluated on a
    quiet queue.
    """
    rng = random.Random(load.seed)
    segments = parse_schedule(load.schedule)
    offsets = arrival_offsets(segments, rng)
    spec = service.spec
    max_assets = min(load.max_assets or spec.max_assets, spec.max_assets)
    mix = load.mix()
    boundary = (_boundary_sizes(spec, max_assets)
                if load.boundary_hug else None)

    # panel-version epochs: with bumps armed, every request is stamped
    # with the current epoch and the version floor rises mid-run — the
    # cache must show hits inside an epoch and ZERO stale hits across
    # the bump
    epoch = 1 if load.version_bumps > 0 else None
    bump_at = sorted(
        max(1, round(len(offsets) * (k + 1) / (load.version_bumps + 1)))
        for k in range(load.version_bumps)
    ) if load.version_bumps > 0 else []
    kinds = load.resolved_kinds()
    recent: dict = {k: [] for k in kinds}

    requests = []
    t_start = mono_now_s()
    for i, off in enumerate(offsets):
        if bump_at and i == bump_at[0]:
            bump_at.pop(0)
            epoch += 1
            service.notify_panel_version(epoch)
        delay = (t_start + off) - mono_now_s()
        if delay > 0:
            time.sleep(delay)  # open loop: the schedule's clock rules
        kind = rng.choice(list(kinds))
        pool = recent[kind]
        if pool and rng.random() < load.reuse_fraction:
            values, mask = pool[rng.randrange(len(pool))]
        else:
            if boundary is not None:
                n_assets = boundary[rng.randrange(len(boundary))]
            else:
                n_assets = rng.randint(2, max_assets)
            values, mask = synth_panel(rng, n_assets, spec.months, kind)
            pool.append((values, mask))
            del pool[:-8]  # a small window of reusable recents per kind
        cls = _pick_class(mix, rng)
        requests.append(service.submit(
            kind, values, mask, priority=cls,
            deadline_s=(None if load.use_class_deadlines
                        else load.deadline_s),
            panel_version=epoch,
        ))
    # close the books: wait for every request to reach a terminal state,
    # then drain-stop the worker
    give_up = mono_now_s() + 30.0
    for r in requests:
        r.wait(timeout=max(0.0, give_up - mono_now_s()))
    service.stop(drain=True)
    wall_s = mono_now_s() - t_start
    return build_artifact(service, load, requests, wall_s)


def _platform(service: SignalService) -> str:
    """``"stub"``, or the torch engine's device type: ``"gpu"`` for a
    CUDA device, ``"cpu"``."""
    if service.engine.name == "stub":
        return "stub"
    return "gpu" if service.engine.device.type == "cuda" else "cpu"


def _class_blocks(service: SignalService, requests: list) -> dict:
    """The per-class books + measured latency vs budget.  ``within_budget``
    is the class's p99 promise judged against measurement: True/False
    once the class served anything, None when it never did."""
    from csmom_tpu_torch.obs.metrics import budget_burn

    stats = service.class_stats()
    out = {}
    for name, book in stats.items():
        served = [r for r in requests
                  if r.priority == name and r.state == "served"]
        lat = _percentiles([r.total_s for r in served
                            if r.total_s is not None])
        p99 = lat["p99"]
        budget = book.get("budget_ms")
        violations = (sum(1 for r in served if r.total_s is not None
                          and 1e3 * r.total_s > budget)
                      if budget is not None else 0)
        out[name] = {
            **{k: book[k] for k in ("admitted", "served", "rejected",
                                    "expired", "rejected_quota")},
            "rank": book["rank"],
            "budget_ms": budget,
            "quota_rps": book["quota_rps"],
            "queue_share": book["queue_share"],
            "latency_ms": lat,
            "within_budget": (None if p99 is None or budget is None
                              else bool(p99 <= budget)),
            # SLO error-budget accounting (obs.metrics.budget_burn):
            # observed violation rate over the allowed rate at the 99%
            # target
            "violations": violations,
            "budget_burn": (None if budget is None
                            else budget_burn(len(served), violations)),
        }
    return out


def _endpoint_blocks(load: LoadConfig, requests: list) -> dict:
    """Surface (d)'s evidence: per-ENDPOINT books + latency, keyed by
    registry name.  Every submitted request lands in exactly one
    endpoint's book, so the served counts sum to the global book (a
    schema rule of serve v3)."""
    out = {}
    for kind in load.resolved_kinds():
        mine = [r for r in requests if r.kind == kind]
        served = [r for r in mine if r.state == "served"]
        out[kind] = {
            "submitted": len(mine),
            "served": len(served),
            "rejected": sum(1 for r in mine if r.state == "rejected"),
            "expired": sum(1 for r in mine if r.state == "expired"),
            "latency_ms": _percentiles(
                [r.total_s for r in served if r.total_s is not None]),
        }
    return out


def build_artifact(service: SignalService, load: LoadConfig,
                   requests: list, wall_s: float) -> dict:
    """The serve artifact (schema v4): headline + offered load + global,
    per-class AND per-endpoint accounting + cache book + latency +
    batches."""
    acct = service.accounting()
    served = [r for r in requests if r.state == "served"]
    throughput = round(acct["served"] / wall_s, 3) if wall_s > 0 else 0.0
    segments = parse_schedule(load.schedule)
    duration = schedule_duration_s(segments)
    offered_rps = round(len(requests) / duration, 3) if duration else 0.0
    lat = {
        "queue": _percentiles(
            [r.queue_wait_s for r in requests if r.queue_wait_s is not None]),
        "service": _percentiles(
            [r.service_s for r in served if r.service_s is not None]),
        "total": _percentiles(
            [r.total_s for r in served if r.total_s is not None]),
    }
    fresh = service.fresh_compiles()
    spec = service.spec
    sched_label = (load.schedule_kind if load.schedule_kind != "custom"
                   else load.schedule)
    # the mesh engine's workload string carries its device count: d1 and
    # d8 runs are different experiments and must never be paired
    mesh = None
    mesh_note = ""
    if hasattr(service.engine, "mesh_info"):
        mesh = service.engine.mesh_info(spec)
        mesh["scaling"] = service.engine.scaling_probe(spec)
        mesh_note = f", mesh d{mesh['devices']}"
    workload = (
        f"open-loop {sched_label} rps seed {load.seed}, "
        f"{'/'.join(load.resolved_kinds())} mix, buckets "
        f"B({','.join(map(str, spec.batch_buckets))})x"
        f"A({','.join(map(str, spec.asset_buckets))})x{spec.months}m "
        f"({spec.dtype}, {service.config.engine} engine{mesh_note})"
    )
    extra = {
        "platform": _platform(service),
        "engine": service.config.engine,
        "workload": workload,
        "capacity": service.config.capacity,
        "max_wait_ms": round(1e3 * service.config.max_wait_s, 3),
        "warm_report": service.warm_report,
        # bounded per-request latency samples (chronological), scope-
        # keyed, so each p99 has its own distribution beside it
        "samples": _latency_samples(load, requests),
    }
    if mesh is not None:
        extra["mesh"] = mesh
    if service.spec.name == "serve-smoke":
        extra["smoke"] = ("smoke-bucket run: pipeline-shaped, workload "
                          "reduced — NOT a performance capture")
    return {
        "kind": "serve",
        "schema_version": SCHEMA_VERSION,
        "run_id": load.run_id,
        "metric": "serve_throughput_rps",
        "value": throughput,
        "unit": "req/s",
        "vs_baseline": 1.0,
        "wall_s": round(wall_s, 4),
        # achieved == offered (no rejection, no expiry) means the run
        # measured the LOAD, not the service's ceiling
        "offered_limited": bool(acct["rejected"] == 0
                                and acct["expired"] == 0),
        "requests": acct,
        "classes": _class_blocks(service, requests),
        "endpoints": _endpoint_blocks(load, requests),
        "cache": service.cache_stats(),
        "latency_ms": lat,
        "batches": service.batch_stats(),
        "compile": {
            "in_window_fresh_compiles": fresh,
            "note": "kernel libraries built or loaded since the engine "
                    "warmed (ops.build): 0 = every dispatch ran what the "
                    "warm-up of every bucket shape built; eager torch "
                    "builds nothing per shape, so this counts less than "
                    "an XLA backend-compile delta",
        },
        "offered": {
            "schedule": load.schedule,
            "schedule_kind": load.schedule_kind,
            "seed": load.seed,
            "n_arrivals": len(requests),
            "duration_s": round(duration, 4),
            "offered_rps": offered_rps,
            "kinds": list(load.resolved_kinds()),
            "deadline_ms": ("class-budget" if load.use_class_deadlines
                            else None if load.deadline_s is None
                            else round(1e3 * load.deadline_s, 3)),
            "class_mix": {name: w for name, w in load.mix()},
            "reuse_fraction": load.reuse_fraction,
            "version_bumps": load.version_bumps,
        },
        "extra": extra,
    }


# ------------------------------------------------------------------ pool ---

def _open_loop_drive(offsets, submit_arrival, concurrent=None,
                     drain_give_up_s: float = 60.0,
                     artifact_label: str = "pool") -> tuple:
    """The open-loop scaffold of a pool or fabric run: run ``concurrent``
    in a side thread, fire ``submit_arrival(i)`` at each schedule offset
    (open loop: the schedule's clock rules, not the service's), wait
    every request terminal within ``drain_give_up_s``, then join the side
    thread with its own budget (a restart can outlast the request drain)
    and refuse to return from a still-mutating fleet rather than let the
    caller land a mid-restart snapshot as evidence.  A ``concurrent``
    exception is raised after the join, never lost.  Returns
    ``(requests, wall_s)``."""
    import threading

    side = None
    side_exc: list = []
    if concurrent is not None:
        def _side():
            try:
                concurrent()
            except BaseException as e:  # surfaced after join, not lost
                side_exc.append(e)

        side = threading.Thread(target=_side, daemon=True)

    requests = []
    t_start = mono_now_s()
    if side is not None:
        side.start()
    for i, off in enumerate(offsets):
        delay = (t_start + off) - mono_now_s()
        if delay > 0:
            time.sleep(delay)  # open loop: the schedule's clock rules
        requests.append(submit_arrival(i))
    give_up = mono_now_s() + drain_give_up_s
    for r in requests:
        r.wait(timeout=max(0.0, give_up - mono_now_s()))
    wall_s = mono_now_s() - t_start
    if side is not None:
        side.join(timeout=300.0)
        if side.is_alive():
            raise RuntimeError(
                f"concurrent action still running after 300s — refusing "
                f"to build the {artifact_label} artifact from an "
                "unsettled fleet")
        if side_exc:
            raise side_exc[0]
    return requests, wall_s


def run_pool_loadgen(router, supervisor, load: LoadConfig,
                     concurrent=None) -> dict:
    """Drive the multi-process pool with the SAME seeded open-loop
    schedule as :func:`run_loadgen`, through the router.

    The pool is NOT stopped here (the caller may still want to kill /
    roll / inspect workers); the books close once every admitted request
    reaches a terminal state — which the router guarantees per request,
    so waiting on the handles IS the drain.

    ``concurrent`` (optional callable) runs in a thread alongside the
    load stream — the chaos lever for "do X UNDER load" scenarios
    (rolling restart, a mid-run kill).  The artifact is built only after
    BOTH the load's requests are terminal AND ``concurrent`` returned,
    so worker stats and fleet events are read from a settled pool.  An
    armed fleet observatory's demand book opens as the load starts, so
    it counts exactly this run's arrivals (self-probes before it stay
    out) and reconciles with the request book."""
    rng = random.Random(load.seed)
    segments = parse_schedule(load.schedule)
    offsets = arrival_offsets(segments, rng)
    spec = router.spec
    max_assets = min(load.max_assets or spec.max_assets, spec.max_assets)
    mix = load.mix()
    kinds = list(load.resolved_kinds())  # hoisted out of the timed loop

    def submit_arrival(_i):
        kind = rng.choice(kinds)
        n_assets = rng.randint(2, max_assets)
        values, mask = synth_panel(rng, n_assets, spec.months, kind)
        return router.submit(kind, values, mask,
                             priority=_pick_class(mix, rng),
                             deadline_s=load.deadline_s)

    obs_fleet.open_demand_window()
    requests, wall_s = _open_loop_drive(offsets, submit_arrival, concurrent)
    return build_pool_artifact(router, supervisor, load, requests, wall_s)


def _pool_fresh_compiles(workers: list):
    """Aggregate in-window fresh compiles across the fleet: the SUM of
    every live worker's count.  A worker that cannot report (dead slot,
    stats error) degrades the total to a reason string — "unknown" must
    never be spelled 0."""
    total = 0
    gaps = []
    for w in workers:
        if w.get("state") != "ready":
            # a replaced slot's history lives in the replacement; a dead/
            # failed slot has no count to contribute — named, not zeroed
            gaps.append(f"{w['worker_id']}: {w.get('state')}")
            continue
        fc = w.get("fresh_compiles")
        if isinstance(fc, int) and not isinstance(fc, bool):
            total += fc
        else:
            gaps.append(f"{w['worker_id']}: {fc!r}")
    if gaps:
        return (f"{total} across reporting workers; not measurable for "
                f"[{'; '.join(gaps)}]")
    return total


def build_pool_artifact(router, supervisor, load: LoadConfig,
                        requests: list, wall_s: float) -> dict:
    """The SERVE_POOL artifact: the router's closed cross-process books,
    hedging/availability headline, and the fleet's evidence."""
    acct = router.accounting()
    served = [r for r in requests if r.state == "served"]
    throughput = round(acct["served"] / wall_s, 3) if wall_s > 0 else 0.0
    segments = parse_schedule(load.schedule)
    duration = schedule_duration_s(segments)
    offered_rps = round(len(requests) / duration, 3) if duration else 0.0
    lat = {"total": _percentiles(
        [r.total_s for r in served if r.total_s is not None])}
    workers = supervisor.worker_stats()
    summary = supervisor.summary()
    fresh = _pool_fresh_compiles(workers)
    spec = router.spec
    cfg = supervisor.config
    ready = [w for w in workers if w.get("state") == "ready"]
    platform = None
    for h in supervisor.handles:
        rep = h.ready_report or {}
        if isinstance(rep.get("platform"), str):
            platform = rep["platform"]
            break
    # a mesh pool's workload string carries its topology: the devices a
    # worker when pinned, else the named slices (none: unpinned)
    mesh_note = ""
    if cfg.engine in ("torch-mesh", "jax-mesh"):
        if cfg.devices_per_worker > 0:
            mesh_note = f", {cfg.devices_per_worker} dev/worker"
        else:
            slices = sorted({h.device_slice for h in supervisor.handles
                             if h.device_slice})
            mesh_note = (f", slices {'/'.join(slices)}" if slices
                         else ", unpinned mesh")
    workload = (
        f"pool open-loop {load.schedule} rps seed {load.seed}, "
        f"{'/'.join(load.resolved_kinds())} mix, {cfg.n_workers} workers, buckets "
        f"B({','.join(map(str, spec.batch_buckets))})x"
        f"A({','.join(map(str, spec.asset_buckets))})x{spec.months}m "
        f"({spec.dtype}, {cfg.engine} engine{mesh_note})"
    )
    extra = {
        "platform": platform,
        "engine": cfg.engine,
        "workload": workload,
        "hedge_policy": {
            "fraction": router.config.hedge_fraction,
            "floor_ms": round(1e3 * router.config.hedge_floor_s, 3),
            "max_attempts": router.config.max_attempts,
        },
        "cache_version": summary["expect_cache_version"],
        # same CI backing as the single-process artifact: bounded
        # per-request total-latency samples for the pool p99 rows
        "samples": {"serve_pool_total_ms": _bounded_samples(
            [1e3 * r.total_s for r in served if r.total_s is not None],
            SAMPLE_CAP, load.seed)},
    }
    if spec.name == "serve-smoke":
        extra["smoke"] = ("smoke-bucket pool run: pipeline-shaped, "
                          "workload reduced — NOT a performance capture")
    # the observatory's provenance: an armed fleet observatory (demand
    # hooks, every process's emitter) shares the run's CPU, so its
    # latency rows say whether it was on
    extra["observatory_armed"] = obs_fleet.armed()
    admitted = max(1, acct["admitted"])
    return {
        "kind": "serve_pool",
        "schema_version": POOL_SCHEMA_VERSION,
        "run_id": load.run_id,
        "metric": "serve_pool_throughput_rps",
        "value": throughput,
        "unit": "req/s",
        "vs_baseline": 1.0,
        "wall_s": round(wall_s, 4),
        # same honesty flag as the single-process artifact: a run the
        # pool fully kept up with measured the LOAD, not the ceiling
        "offered_limited": bool(acct["rejected"] == 0
                                and acct["expired"] == 0),
        "requests": acct,
        "availability": router.availability(),
        "hedge": {
            "hedged": acct["hedged"],
            "rate": round(acct["hedged"] / admitted, 4),
            "wins": acct["hedge_wins"],
            "suppressed": acct["duplicates_suppressed"],
        },
        "latency_ms": lat,
        "pool": {
            "n_workers": cfg.n_workers,
            "ready_workers_end": len(ready),
            "kills": summary["kills"],
            "restarts": summary["restarts"],
            "rolls_completed": summary["rolls_completed"],
            "events": summary["events"][:200],
        },
        "workers": workers,
        "compile": {
            "in_window_fresh_compiles": fresh,
            "note": "sum of per-worker kernel libraries built or loaded "
                    "since each worker's own warm-up (ops.build): 0 = no "
                    "worker built or loaded a kernel inside the serving "
                    "window (warm-before-ready held across spawns, "
                    "restarts and rolls)",
        },
        "offered": {
            "schedule": load.schedule,
            "schedule_kind": load.schedule_kind,
            "seed": load.seed,
            "n_arrivals": len(requests),
            "duration_s": round(duration, 4),
            "offered_rps": offered_rps,
            "kinds": list(load.resolved_kinds()),
            "deadline_ms": (None if load.deadline_s is None
                            else round(1e3 * load.deadline_s, 3)),
            "class_mix": {name: w for name, w in load.mix()},
        },
        "extra": extra,
    }


# ---------------------------------------------------------------- fabric ---

def run_fabric_loadgen(client, router_sup, worker_sup, load: LoadConfig,
                       concurrent=None) -> dict:
    """Drive the three-tier fabric (load generator → router replicas →
    workers) with the seeded open-loop schedule, through a
    :class:`~csmom_tpu_torch.serve.fabric.FabricClient`.

    The same stream as the reference's for a ``(schedule, seed)``, plus
    the pool-level cache shape: ``reuse_fraction`` repeats recent panels
    per endpoint, so consistent-hash routing has identical requests to
    land on one worker's cache.  ``concurrent`` runs beside the stream
    (a router and a worker SIGKILLed mid-burst), and the books close only
    after every request is terminal and it returned."""
    from csmom_tpu_torch.serve.buckets import bucket_spec

    rng = random.Random(load.seed)
    segments = parse_schedule(load.schedule)
    offsets = arrival_offsets(segments, rng)
    spec = bucket_spec(worker_sup.config.profile)
    max_assets = min(load.max_assets or spec.max_assets, spec.max_assets)
    mix = load.mix()
    kinds = list(load.resolved_kinds())
    recent: dict = {k: [] for k in kinds}

    state = {"epoch": 1 if load.version_bumps > 0 else None}
    bump_at = sorted(
        max(1, round(len(offsets) * (k + 1) / (load.version_bumps + 1)))
        for k in range(load.version_bumps)
    ) if load.version_bumps > 0 else []

    def submit_arrival(i):
        if bump_at and i == bump_at[0]:
            bump_at.pop(0)
            state["epoch"] += 1
            # the version rides the wire to the workers; an old-epoch
            # cache entry can only be refused (stale_hits == 0)
            for pool in recent.values():
                pool.clear()
        kind = rng.choice(kinds)
        pool = recent[kind]
        if pool and rng.random() < load.reuse_fraction:
            values, mask = pool[rng.randrange(len(pool))]
        else:
            n_assets = rng.randint(2, max_assets)
            values, mask = synth_panel(rng, n_assets, spec.months, kind)
            pool.append((values, mask))
            del pool[:-8]  # a small window of reusable recents per kind
        return client.submit(
            kind, values, mask, priority=_pick_class(mix, rng),
            deadline_s=load.deadline_s, panel_version=state["epoch"])

    obs_fleet.open_demand_window()
    # 90 s of drain (the pool's 60 and more): a double kill can park a
    # request behind two tiers' respawns before it settles
    requests, wall_s = _open_loop_drive(offsets, submit_arrival,
                                        concurrent, 90.0, "fabric")
    return build_fabric_artifact(client, router_sup, worker_sup, load,
                                 requests, wall_s)


def _fleet_block(sup, stats: list) -> dict:
    """One tier's fleet evidence (router or worker supervisor)."""
    summary = sup.summary()
    return {
        "n_slots": sup.config.n_workers,
        "ready_end": sum(1 for s in stats if s.get("state") == "ready"),
        "kills": summary["kills"],
        "restarts": summary["restarts"],
        "rolls_completed": summary["rolls_completed"],
        "events": summary["events"][:200],
    }


def _worker_cache_aggregate(worker_stats: list) -> dict:
    """The fleet-wide worker cache book: sums over every reporting
    worker, with the slots that cannot report named (a dead worker's
    book died with it; the client's ``served_cache_hits`` survives)."""
    agg = {k: 0 for k in ("hits", "misses", "lookups", "stale_hits",
                          "stale_blocked", "stale_put_refused",
                          "inserts", "evictions", "invalidated")}
    lost = []
    reporting = 0
    for w in worker_stats:
        cache = w.get("cache")
        if not isinstance(cache, dict):
            lost.append(f"{w.get('worker_id')}: {w.get('state')}")
            continue
        reporting += 1
        for k in agg:
            v = cache.get(k)
            if isinstance(v, int) and not isinstance(v, bool):
                agg[k] += v
    agg["reporting"] = reporting
    agg["lost"] = lost
    return agg


def build_fabric_artifact(client, router_sup, worker_sup,
                          load: LoadConfig, requests: list,
                          wall_s: float) -> dict:
    """The SERVE_FABRIC artifact: the client tier's closed books (the
    outermost ledger, the one a SIGKILLed replica cannot take with it),
    per-replica router books, the worker fleet, and the pool-level cache
    hit rate the consistent-hash routing exists to produce."""
    from csmom_tpu_torch.serve.buckets import bucket_spec

    acct = client.accounting()
    served = [r for r in requests if r.state == "served"]
    throughput = round(acct["served"] / wall_s, 3) if wall_s > 0 else 0.0
    segments = parse_schedule(load.schedule)
    duration = schedule_duration_s(segments)
    offered_rps = round(len(requests) / duration, 3) if duration else 0.0
    router_stats = router_sup.router_stats()
    worker_stats = worker_sup.worker_stats()
    fresh = _pool_fresh_compiles(worker_stats)
    cache_agg = _worker_cache_aggregate(worker_stats)
    pool_hit_rate = (round(acct["served_cache_hits"] / acct["served"], 4)
                     if acct["served"] else 0.0)

    # router-tier hedge sums over the replicas still standing; a dead
    # replica's books are reported lost, and the hedged served count the
    # client observed is the number that cannot die with a replica
    r_hedged = r_wins = r_suppressed = 0
    r_lost = []
    for r in router_stats:
        a = r.get("accounting")
        if isinstance(a, dict):
            r_hedged += a.get("hedged", 0)
            r_wins += a.get("hedge_wins", 0)
            r_suppressed += a.get("duplicates_suppressed", 0)
        else:
            r_lost.append(f"{r.get('router_id')}: {r.get('state')}")
    admitted = max(1, acct["admitted"])

    platform = None
    for h in worker_sup.handles:
        rep = h.ready_report or {}
        if isinstance(rep.get("platform"), str):
            platform = rep["platform"]
            break
    wcfg = worker_sup.config
    spec = bucket_spec(wcfg.profile)
    scheme = "tcp" if wcfg.transport == "tcp" else "unix"
    workload = (
        f"fabric open-loop {load.schedule} rps seed {load.seed}, "
        f"{'/'.join(load.resolved_kinds())} mix, "
        f"{router_sup.config.n_workers} routers x {wcfg.n_workers} "
        f"workers over {scheme}, buckets "
        f"B({','.join(map(str, spec.batch_buckets))})x"
        f"A({','.join(map(str, spec.asset_buckets))})x{spec.months}m "
        f"({spec.dtype}, {wcfg.engine} engine)"
    )
    extra = {
        "platform": platform,
        "engine": wcfg.engine,
        "workload": workload,
        "cache_version": worker_sup.expect_cache_version,
        # the client tier's channel books: reuses >> dials; each
        # replica's own ride in its router stats ("channels")
        "client_channels": client.channels.stats(),
        "samples": {"serve_fabric_total_ms": _bounded_samples(
            [1e3 * r.total_s for r in served if r.total_s is not None],
            SAMPLE_CAP, load.seed)},
    }
    if spec.name == "serve-smoke":
        extra["smoke"] = ("smoke-bucket fabric run: pipeline-shaped, "
                          "workload reduced — NOT a performance capture")
    # the observatory's provenance: an armed fleet observatory (demand
    # hooks, every process's emitter) shares the run's CPU, so its
    # latency rows say whether it was on
    extra["observatory_armed"] = obs_fleet.armed()
    return {
        "kind": "serve_fabric",
        "schema_version": FABRIC_SCHEMA_VERSION,
        "run_id": load.run_id,
        "metric": "serve_fabric_throughput_rps",
        "value": throughput,
        "unit": "req/s",
        "vs_baseline": 1.0,
        "wall_s": round(wall_s, 4),
        "offered_limited": bool(acct["rejected"] == 0
                                and acct["expired"] == 0),
        "transport": {
            "scheme": scheme,
            "routers": router_sup.config.n_workers,
            "workers": wcfg.n_workers,
        },
        "requests": acct,
        "availability": client.availability(),
        "cache": {
            # the hit rate at pool level, counted at the client (a dead
            # worker cannot take it along), beside the per-worker baseline
            "pool_hit_rate": pool_hit_rate,
            "served_cache_hits": acct["served_cache_hits"],
            "served": acct["served"],
            "per_worker_baseline": R15_PER_WORKER_HIT_RATE,
            "workers": cache_agg,
        },
        "hedge": {
            "served_hedged": acct["served_hedged"],
            "rate": round(acct["served_hedged"] / admitted, 4),
            "router_tier": {
                "hedged": r_hedged,
                "wins": r_wins,
                "suppressed": r_suppressed,
                "books_lost": r_lost,
            },
        },
        "latency_ms": {"total": _percentiles(
            [r.total_s for r in served if r.total_s is not None])},
        "routers": {
            "replicas": router_stats,
            **_fleet_block(router_sup, router_stats),
        },
        "workers": {
            "stats": worker_stats,
            **_fleet_block(worker_sup, worker_stats),
        },
        "compile": {
            "in_window_fresh_compiles": fresh,
            "note": "sum of per-worker kernel libraries built or loaded "
                    "since each worker's own warm-up (ops.build): 0 = no "
                    "worker built or loaded a kernel inside the serving "
                    "window (router replicas hold no kernel at all)",
        },
        "offered": {
            "schedule": load.schedule,
            "schedule_kind": load.schedule_kind,
            "seed": load.seed,
            "n_arrivals": len(requests),
            "duration_s": round(duration, 4),
            "offered_rps": offered_rps,
            "kinds": list(load.resolved_kinds()),
            "deadline_ms": (None if load.deadline_s is None
                            else round(1e3 * load.deadline_s, 3)),
            "class_mix": {name: w for name, w in load.mix()},
            "reuse_fraction": load.reuse_fraction,
            "version_bumps": load.version_bumps,
        },
        "extra": extra,
    }


def write_artifact(out_dir: str, obj: dict, prefix: str = "GPU_SERVE") -> str:
    """Atomically land ``<prefix>_<run>.json``; returns the path.  The
    prefix is the port's own: ``SERVE_*`` names are the reference's
    artifacts."""
    name = f"{prefix}_{obj['run_id']}.json"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path
