"""``rehearse``: prove the capture pipeline and the serving tiers
survive their fault matrix.

Counterpart of ``csmom_tpu.cli.rehearse``; it prints what ``csmom
rehearse`` prints.  Each scenario arms a deterministic fault plan
(:mod:`csmom_tpu_torch.chaos.plan`), drives one pipeline inside a sandbox
directory, and holds what lands to the pipeline's invariants
(:mod:`csmom_tpu_torch.chaos.invariants`); the run prints a pass/fail
table and exits 1 on any violation, 0 when every scenario is green.

Nine pipelines, the reference's 29 scenarios, in its order:

- ``mini`` (5) and ``shell`` (1): :mod:`csmom_tpu_torch.chaos.minibench`
  landed through the package's ``chaos/capture_lib.sh``, and that
  library's short-write refusal: the capture plumbing in under a second
  a fault, no torch;
- ``serve`` (4): the signal service in this process on the stub engine;
- ``serve-pool`` (7): stub-engine worker processes behind the real
  supervisor and router (worker kills, tracing, the fleet observatory,
  a hot spare, a rolling restart, cache-version skew);
- ``serve-fabric`` (3): router replicas as processes in front of a
  stub-engine pool, chaos armed in the router tier through
  ``PoolSupervisor.extra_env`` (a partition, stragglers, a double kill);
- ``replay`` (2): the event-time replay on the stub engine;
- ``bench-child`` (3) and ``bench`` (3): :mod:`csmom_tpu_torch.bench`'s
  measuring child and its supervisor in smoke mode
  (``CSMOM_BENCH_SMOKE=1``: the whole pipeline's shape, a reduced
  workload) on ``--device``;
- ``warmup`` (1, ``corrupt-aot-cache``): two warm-up processes of
  profile ``smoke`` and of the smoke grid's shape through K2 (the
  profile warms the grid on its plain path only), with
  ``CSMOM_JIT_CACHE`` pointed into the sandbox; the first builds both
  kernel libraries there, the second corrupts every file of it before
  its first entry and must heal (evict, rebuild, launch K1 and K2 from
  the rebuilt libraries).

``--fast`` runs the 16 scenarios marked fast (mini, shell, serve,
serve-pool and replay).  ``--only`` may be given more than once; a
value that is a scenario's whole name selects that scenario alone.

``--device {cuda,cpu}`` (default cuda) is the device of the bench and
warm-up scenarios, the only ones that touch a device.  Without a card a
matrix that holds one exits 2 before any scenario runs, naming
``--device cpu``; a matrix of stub and capture-plumbing scenarios needs
no card.  With ``--device cpu`` the warm-up runs the plain versions and
builds nothing, so no library is there to corrupt, and the row says so.

The run is itself a telemetry run: each scenario is a ``rehearse.row``
span, and the sidecar ``GPU_TELEMETRY_rehearse[_fast|_custom].json``
lands in ``.csmom_scratch/`` (``timeline <run>`` renders it).  The
port's lint sweep gates the start: a finding refuses the rehearsal.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.chaos.plan import PLAN_ENV, Fault, FaultPlan

__all__ = ["Scenario", "builtin_matrix", "cmd_rehearse", "register",
           "warmup_pass"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the package's own copy of the landing rules (never the reference's)
_CAPTURE_LIB = os.path.join(os.path.dirname(os.path.abspath(inv.__file__)),
                            "capture_lib.sh")

# the pipelines whose scenarios run on --device
_DEVICE_PIPELINES = ("bench-child", "bench", "warmup")


# ------------------------------------------------------------ scenarios ----

class Scenario:
    """One rehearsal: a fault plan, a pipeline to drive, and the checks
    the landed evidence must pass."""

    def __init__(self, name, pipeline, plan, check, fast=False, notes="",
                 env=None, rows=6, budget_s=None):
        self.name = name
        self.pipeline = pipeline  # mini | shell | serve | ... | bench
        self.plan = plan
        self.check = check        # fn(result dict) -> list of violations
        self.fast = fast
        self.notes = notes
        self.env = env or {}
        self.rows = rows
        self.budget_s = budget_s


def _rows_of(obj) -> int:
    return inv.measured_rows(obj or {})


def _plan_summary(plan) -> str:
    """One-line digest of a scenario's armed fault plan for ``--list``:
    ``seed N: point:action[@after][xfires][!]`` per fault (``!`` marks
    global-once), or the runner-driven note when no plan arms."""
    if plan is None:
        return "none (runner-driven faults / env contract)"
    parts = []
    for f in plan.faults:
        p = f"{f.point}:{f.action}"
        if f.after:
            p += f"@{f.after}"
        if f.max_fires != 1:
            p += f"x{f.max_fires or 'inf'}"
        if f.global_once:
            p += "!"
        parts.append(p)
    return f"seed {plan.seed}: " + ", ".join(parts)


def _check_partial_no_lost_rows(r):
    """A deadline-hit run must land a partial carrying every measured row."""
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["no trailing JSON line — measurements lost"]
    if not inv.is_partial(obj):
        out.append("expected an explicitly-partial record")
    if r["sidecar_rows"] and _rows_of(obj) != r["sidecar_rows"]:
        out.append(
            f"lost measured rows: sidecar has {r['sidecar_rows']}, landed "
            f"artifact has {_rows_of(obj)}"
        )
    if r.get("artifact") is not None:
        out += [f"artifact: {v}" for v in inv.validate(r["artifact"])]
        if _rows_of(r["artifact"]) != r["sidecar_rows"]:
            out.append("landed artifact dropped measured rows")
    elif r["sidecar_rows"]:
        out.append("partial line printed but no artifact landed")
    if r["rc"] != 0:
        out.append(f"deadline dump must exit 0, got rc={r['rc']}")
    return out


def _check_full_all_rows(r):
    """An unfaulted-outcome run: full record, all rows, schema-valid."""
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["no trailing JSON line"]
    if inv.is_partial(obj):
        out.append("expected a FULL record, got a partial")
    if r["sidecar_rows"] and _rows_of(obj) != r["sidecar_rows"]:
        out.append(
            f"row count mismatch: sidecar {r['sidecar_rows']} vs landed "
            f"{_rows_of(obj)}"
        )
    if r.get("artifact") is not None:
        out += [f"artifact: {v}" for v in inv.validate(r["artifact"])]
    if r["rc"] != 0:
        out.append(f"rc={r['rc']}")
    return out


def _check_killed_nothing_fabricated(r):
    """A SIGKILLed process prints nothing; the landing layer must not
    fabricate an artifact from the corpse (and must keep any prior one)."""
    out = []
    if r["rc"] >= 0:
        out.append(f"expected SIGKILL (negative rc), got rc={r['rc']}")
    if r["trailing"] is not None:
        out.append("a SIGKILLed process somehow printed a summary line")
    if r.get("artifact") is not None:
        out.append("landing fabricated an artifact from a dead process")
    return out


def _mini_scenarios():
    sleep_long = 600.0
    return [
        Scenario(
            "expire-deadline-between-rows", "mini",
            FaultPlan("expire-deadline-between-rows", seed=1, faults=(
                Fault(point="mini.row", action="trip_deadline", after=3),
            )),
            _check_partial_no_lost_rows, fast=True,
            notes="deadline expires between measured rows -> partial dump "
                  "carries every measured row (fast form)",
        ),
        Scenario(
            "hang-mid-row", "mini",
            FaultPlan("hang-mid-row", seed=2, faults=(
                Fault(point="mini.row", action="sleep", after=2,
                      seconds=sleep_long),
            )),
            _check_partial_no_lost_rows,
            notes="a hang mid-row -> the watchdog beats the stall and "
                  "dumps the measured rows",
            env={"CSMOM_MINIBENCH_BUDGET": "2",
                 "CSMOM_MINIBENCH_MIN_DELAY": "1"},
            budget_s=None,
        ),
        Scenario(
            "stdout-interleave", "mini",
            FaultPlan("stdout-interleave", seed=3, faults=(
                Fault(point="mini.finish", action="stdout_noise",
                      seconds=1.0),
            )),
            _check_full_all_rows, fast=True,
            notes="concurrent stdout writer racing the trailing JSON -> "
                  "the quarantined single-write emit keeps it parseable",
        ),
        Scenario(
            "clock-skew", "mini",
            FaultPlan("clock-skew", seed=4, faults=(
                Fault(point="mini.start", action="clock_skew",
                      seconds=3600.0),
            )),
            _check_full_all_rows,
            notes="wall clock jumps +1h mid-capture -> monotonic-anchored "
                  "deadline keeps its true fuse, run completes in full",
            env={"CSMOM_MINIBENCH_BUDGET": "30"},
        ),
        Scenario(
            "sigkill-mid-row", "mini",
            FaultPlan("sigkill-mid-row", seed=5, faults=(
                Fault(point="mini.row", action="kill", after=2),
            )),
            _check_killed_nothing_fabricated,
            notes="SIGKILL between rows: unpreventable loss, but the "
                  "landing layer must not fabricate or clobber artifacts",
        ),
    ]


def _check_short_write(r):
    out = []
    if r.get("artifact") is not None:
        out.append("a truncated (ENOSPC) write LANDED as the artifact")
    if not r.get("prior_intact", True):
        out.append("the faulted landing damaged the pre-existing artifact")
    if r.get("retry_artifact") is None:
        out.append("the fault-free retry failed to land the artifact")
    else:
        out += [f"retry artifact: {v}"
                for v in inv.validate(r["retry_artifact"])]
    return out


def _shell_scenarios():
    return [
        Scenario(
            "land-short-write", "shell", None, _check_short_write, fast=True,
            notes="ENOSPC/short write between formatter and rename -> "
                  "post-write JSON validation refuses to land garbage; "
                  "the fault-free retry lands cleanly",
        ),
    ]


def _check_serve_worker_crash(r):
    """A worker crash mid-batch must terminate its batch as
    rejected-with-reason (never a silent drop), leave the remaining
    queue drainable, and keep the accounting equation closed — the
    validator enforces served + rejected + expired == admitted."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve")
    req = art.get("requests") or {}
    if not req.get("rejected_worker_crash"):
        out.append("the injected crash terminated no requests as "
                   "rejected — the fault did not fire or the loss was "
                   "hidden")
    if not req.get("served"):
        out.append("no request served after the crash — the queue did "
                   "not stay drainable")
    if (art.get("batches") or {}).get("count", 0) < 2:
        out.append("fewer than 2 batches dispatched — nothing ran after "
                   "the crashed batch")
    return out


def _check_serve_deadline_storm(r):
    """Overload + tight deadlines: requests must expire WHILE QUEUED and
    never be dispatched (expired_dispatched == 0 is a validator rule),
    with the books still balanced on the drained queue."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve")
    req = art.get("requests") or {}
    if not req.get("expired"):
        out.append("the deadline storm expired no requests — the storm "
                   "did not overload the queue (tune the plan)")
    return out


def _check_serve_burst_storm(r):
    """A bulk-heavy burst storm against the SLO classes — the
    bulk quota must actually enforce (rejected_quota > 0 in bulk's own
    book), every interactive request must be SERVED (none rejected or
    expired behind the flood), interactive must never queue behind bulk
    (its p99 bounded by bulk's — the rank-order claim), and the
    per-class books must close (schema rules of serve v2).

    The starvation evidence is deliberately scheduling-invariant: an
    absolute wall-clock p99 bound flakes when the REHEARSAL machine is
    contended (the whole run slows uniformly), but quota rejections and
    the interactive-never-behind-bulk ordering hold at any machine
    speed.  An absolute per-class budget is a dedicated capture's claim,
    not a shared rehearsal's."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve")
    classes = art.get("classes") or {}
    bulk = classes.get("bulk") or {}
    inter = classes.get("interactive") or {}
    if not bulk.get("rejected_quota"):
        out.append("bulk.rejected_quota == 0 — the burst never hit the "
                   "quota; the storm rehearsed nothing (tune the "
                   "schedule or the quota)")
    if not inter.get("served"):
        out.append("no interactive request served under the bulk storm")
    elif inter.get("served") != inter.get("admitted"):
        out.append(
            f"interactive served {inter.get('served')} of "
            f"{inter.get('admitted')} admitted — the bulk storm cost "
            "interactive requests (rejected/expired), which is exactly "
            "the starvation the SLO classes exist to prevent")
    ip99 = (inter.get("latency_ms") or {}).get("p99")
    bp99 = (bulk.get("latency_ms") or {}).get("p99")
    if (isinstance(ip99, (int, float)) and isinstance(bp99, (int, float))
            and inter.get("within_budget") is not True
            and ip99 > bp99 + 100.0):
        out.append(
            f"interactive p99 {ip99} ms exceeds bulk's served p99 "
            f"{bp99} ms (and its own budget) — interactive queued "
            "BEHIND bulk, rank-ordered collection did not hold")
    return out


def _check_serve_cache_poison(r):
    """The chaos ``cache_poison`` action plants entries under
    live keys stamped below the version floor — the get path must refuse
    every one (``stale_blocked`` > 0, ``stale_hits`` == 0 BY SCHEMA),
    genuine repeats must still hit, and the books must close."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve")
    cache = art.get("cache") or {}
    if not cache.get("hits"):
        out.append("cache.hits == 0 — the reuse stream produced no "
                   "genuine hits; the scenario rehearsed nothing")
    if not cache.get("stale_blocked"):
        out.append("cache.stale_blocked == 0 — the poison fault never "
                   "fired (or its entry was silently served)")
    # stale_hits != 0 is already a schema violation; restate it pointedly
    if cache.get("stale_hits"):
        out.append(f"cache.stale_hits = {cache['stale_hits']} — a "
                   "POISONED result reached a caller")
    return out


def _burst_policy():
    """The burst-storm SLO policy: default shape, but a bulk quota small
    enough that the rehearse burst provably exceeds it even when a
    contended machine stretches the run (token refill is time-based, so
    a slower run earns MORE tokens — the margin must survive that)."""
    from csmom_tpu_torch.serve.slo import SLOClass, SLOPolicy

    return SLOPolicy((
        SLOClass("interactive", rank=0, deadline_s=0.5),
        SLOClass("standard", rank=1, deadline_s=1.0, queue_share=0.75),
        SLOClass("bulk", rank=2, deadline_s=3.0,
                 quota_rps=15.0, quota_burst=5.0, queue_share=0.5),
    ))


def _serve_scenarios():
    return [
        Scenario(
            "serve-worker-kill-mid-batch", "serve",
            FaultPlan("serve-worker-kill", seed=20, faults=(
                Fault(point="serve.dispatch", action="fail", after=1,
                      max_fires=1),
            )),
            _check_serve_worker_crash, fast=True,
            notes="worker crash mid-batch (chaos fail at serve.dispatch):"
                  " the batch terminates rejected-with-reason, the queue "
                  "drains on, served+rejected+expired == admitted",
            env={"load": {"schedule": "0.5x80", "seed": 11,
                          "deadline_s": 2.0}},
        ),
        Scenario(
            "serve-deadline-storm", "serve",
            FaultPlan("serve-deadline-storm", seed=21, faults=(
                Fault(point="serve.dispatch", action="sleep",
                      seconds=0.12, after=0, max_fires=3),
            )),
            _check_serve_deadline_storm, fast=True,
            notes="slow dispatches pile the queue past tight deadlines: "
                  "requests expire WHILE QUEUED (never dispatched), "
                  "backpressure rejects at the bound, books balance",
            env={"load": {"schedule": "0.4x150", "seed": 12,
                          "deadline_s": 0.08},
                 "serve": {"capacity": 24}},
        ),
        Scenario(
            "serve-burst-storm", "serve", None,
            _check_serve_burst_storm, fast=True,
            notes="bulk-heavy burst storm against the SLO classes: the "
                  "bulk token bucket rejects over-quota admissions, "
                  "every interactive request is served and never queues "
                  "behind bulk, and the per-class books close BY SCHEMA "
                  "(serve v2)",
            env={"load": {"schedule": "0.2x30,0.15x280,0.2x30,0.15x300",
                          "seed": 22,
                          "class_mix": (("interactive", 0.4),
                                        ("bulk", 0.6)),
                          # generous explicit deadlines: a contended
                          # rehearse machine must not expire requests
                          # the scheduling property would have served
                          "deadline_s": 10.0,
                          "schedule_kind": "bursty"},
                 "serve": {"policy": _burst_policy(), "capacity": 256}},
        ),
        Scenario(
            "serve-cache-poison", "serve",
            FaultPlan("serve-cache-poison", seed=23, faults=(
                Fault(point="serve.cache", action="cache_poison",
                      after=3, max_fires=4),
            )),
            _check_serve_cache_poison, fast=True,
            notes="chaos plants stale-version entries under live cache "
                  "keys: the get-path version floor refuses every one "
                  "(stale_blocked > 0, stale_hits == 0 by schema) while "
                  "genuine repeats keep hitting and books stay closed",
            env={"load": {"schedule": "0.5x120", "seed": 24,
                          "reuse_fraction": 0.6, "version_bumps": 1,
                          "deadline_s": 2.0}},
        ),
    ]



def _check_pool_worker_kill(r):
    """A worker-PROCESS death mid-batch (chaos ``kill`` at
    serve.dispatch, fired inside one worker of the fleet) must lose no
    request: the router's books stay closed across the process boundary,
    conn-failed dispatches fail over, the pool keeps serving, and
    availability stays >= 99%."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    req = art.get("requests") or {}
    pool = art.get("pool") or {}
    if not pool.get("kills"):
        out.append("no worker death observed — the injected process kill "
                   "did not fire (or the supervisor missed it)")
    if not req.get("worker_conn_failures"):
        out.append("no connection failure recorded — the kill missed "
                   "every in-flight dispatch (nothing was rescued)")
    if not req.get("served"):
        out.append("nothing served — the pool did not keep serving past "
                   "the dead worker")
    if (art.get("availability") or 0.0) < 0.99:
        out.append(f"availability {art.get('availability')} < 0.99 after "
                   "a single worker kill — hedged retries did not route "
                   "around the corpse")
    return out


def _check_trace_stitch_worker_kill(r):
    """Cross-process trace stitching under a mid-batch worker
    SIGKILL.  The landed TRACE artifact must be schema-valid (closed
    trace books, stage sums reconciling within epsilon, orphan reasons
    summing to the orphan count), the killed worker's unstitchable
    dispatches must appear as reason-closed ORPHAN halves, and the
    surviving complete traces must carry BOTH halves of the stitch
    (router-side transport + worker-side queue_wait/dispatch stages)."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    tart = r.get("trace_artifact") or {}
    out += [f"trace: {v}" for v in inv.validate(tart, "trace")]
    out += list(r.get("trace_book_violations") or [])
    orphans = tart.get("orphans") or {}
    if not orphans.get("count"):
        out.append("no orphan half closed — the SIGKILLed worker's "
                   "in-flight dispatch left no reason-closed orphan "
                   "(the kill missed, or the orphan leaked)")
    elif not any("connection" in reason or "closed" in reason
                 for reason in (orphans.get("reasons") or {})):
        out.append(f"orphan reasons {list(orphans.get('reasons') or {})} "
                   "never name the connection failure — the reason was "
                   "lost in the close")
    stages = tart.get("stages") or {}
    for want in ("transport", "queue_wait", "dispatch"):
        if want not in stages:
            out.append(f"no {want!r} stage in the stitched decomposition "
                       "— the worker half (or the router half) was "
                       "never stitched in")
    books = tart.get("books") or {}
    if not books.get("complete"):
        out.append("no complete trace — failover served nothing the "
                   "trace layer could stitch")
    return out


def _check_fleet_capture_worker_kill(r):
    """Continuous fleet capture across a mid-batch worker
    SIGKILL.  The landed FLEET artifact must be schema-valid (every
    process stream reason-closed, counter series monotone, demand
    reconciling with the request books), the victim's stream must read
    as a SEVERED series gap — never silent truncation — its
    replacement's spawn→ready wall must land as a lifecycle sample
    beyond the initial fleet's, and the kill-window capacity account
    must show a loss the steady state does not."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    fart = r.get("fleet_artifact") or {}
    out += [f"fleet: {v}" for v in inv.validate(fart, "fleet")]
    series = fart.get("series") or {}
    procs = series.get("processes") or {}
    severed = [p for p, b in procs.items()
               if "severed" in str(b.get("close_reason", ""))]
    if not severed:
        out.append("no severed stream book — the SIGKILLed worker's "
                   "emitter died without its gap being reason-closed "
                   "(silent truncation, the one outcome the observatory "
                   "exists to forbid)")
    n_workers = ((art.get("pool") or {}).get("n_workers")
                 or (fart.get("capacity") or {}).get("n_slots") or 0)
    walls = (fart.get("lifecycle") or {}).get("ready_walls_s") or []
    if len(walls) <= n_workers:
        out.append(f"{len(walls)} ready-wall sample(s) for "
                   f"{n_workers} worker slot(s) — the replacement's "
                   "(re)spawn→ready wall never landed in the lifecycle "
                   "book")
    cap = fart.get("capacity") or {}
    if not cap.get("kill_windows"):
        out.append("no kill window in the capacity account — the "
                   "injected process kill left no trace in the "
                   "availability timeline")
    if not (cap.get("kill_window_loss_frac") or 0) > 0:
        out.append("kill-window capacity loss fraction is 0 — a dead "
                   "worker slot cost nothing, which no capacity account "
                   "should claim")
    demand = (fart.get("demand") or {}).get("classes") or {}
    if not demand:
        out.append("empty demand book — the client-tier hooks never "
                   "fired while the load ran")
    return out


def _check_spare_promote_on_kill(r):
    """A hot spare is parked OUT of the ring when chaos
    SIGKILLs a worker mid-batch.  The elastic tier must promote the
    spare into the victim's slot (one promotion, ready wall far below a
    re-warm), the spare-credited capacity account must show ~no
    kill-window capacity loss (the reserve covered the hole), the
    spare's ids must never leak into the serving books, and the FLEET
    artifact — elastic block included — must close by schema."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    fart = r.get("fleet_artifact") or {}
    out += [f"fleet: {v}" for v in inv.validate(fart, "fleet")]
    el = fart.get("elastic") or {}
    if not el:
        out.append("no elastic block in the FLEET artifact — the spare "
                   "tier ran unbooked")
    promos = el.get("promotions") or []
    if len(promos) != 1:
        out.append(f"{len(promos)} promotion(s) booked for 1 kill with "
                   "1 spare — the spare was not promoted exactly once")
    for p in promos:
        if (p.get("wall_s") or 0) > 1.5:
            out.append(f"promotion ready wall {p['wall_s']:.3f}s > 1.5s "
                       "— promoting a pre-warmed spare took as long as "
                       "a re-warm, which defeats the reserve")
    if el.get("promotions_missed"):
        out.append(f"{el['promotions_missed']} promotion(s) MISSED — a "
                   "death found no ready spare despite one configured")
    cap = fart.get("capacity") or {}
    loss = cap.get("kill_window_loss_frac")
    if loss is None or loss > 0.10:
        out.append(f"kill-window capacity loss {loss!r} > 0.10 — the "
                   "spare reserve did not cover the kill window (the "
                   "account found a capacity hole the spare exists to "
                   "fill)")
    series = fart.get("series") or {}
    procs = series.get("processes") or {}
    if not any("severed" in str(b.get("close_reason", ""))
               for b in procs.values()):
        out.append("no severed stream book — the victim's emitter died "
                   "without its gap being reason-closed")
    spare_ids = set(el.get("spare_ids") or [])
    booked = {e.get("worker_id")
              for e in ((fart.get("lifecycle") or {}).get("events") or [])}
    for w in (cap.get("kill_windows") or []):
        booked.add(w.get("worker_id"))
    if spare_ids & booked:
        out.append(f"spare id(s) {sorted(spare_ids & booked)} leaked "
                   "into the serving lifecycle/kill-window books — "
                   "spares must stay out of the ring until promoted")
    return out


def _check_pool_rolling_restart(r):
    """A rolling restart under load replaces every worker with
    zero in-window fresh compiles (warm-before-ready via the AOT cache)
    and zero availability loss — the predecessor drains only after its
    replacement demonstrated ready."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    roll = r.get("roll") or {}
    n_workers = (art.get("pool") or {}).get("n_workers", 0)
    if roll.get("aborted"):
        out.append(f"roll aborted: {roll['aborted']}")
    if len(roll.get("rolled") or []) != n_workers:
        out.append(f"rolled {len(roll.get('rolled') or [])} of "
                   f"{n_workers} workers — the roll did not complete")
    fresh = (art.get("compile") or {}).get("in_window_fresh_compiles")
    if fresh != 0:
        out.append(f"in_window_fresh_compiles = {fresh!r} across the "
                   "rolled fleet — a replacement compiled instead of "
                   "loading the AOT cache (warm-before-ready broke)")
    if art.get("availability") != 1.0:
        out.append(f"availability {art.get('availability')} != 1.0 — the "
                   "rolling restart dropped requests")
    if not (art.get("requests") or {}).get("served"):
        out.append("nothing served during the roll")
    return out


def _check_pool_version_skew(r):
    """Cache-version skew between supervisor and worker: the worker must
    REFUSE ready with a pointed message (naming the skew and the remedy,
    the port's kernel build, ``serve.health.BUILD_POINTER``) instead of
    building in the window, and the supervisor must park the slot rather
    than restart-loop a condition a restart cannot fix."""
    from csmom_tpu_torch.serve.health import BUILD_POINTER

    s = r.get("skew") or {}
    out = []
    if s.get("started"):
        out.append("the pool started with a version-skewed worker — the "
                   "ready gate did not hold")
    if s.get("state") != "failed":
        out.append(f"skewed slot ended {s.get('state')!r}, expected "
                   "'failed' (parked)")
    reason = s.get("reason") or ""
    if "skew" not in reason:
        out.append(f"refusal reason does not name the version skew: "
                   f"{reason[:120]!r}")
    if BUILD_POINTER not in reason:
        out.append(f"refusal reason lost the `{BUILD_POINTER}` pointer")
    if s.get("restarts"):
        out.append(f"supervisor scheduled {s['restarts']} restart(s) for "
                   "a skew refusal — a redeploy problem must not be "
                   "hot-spun")
    return out


def _check_mesh_pinned_worker_kill(r):
    """SIGKILL a device-pinned worker mid-batch — the r11
    pool-kill scenario on the mesh path.  The replacement must re-pin
    its predecessor's EXACT device slice (slices are slot-derived, and
    the spawn events prove the derivation was honored), re-warm from
    the serialized AOT cache (fresh compiles stay 0 across the fleet),
    and the pool's cross-process books must still close."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_pool")
    pool = art.get("pool") or {}
    if not pool.get("kills"):
        out.append("no worker death observed — the injected process kill "
                   "did not fire")
    if not pool.get("restarts"):
        out.append("no restart recorded — the dead pinned worker was "
                   "never replaced")
    events = pool.get("events") or []
    spawns: dict = {}
    for e in events:
        if e.get("event") == "spawn":
            spawns.setdefault(e.get("worker_id"), []).append(
                e.get("device_slice"))
    if any(s is None for slices in spawns.values() for s in slices):
        out.append("a spawn event carries no device_slice — pinning was "
                   "not plumbed to the worker")
    respawned = {w: slices for w, slices in spawns.items()
                 if len(slices) >= 2}
    if not respawned:
        out.append("no worker spawned twice — the replacement's re-pin "
                   "was never exercised")
    for w, slices in respawned.items():
        if len(set(slices)) != 1:
            out.append(f"{w} re-pinned a DIFFERENT slice across spawns "
                       f"({slices}) — the slot->slice derivation broke")
    fresh = (art.get("compile") or {}).get("in_window_fresh_compiles")
    if isinstance(fresh, int) and fresh != 0:
        out.append(f"in_window_fresh_compiles = {fresh} — a replacement "
                   "compiled instead of loading the AOT cache")
    if not (art.get("requests") or {}).get("served"):
        out.append("nothing served — the pool did not keep serving past "
                   "the dead pinned worker")
    return out


def _serve_pool_scenarios():
    # chaos hit counters are PER-PROCESS: every worker's own readiness
    # self-probe dispatches once per REGISTERED endpoint before any load
    # arrives, so the kill's `after` must skip exactly that many hits or
    # the worker kills itself during its probe (and the load sees no
    # failure to rescue).  Derived from the registry, like the probe.
    from csmom_tpu_torch.registry import serve_endpoints

    probe_dispatches = len(serve_endpoints())
    return [
        Scenario(
            "pool-worker-kill-mid-batch", "serve-pool",
            FaultPlan("pool-worker-kill", seed=30, faults=(
                Fault(point="serve.dispatch", action="kill",
                      after=probe_dispatches,
                      max_fires=1, global_once=True),
            )),
            _check_pool_worker_kill, fast=True,
            notes="one worker PROCESS dies mid-batch (chaos kill at "
                  "serve.dispatch, global-once across the fleet): router "
                  "books stay closed, failover rescues in-flight "
                  "requests, availability >= 99%",
            env={"mode": "kill",
                 "pool": {"n_workers": 2},
                 "load": {"schedule": "0.6x70", "seed": 13,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "mesh-pinned-worker-kill", "serve-pool",
            FaultPlan("mesh-pinned-worker-kill", seed=31, faults=(
                Fault(point="serve.dispatch", action="kill",
                      after=probe_dispatches,
                      max_fires=1, global_once=True),
            )),
            _check_mesh_pinned_worker_kill, fast=True,
            notes="SIGKILL a DEVICE-PINNED worker mid-batch: "
                  "the replacement re-pins its slot's exact device slice "
                  "(spawn events prove it), re-warms from the AOT cache "
                  "(0 fresh compiles), and the pool books close",
            env={"mode": "kill", "wait_respawn": True,
                 "pool": {"n_workers": 2, "devices_per_worker": 2},
                 "load": {"schedule": "0.8x70", "seed": 15,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "trace-stitch-worker-kill", "serve-pool",
            FaultPlan("trace-stitch-worker-kill", seed=32, faults=(
                Fault(point="serve.dispatch", action="kill",
                      after=probe_dispatches,
                      max_fires=1, global_once=True),
            )),
            _check_trace_stitch_worker_kill, fast=True,
            notes="the pool kill with request tracing ARMED — "
                  "complete traces carry both stitched halves (router "
                  "transport + worker stages), the dead worker's "
                  "dispatches close as reason-carrying orphan halves, "
                  "trace books balance and stage sums reconcile (trace "
                  "schema)",
            env={"mode": "kill", "trace": True, "wait_respawn": True,
                 "pool": {"n_workers": 2},
                 "load": {"schedule": "0.8x70", "seed": 16,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "fleet-capture-worker-kill", "serve-pool",
            FaultPlan("fleet-capture-worker-kill", seed=33, faults=(
                Fault(point="serve.dispatch", action="kill",
                      after=probe_dispatches,
                      max_fires=1, global_once=True),
            )),
            _check_fleet_capture_worker_kill, fast=True,
            notes="the pool kill with the fleet observatory "
                  "ARMED — the victim's metric stream closes as a "
                  "severed series gap (never silent truncation), its "
                  "replacement's spawn→ready wall lands as a lifecycle "
                  "sample, the kill-window capacity account books a "
                  "loss the steady state does not, and the demand book "
                  "reconciles with the request ledger (fleet schema)",
            env={"mode": "kill", "fleet": True, "wait_respawn": True,
                 "pool": {"n_workers": 2},
                 "load": {"schedule": "0.8x70", "seed": 16,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "spare-promote-on-kill", "serve-pool",
            FaultPlan("spare-promote-on-kill", seed=34, faults=(
                Fault(point="serve.dispatch", action="kill",
                      after=probe_dispatches,
                      max_fires=1, global_once=True),
            )),
            _check_spare_promote_on_kill, fast=True,
            notes="the pool kill with a HOT SPARE parked out "
                  "of the ring — the elastic tier promotes the spare "
                  "into the victim's slot (one promotion, wall far "
                  "below a re-warm), the spare-credited capacity "
                  "account shows no kill-window capacity hole, the "
                  "spare ids never leak into the serving books, and "
                  "the elastic block closes by schema",
            env={"mode": "kill", "fleet": True, "spares": 1,
                 "wait_respawn": True,
                 "pool": {"n_workers": 2},
                 "load": {"schedule": "0.8x70", "seed": 16,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "pool-rolling-restart-under-load", "serve-pool", None,
            _check_pool_rolling_restart, fast=True,
            notes="rolling restart under open-loop load: every "
                  "replacement warm-before-ready (0 in-window compiles), "
                  "predecessors drain only after, availability 100%",
            env={"mode": "roll",
                 "pool": {"n_workers": 2},
                 "load": {"schedule": "1.2x40", "seed": 14,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "pool-aot-cache-version-skew", "serve-pool", None,
            _check_pool_version_skew, fast=True,
            notes="supervisor expects a different AOT cache version: the "
                  "worker refuses ready with a pointed message (skew + "
                  "warmup remedy) and the slot parks — no restart loop, "
                  "no silent in-window compile",
            env={"mode": "skew", "pool": {"n_workers": 1}},
        ),
    ]



def _check_fabric_partition(r):
    """A router replica is PARTITIONED from a worker host
    mid-burst (chaos ``partition`` at serve.transport, fired inside one
    replica, global-once across the tier).  Every dial to that peer
    fails instantly until the partition heals; the replica's failover/
    hedging must route around it, the CLIENT books must stay closed,
    and availability must reconcile at 1.0 — an admitted request never
    dies with a partitioned wire."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_fabric")
    req = art.get("requests") or {}
    conn_fails = 0
    for rep in (art.get("routers") or {}).get("replicas") or []:
        a = rep.get("accounting")
        if isinstance(a, dict):
            conn_fails += a.get("worker_conn_failures", 0) or 0
    if not conn_fails:
        out.append("no router→worker connection failure recorded — the "
                   "partition never fired (or its refusals were hidden)")
    if not req.get("served"):
        out.append("nothing served — the fabric did not keep serving "
                   "through the partition")
    if (art.get("availability") or 0.0) < 1.0:
        out.append(f"availability {art.get('availability')} < 1.0 — an "
                   "admitted request was lost to a healed partition "
                   "(failover/hedging did not route around it)")
    return out


def _check_fabric_straggler(r):
    """Induced stragglers (chaos ``net_delay`` at
    serve.transport stalls a bounded number of router→worker dials).
    The hedging policy is what the scenario measures: hedges MUST fire
    (the straggler was detected) and the hedge rate MUST stay bounded
    (Tail at Scale's paid-insurance property — a hedge storm would
    double fleet load exactly when it straggles), with the client books
    closed and availability 1.0."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_fabric")
    hedge = art.get("hedge") or {}
    rt = hedge.get("router_tier") or {}
    if not rt.get("hedged"):
        out.append("no hedge fired — the induced straggler was never "
                   "detected (or the delay missed every dial)")
    rate = hedge.get("rate")
    if isinstance(rate, (int, float)) and rate > 0.5:
        out.append(f"hedge rate {rate} > 0.5 — hedging went from paid "
                   "insurance to a load doubler under the straggler")
    if (art.get("availability") or 0.0) < 1.0:
        out.append(f"availability {art.get('availability')} < 1.0 — a "
                   "stalled wire cost an admitted request")
    if not (art.get("requests") or {}).get("served"):
        out.append("nothing served under the induced straggler")
    return out


def _check_fabric_router_kill(r):
    """The rehearsed r18 double kill — one ROUTER replica and
    one WORKER SIGKILLed mid-burst.  The client tier must fail its
    in-flight requests over to the surviving replica (failovers > 0),
    both supervisors must respawn their slots, the CLIENT books must
    close (the outermost ledger survives both corpses), and
    availability must reconcile at 1.0."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "serve_fabric")
    req = art.get("requests") or {}
    routers = art.get("routers") or {}
    workers = art.get("workers") or {}
    if not routers.get("kills"):
        out.append("no router replica death observed — the SIGKILL "
                   "missed the router tier")
    if not workers.get("kills"):
        out.append("no worker death observed — the SIGKILL missed the "
                   "worker tier")
    if not (req.get("failovers") or req.get("router_conn_failures")):
        out.append("no client-side failover recorded — the router kill "
                   "hit no in-flight request (nothing was rescued)")
    if not routers.get("restarts"):
        out.append("the dead router replica was never replaced")
    if not workers.get("restarts"):
        out.append("the dead worker was never replaced")
    if (art.get("availability") or 0.0) < 1.0:
        out.append(f"availability {art.get('availability')} < 1.0 — an "
                   "admitted request died with a corpse; the fabric's "
                   "whole point is that none can")
    if not req.get("served"):
        out.append("nothing served through the double kill")
    return out


def _serve_fabric_scenarios():
    return [
        Scenario(
            "fabric-partition-mid-burst", "serve-fabric",
            FaultPlan("fabric-partition", seed=33, faults=(
                Fault(point="serve.transport", action="partition",
                      after=6, max_fires=1, global_once=True),
            )),
            _check_fabric_partition,
            notes="one router replica loses a worker HOST "
                  "mid-burst (chaos partition at serve.transport, "
                  "global-once): dials to the peer fail instantly until "
                  "the partition heals, failover/hedging route around "
                  "it, client books close, availability 1.0",
            env={"transport": "tcp",
                 "pool": {"n_workers": 2},
                 "chaos_env": {"CSMOM_CHAOS_PARTITION_S": "0.6"},
                 "load": {"schedule": "1.0x60", "seed": 17,
                          "deadline_s": 3.0}},
        ),
        Scenario(
            "fabric-induced-straggler", "serve-fabric",
            FaultPlan("fabric-straggler", seed=34, faults=(
                Fault(point="serve.transport", action="net_delay",
                      after=4, max_fires=5),
            )),
            _check_fabric_straggler,
            notes="induced stragglers (net_delay stalls a "
                  "bounded number of router→worker dials): hedges fire "
                  "(Tail at Scale) but the hedge rate stays bounded "
                  "<= 0.5, books close, availability 1.0",
            # the induced delay (0.9 s) must OUTLAST the hedge trigger
            # (0.25 x the 1.5 s budget ≈ 0.38 s): a delay the primary
            # absorbs before the hedge timer fires rehearses nothing
            env={"pool": {"n_workers": 2},
                 "hedge_fraction": 0.25,
                 "chaos_env": {"CSMOM_CHAOS_NET_DELAY_S": "0.9"},
                 "load": {"schedule": "0.8x50", "seed": 18,
                          "deadline_s": 1.5}},
        ),
        Scenario(
            "fabric-router-kill-mid-burst", "serve-fabric", None,
            _check_fabric_router_kill,
            notes="the rehearsed r18 double kill — one router "
                  "replica AND one worker SIGKILLed mid-burst: client "
                  "failover rescues in-flight requests, both tiers "
                  "respawn, the outermost books close, availability 1.0",
            env={"pool": {"n_workers": 2},
                 "kill": {"router_after": 0.25, "worker_after": 0.45},
                 "load": {"schedule": "1.4x45", "seed": 19,
                          "deadline_s": 3.0}},
        ),
    ]



def _check_replay_tick_storm(r):
    """Under a storm of late / out-of-order / duplicate / gap
    ticks, the replay must keep BOTH closed books (tick ledger + serve
    book — schema rules of kind ``replay``), materialize the gap as a
    stale bar instead of carrying the last price, and the incremental
    signals must still reconcile bit-for-bit against the full-panel
    recompute (drift_events == 0; late merges show up as rebuilds)."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "replay")
    t = art.get("ticks") or {}
    for k in ("merged_late", "quarantined", "deduped", "dropped_gap"):
        if not t.get(k):
            out.append(f"ticks.{k} == 0 — the injected fault did not "
                       "fire or its outcome was hidden")
    if not (art.get("panel") or {}).get("gap_bars"):
        out.append("no gap bar materialized — the dropped bar was "
                   "papered over instead of marked stale")
    rec = art.get("reconcile") or {}
    if not rec.get("count"):
        out.append("no reconciliation ran — the equivalence check never "
                   "exercised")
    if rec.get("drift_events"):
        out.append(f"reconcile.drift_events = {rec['drift_events']} — "
                   "the incremental signals drifted from the full "
                   "recompute under the tick storm")
    if not rec.get("rebuilds"):
        out.append("no rebuild after late merges — merged-in-place "
                   "history must invalidate running sums")
    if not ((art.get("serve") or {}).get("requests") or {}).get("served"):
        out.append("nothing served — the live panel never answered "
                   "under the storm")
    return out


def _check_replay_version_skew(r):
    """A serve probe answering from a stale panel snapshot must
    be REFUSED and counted (the streaming analogue of the r11 AOT
    version-skew gate), with the books still balanced and later probes
    served from fresh snapshots."""
    art = r.get("artifact") or {}
    out = inv.validate(art, "replay")
    v = art.get("versions") or {}
    if not v.get("skew_events"):
        out.append("the version-skew fault never fired — nothing was "
                   "rehearsed")
    if not v.get("skew_refusals"):
        out.append("a stale-snapshot request was NOT refused — the "
                   "panel-version gate did not hold")
    if not ((art.get("serve") or {}).get("requests") or {}).get("served"):
        out.append("nothing served — the gate refused more than the "
                   "skewed probe")
    return out


def _replay_scenarios():
    return [
        Scenario(
            "replay-tick-storm", "replay",
            FaultPlan("replay-tick-storm", seed=40, faults=(
                Fault(point="stream.tick", action="tick_late", after=90,
                      max_fires=6),
                Fault(point="stream.tick", action="tick_late", after=140,
                      max_fires=5),
                Fault(point="stream.tick", action="tick_dup", after=110,
                      max_fires=4),
                # a whole-bar gap: drop every tick of one bar (8 assets)
                Fault(point="stream.tick", action="tick_drop",
                      after=22 * 8, max_fires=8),
            )),
            _check_replay_tick_storm, fast=True,
            notes="late/out-of-order/duplicate/gap tick storm: closed "
                  "tick books, gap marked stale (never price-carried), "
                  "incremental == full recompute bit-for-bit "
                  "(rebuild-on-merge, zero drift)",
        ),
        Scenario(
            "replay-ingest-serve-skew", "replay",
            FaultPlan("replay-ingest-serve-skew", seed=41, faults=(
                Fault(point="stream.serve", action="version_skew",
                      after=1, max_fires=1),
            )),
            _check_replay_version_skew, fast=True,
            notes="serve probe answers from a stale snapshot: the "
                  "panel-version gate refuses it (counted), books stay "
                  "closed, fresh probes keep serving — the r11 AOT-skew "
                  "gate's streaming twin",
        ),
    ]


_KERNEL_WRAPPERS = ("decile_partial_sums", "cohort_partial_sums", "rank_labels")


def _check_warmup_healed(r):
    """A corrupt kernel-library cache must cost a rebuild, never the
    warm-up: no entry errors and every entry warmed.  On the card the
    heal must be seen: at least one entry ``self_healed``, and K1 and K2
    each launched from the rebuilt libraries.  A failed fault-free first
    pass fails the scenario too."""
    out = list(r.get("headline_violations") or [])
    rep = r.get("trailing")
    if rep is None:
        return out + ["warmup printed no summary line"]
    if rep.get("n_errors", 1) != 0:
        out.append(
            f"warmup reported {rep.get('n_errors')} errors over a corrupt "
            "cache — self-heal (evict + recompile) did not hold"
        )
    if rep.get("value", 0) <= 0:
        out.append("warmup compiled no manifest entries")
    if rep.get("platform") == "gpu":
        if (rep.get("n_self_healed") or 0) < 1:
            out.append("no entry self-healed on the card — the corrupt "
                       "libraries were loaded as they were, or never "
                       "corrupted")
        launches = rep.get("launches") or {}
        for name in _KERNEL_WRAPPERS:
            if not launches.get(name):
                out.append(f"{name} was not launched by the warmed entries "
                           "— the healed library was never run")
    return out


def _check_bench_partial(r):
    """The child lost its device mid-run after the headline: the
    already-measured headline lands in an explicitly-partial line."""
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["no trailing JSON line — the empty-record failure"]
    extra = obj.get("extra") or {}
    if not str(extra.get("partial", "")).startswith("child deadline hit"):
        out.append("expected the child deadline watchdog's partial marker")
    if not isinstance(obj.get("value"), (int, float)) or obj["value"] <= 0:
        out.append("the measured headline value was lost")
    if extra.get("platform") != r.get("platform", "cpu"):
        out.append("partial record lost its platform attribution")
    if r["rc"] != 0:
        out.append(f"watchdog dump must exit 0, got rc={r['rc']}")
    return out


def _check_bench_supervisor_landed(r):
    """Supervisor-level faults: whatever broke, ONE schema-valid headline
    lands on stdout and points at (or explains) the full record."""
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["supervisor printed no parseable headline"]
    extra = obj.get("extra") or {}
    if "full_record" not in extra:
        out.append("headline does not reference the full record")
    full = r.get("full_record")
    if full is not None:
        out += [f"full record: {v}" for v in inv.validate(full)]
    return out


def _check_kill_retried(r):
    """The first child is SIGKILLed mid-compile: the retry on the same
    device secures a measured record, and the lost attempt is recorded."""
    out = _check_bench_supervisor_landed(r)
    obj = r["trailing"] or {}
    if not isinstance(obj.get("value"), (int, float)) or obj.get("value", 0) <= 0:
        out.append("no measured value — the retried child did not secure "
                   "the record")
    full = r.get("full_record") or {}
    errs = (full.get("extra") or {}).get("attempt_errors") or []
    if not any("child" in str(e) for e in errs):
        out.append("the SIGKILLed first child left no trace in "
                   "attempt_errors — a lost attempt must be recorded, "
                   "not hidden")
    if r["rc"] != 0:
        out.append(f"a measured record must exit 0, got rc={r['rc']}")
    return out


def _check_probe_outage(r):
    """Every probe fails: nothing is measured on another device.  The
    headline is the last-resort line (value 0, an error), the process
    exits 1, and the probes, the full record and the telemetry sidecar
    all land."""
    out = _check_bench_supervisor_landed(r)
    obj = r["trailing"] or {}
    if obj.get("value") != 0.0 or not (obj.get("extra") or {}).get("error"):
        out.append("expected the last-resort record (value 0.0 with an "
                   "error), not a measured one")
    if r["rc"] != 1:
        out.append(f"the last-resort record must exit 1, got rc={r['rc']}")
    full = r.get("full_record")
    if full is None:
        out.append("the full record did not land")
    else:
        probes = (full.get("extra") or {}).get("probes") or []
        if not probes or any(p.get("ok") for p in probes):
            out.append(f"expected every probe recorded as failed, got "
                       f"{probes}")
    side = r.get("telemetry_sidecar")
    if side is None:
        out.append("the telemetry sidecar did not land")
    else:
        out += [f"telemetry sidecar: {v}" for v in inv.validate(side)]
    return out


def _check_bench_child_full(r):
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["no trailing JSON line"]
    if inv.is_partial(obj):
        out.append("clock skew shortened the monotonic deadline — the "
                   "run was cut into a partial")
    if r["rc"] != 0:
        out.append(f"rc={r['rc']}")
    return out


def _bench_scenarios():
    return [
        Scenario(
            "r5-hang-mid-compile-window", "bench-child",
            FaultPlan("r5-hang", seed=10, faults=(
                # the device stalls right after the headline, mid
                # "compile the next leg"
                Fault(point="bench.row", action="sleep", seconds=600.0,
                      role="child"),
            )),
            _check_bench_partial,
            notes="the child loses its device after the headline; the "
                  "deadline guard lands a partial with the measured "
                  "headline instead of an empty record",
            env={"CSMOM_BENCH_CHILD_BUDGET": "150"},
        ),
        Scenario(
            "expire-deadline-mid-row", "bench-child",
            FaultPlan("expire-deadline-mid-row", seed=11, faults=(
                Fault(point="bench.row", action="trip_deadline",
                      role="child"),
            )),
            _check_bench_partial,
            notes="deadline expiry between measured rows on the real "
                  "child — the instant form of the hang",
            env={"CSMOM_BENCH_CHILD_BUDGET": "600"},
        ),
        Scenario(
            "kill-child-mid-compile", "bench",
            FaultPlan("kill-child-mid-compile", seed=12, faults=(
                Fault(point="bench.compile", action="kill", role="child",
                      global_once=True),
            )),
            _check_kill_retried,
            notes="the first child is SIGKILLed mid-compile; the retried "
                  "child on the same device still secures a measured "
                  "record, and attempt_errors names the lost one",
        ),
        Scenario(
            "probe-outage", "bench",
            FaultPlan("probe-outage", seed=13, faults=(
                Fault(point="bench.probe", action="fail",
                      role="supervisor", max_fires=0),
            )),
            _check_probe_outage,
            notes="every device probe fails; nothing is measured on "
                  "another device: the last-resort line, exit 1, the "
                  "probes recorded and the full record and telemetry "
                  "landed",
            budget_s=480,
        ),
        Scenario(
            "enospc-on-land", "bench",
            FaultPlan("enospc-on-land", seed=14, faults=(
                Fault(point="bench.land", action="raise_oserror",
                      role="supervisor", errno_=28),
            )),
            _check_bench_supervisor_landed,
            notes="full-record write hits ENOSPC; the headline still "
                  "prints, carrying the write failure as a reason",
        ),
        Scenario(
            "corrupt-aot-cache", "warmup",
            FaultPlan("corrupt-aot-cache", seed=15, faults=(
                Fault(point="warmup.entry", action="corrupt_file",
                      path="$CSMOM_JIT_CACHE/*", max_fires=1),
            )),
            _check_warmup_healed,
            notes="serialized-executable cache corrupted on disk; warmup "
                  "evicts + recompiles (self-heal) instead of crashing",
        ),
        Scenario(
            "clock-skew-mid-child", "bench-child",
            FaultPlan("clock-skew-mid-child", seed=16, faults=(
                Fault(point="bench.compile", action="clock_skew",
                      seconds=3600.0, role="child"),
            )),
            _check_bench_child_full,
            notes="NTP-step wall-clock jump inside the child; the "
                  "monotonic deadline holds and the full record lands",
            env={"CSMOM_BENCH_CHILD_BUDGET": "600"},
        ),
    ]


def builtin_matrix(fast: bool = False):
    mats = (_mini_scenarios() + _shell_scenarios() + _serve_scenarios()
            + _serve_pool_scenarios() + _serve_fabric_scenarios()
            + _replay_scenarios())
    if not fast:
        mats += _bench_scenarios()
    else:
        mats = [s for s in mats if s.fast]
    return mats


# -------------------------------------------------------------- runners ----

def _base_env(scenario, box: str) -> dict:
    env = dict(os.environ)
    env.pop("CSMOM_FAULT_STATE", None)
    # a rehearsed process must not append to the rehearsal's own telemetry
    # stream: its run is the scenario's, not ours
    env.pop("CSMOM_TELEMETRY", None)
    env.pop("CSMOM_TELEMETRY_RUN", None)
    env.update({
        "CSMOM_FAULT_STATE": os.path.join(box, "chaos-state"),
        "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    if scenario.plan is not None:
        plan_path = os.path.join(box, "plan.toml")
        with open(plan_path, "w") as f:
            f.write(scenario.plan.to_toml())
        env["CSMOM_FAULT_PLAN"] = plan_path
    env.update(scenario.env)
    return env


def _land_with_capture_lib(raw_path: str, art_path: str, env=None) -> None:
    script = (
        "log() { echo \"[capture_lib] $*\" >&2; }; "
        f"source '{_CAPTURE_LIB}'; "
        f"land_artifact '{raw_path}' '{art_path}'"
    )
    subprocess.run(["bash", "-c", script], check=False,
                   env={**os.environ, **(env or {})},
                   capture_output=True, text=True)


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _run_mini(scenario, box: str) -> dict:
    sidecar = os.path.join(box, "sidecar.jsonl")
    env = _base_env(scenario, box)
    env.setdefault("CSMOM_MINIBENCH_BUDGET", "60")
    env.update({
        "CSMOM_MINIBENCH_ROWS": str(scenario.rows),
        "CSMOM_MINIBENCH_SIDECAR": sidecar,
    })
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.chaos.minibench"],
        capture_output=True, text=True, timeout=120, env=env, cwd=box,
    )
    raw = os.path.join(box, "raw.out")
    with open(raw, "w") as f:
        f.write(p.stdout)
    art = os.path.join(box, "ARTIFACT.json")
    _land_with_capture_lib(raw, art)
    sidecar_rows = 0
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            sidecar_rows = sum(1 for ln in f if ln.strip())
    trailing = inv.trailing_json(p.stdout)
    return {
        "rc": p.returncode,
        "stdout": p.stdout,
        "stderr": p.stderr,
        "trailing": trailing,
        "headline_violations": (
            inv.validate_headline_text(p.stdout) if trailing else []
        ),
        "sidecar_rows": sidecar_rows,
        "artifact": _read_json(art),
    }


def _run_shell(scenario, box: str) -> dict:
    # a known-good raw capture, landed twice: once under the short-write
    # fault (must refuse), once clean (must land)
    full = {"metric": "m", "value": 3.0, "unit": "u", "vs_baseline": 1.0,
            "extra": {"rows": [{"r": 0}, {"r": 1}]}}
    prior = {"metric": "m", "value": 2.0, "unit": "u", "vs_baseline": 1.0,
             "extra": {"partial": "one row measured", "rows": [{"r": 0}]}}
    raw = os.path.join(box, "raw.out")
    with open(raw, "w") as f:
        f.write("progress line\n" + json.dumps(full) + "\n")
    art = os.path.join(box, "ARTIFACT.json")
    prior_path = os.path.join(box, "PRIOR.json")
    with open(prior_path, "w") as f:
        json.dump(prior, f)
    # faulted landing over an empty slot must not land garbage
    _land_with_capture_lib(raw, art,
                           env={"CSMOM_FAULT_LAND_TRUNCATE_BYTES": "20"})
    landed_faulted = _read_json(art)
    # faulted landing over an existing partial must leave it intact
    _land_with_capture_lib(raw, prior_path,
                           env={"CSMOM_FAULT_LAND_TRUNCATE_BYTES": "20"})
    prior_after = _read_json(prior_path)
    # clean retry lands
    _land_with_capture_lib(raw, art)
    return {
        "rc": 0,
        "stdout": "",
        "stderr": "",
        "trailing": full,
        "headline_violations": [],
        "sidecar_rows": 0,
        "artifact": landed_faulted,
        "prior_intact": prior_after == prior,
        "retry_artifact": _read_json(art),
    }


def _run_bench_child(scenario, box: str, device: str) -> dict:
    """The bench's measuring child alone, in smoke mode, on ``device``."""
    env = _base_env(scenario, box)
    env.update({"CSMOM_BENCH_CHILD": "1", "CSMOM_BENCH_SMOKE": "1"})
    if device == "cpu":
        env["CSMOM_BENCH_FORCE_CPU"] = "1"
    else:
        env.pop("CSMOM_BENCH_FORCE_CPU", None)
    env.setdefault("CSMOM_BENCH_CHILD_BUDGET", "300")
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.bench"],
        capture_output=True, text=True, env=env, cwd=box,
        timeout=float(env["CSMOM_BENCH_CHILD_BUDGET"]) + 60,
    )
    trailing = inv.trailing_json(p.stdout)
    return {
        "rc": p.returncode,
        "stdout": p.stdout,
        "stderr": p.stderr,
        "trailing": trailing,
        # the supervisor parses a child's line and builds the bounded
        # headline itself, so a direct child run validates the record
        # schema only, not the 2,000-char cap
        "headline_violations": (
            inv.validate(trailing, "record") if trailing else []
        ),
        "sidecar_rows": 0,
        "platform": "cpu" if device == "cpu" else "gpu",
    }


def _run_bench_supervisor(scenario, box: str, device: str) -> dict:
    """The bench supervisor in smoke mode on ``device``, its full record
    and telemetry sidecar landing in the sandbox."""
    env = _base_env(scenario, box)
    env.pop("CSMOM_BENCH_FORCE_CPU", None)
    env.update({
        "CSMOM_BENCH_SMOKE": "1",
        "CSMOM_BENCH_FULL_DIR": box,
        "CSMOM_ROUND": "rehearse",
        "CSMOM_BENCH_BUDGET": str(scenario.budget_s or 600),
    })
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.bench", "--device", device],
        capture_output=True, text=True, env=env, cwd=box,
        timeout=(scenario.budget_s or 600) + 120,
    )
    trailing = inv.trailing_json(p.stdout)
    return {
        "rc": p.returncode,
        "stdout": p.stdout,
        "stderr": p.stderr,
        "trailing": trailing,
        "headline_violations": (
            inv.validate_headline_text(p.stdout) if trailing else []
        ),
        "sidecar_rows": 0,
        "full_record": _read_json(
            os.path.join(box, "GPU_BENCH_FULL_rehearse.json")
        ),
        "telemetry_sidecar": _read_json(
            os.path.join(box, "GPU_TELEMETRY_rehearse.json")
        ),
    }


def warmup_pass(device: str) -> None:
    """One process of the ``corrupt-aot-cache`` scenario: warm profile
    ``smoke`` on ``device`` (no golden event, no report written), then the
    smoke grid's shape through K2 (``smoke`` warms the grid on its plain
    path only, so without this entry K2's library would be neither built
    nor healed), and print the summary line the check reads: the
    reference's (entries, errors, cache hits) with the entries that
    self-healed, the platform and the kernel launches of the entries."""
    import numpy as np

    from csmom_tpu_torch.compile.aot import aot_compile, warmup
    from csmom_tpu_torch.compile.manifest import grid_entries

    rep = warmup(profiles=("smoke",), subdir="rehearse",
                 include_golden_event=False, write_report=False,
                 device=device)
    (k2,) = grid_entries(16, 48, np.float64, tag="16x48",
                         modes_impls=[("rank", "kernel")])
    try:
        rec = aot_compile(k2, device=device)
    except Exception as e:  # recorded as warmup() records its entries
        rec = {"name": k2.name, "error": f"{type(e).__name__}: {e}"[:200]}
    entries = [*rep["entries"], rec]
    launches = dict.fromkeys(_KERNEL_WRAPPERS, 0)
    for e in entries:
        for name, n in (e.get("launches") or {}).items():
            launches[name] = launches.get(name, 0) + n
    print(json.dumps({"metric": "aot_warmup", "value": len(entries),
                      "unit": "entries", "vs_baseline": 1.0,
                      "n_errors": sum("error" in e for e in entries),
                      "n_cache_hits": sum(bool(e.get("cache_hit"))
                                          for e in entries),
                      "n_self_healed": sum(bool(e.get("self_healed"))
                                           for e in entries),
                      "platform": rep["platform"], "launches": launches}),
          flush=True)


def _run_warmup(scenario, box: str, device: str) -> dict:
    """Two warm-up processes on ``device`` with the kernel build directory
    in the sandbox (``CSMOM_JIT_CACHE``): a fault-free pass that builds
    the libraries, then the armed pass whose first entry corrupts every
    file of that directory.  Each pass's output is kept in the sandbox
    (``pass1.out``, ``pass2.out`` and their ``.err``)."""
    env = _base_env(scenario, box)
    env["CSMOM_JIT_CACHE"] = os.path.join(box, "jit-cache")
    argv = [sys.executable, "-c",
            "from csmom_tpu_torch.cli.rehearse import warmup_pass; "
            f"warmup_pass({device!r})"]
    clean = {k: v for k, v in env.items() if k != "CSMOM_FAULT_PLAN"}
    walls, procs = [], []
    for n, pass_env in ((1, clean), (2, env)):
        t0 = time.monotonic()
        p = subprocess.run(argv, capture_output=True, text=True,
                           env=pass_env, cwd=box, timeout=600)
        walls.append(time.monotonic() - t0)
        procs.append(p)
        for ext, text in (("out", p.stdout), ("err", p.stderr)):
            with open(os.path.join(box, f"pass{n}.{ext}"), "w") as f:
                f.write(text)
    p0, p = procs
    trailing = inv.trailing_json(p.stdout)
    report = [f"pass 1 (fault-free) {walls[0]:.1f}s, pass 2 (cache "
              f"corrupted) {walls[1]:.1f}s; pass 2: {json.dumps(trailing)}"]
    if (trailing or {}).get("platform") == "cpu":
        report.append("--device cpu: the entries ran the plain versions and "
                      "no kernel library was built, so none was there to "
                      "corrupt")
    out = {
        "rc": p.returncode,
        "stdout": p.stdout,
        "stderr": p.stderr,
        "trailing": trailing,
        "headline_violations": [],
        "report": report,
    }
    if p0.returncode != 0:
        out["headline_violations"] = [
            f"fault-free warmup pass failed rc={p0.returncode}: "
            f"{p0.stderr[-300:]}"
        ]
    return out


def _run_serve(scenario, box: str) -> dict:
    """Drive the signal service IN-PROCESS (stub engine, smoke buckets).

    The serve subsystem is thread-based by design and the rehearsed
    faults are result faults (``fail``) and delays (``sleep``), not
    process faults — so the scenario runs inside the rehearsal process:
    no subprocess and no device.
    ``scenario.env`` here carries runner kwargs (``serve`` -> ServeConfig
    overrides, ``load`` -> LoadConfig overrides), not OS env vars.
    """
    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        run_loadgen,
        write_artifact,
    )
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    saved = {k: os.environ.get(k) for k in (PLAN_ENV, "CSMOM_FAULT_STATE")}
    try:
        if scenario.plan is not None:
            plan_path = os.path.join(box, "plan.toml")
            with open(plan_path, "w") as f:
                f.write(scenario.plan.to_toml())
            os.environ[PLAN_ENV] = plan_path
        os.environ["CSMOM_FAULT_STATE"] = os.path.join(box, "chaos-state")
        inject.reset()  # re-read the scenario's plan, fresh hit counters
        svc = SignalService(ServeConfig(
            profile="serve-smoke", engine="stub",
            **scenario.env.get("serve", {}))).start()
        load = LoadConfig(run_id=f"rehearse_{scenario.name}",
                          **scenario.env.get("load", {}))
        art = run_loadgen(svc, load)
        write_artifact(box, art)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        inject.reset()  # the next scenario must not inherit this plan
    return {
        "rc": 0,
        "stdout": "",
        "stderr": "",
        "trailing": art,
        "headline_violations": [],
        "artifact": art,
    }


def _run_serve_pool(scenario, box: str) -> dict:
    """Drive the MULTI-PROCESS pool: stub-engine worker subprocesses
    behind the real supervisor + router (serve-smoke buckets, no device
    in any process).

    The fault plan arms via the environment so the worker PROCESSES
    inherit it (the ``kill`` at ``serve.dispatch`` is a real process
    death); ``scenario.env`` carries runner kwargs: ``mode``
    (kill | roll | skew), ``pool`` -> PoolConfig overrides, ``load`` ->
    LoadConfig overrides.
    """
    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.obs import fleet as obs_fleet
    from csmom_tpu_torch.obs import trace as obs_trace
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        run_pool_loadgen,
        write_artifact,
    )
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.supervisor import (
        PoolConfig,
        PoolSupervisor,
        pick_transport,
    )
    from csmom_tpu_torch.utils.deadline import mono_now_s

    mode = scenario.env.get("mode", "load")
    # unix sockets where the sandbox's paths fit them, else tcp; the
    # bound is taken one directory deeper, since the fleet aggregator's
    # "aggregator.sock" is longer than a slot's longest socket name
    transport = pick_transport(os.path.join(box, "aggregator"))
    saved = {k: os.environ.get(k) for k in (PLAN_ENV, "CSMOM_FAULT_STATE")}
    sup = None
    trace_book = (obs_trace.arm_tracing(seed=scenario.plan.seed
                                        if scenario.plan else 0)
                  if scenario.env.get("trace") else None)
    # fleet capture arms BEFORE the supervisor exists so the worker
    # processes inherit the env contract at spawn
    fleet_agg = (obs_fleet.arm(f"rehearse_{scenario.name}",
                               transport=transport, scratch_dir=box)
                 if scenario.env.get("fleet") else None)
    result: dict = {"rc": 0, "stdout": "", "stderr": "",
                    "trailing": None, "headline_violations": []}
    try:
        if scenario.plan is not None:
            plan_path = os.path.join(box, "plan.toml")
            with open(plan_path, "w") as f:
                f.write(scenario.plan.to_toml())
            os.environ[PLAN_ENV] = plan_path
        else:
            os.environ.pop(PLAN_ENV, None)
        os.environ["CSMOM_FAULT_STATE"] = os.path.join(box, "chaos-state")
        inject.reset()
        cfg = PoolConfig(
            profile="serve-smoke", engine="stub",
            transport=transport,
            backoff_base_s=0.05, backoff_cap_s=0.5, ready_timeout_s=30.0,
            **({"expect_cache_version": "skewed-deadbeef"}
               if mode == "skew" else {}),
            **scenario.env.get("pool", {}))
        sup = PoolSupervisor(cfg, box)
        if mode == "skew":
            try:
                sup.start()
                started = True
            except RuntimeError:
                started = False
            h = sup.handles[0]
            result["skew"] = {
                "started": started,
                "state": h.state,
                "reason": h.reason or "",
                "restarts": h.restarts,
            }
            return result
        sup.start()
        spares = int(scenario.env.get("spares", 0) or 0)
        if spares:
            # the elastic tier: hot spares parked out of the
            # ring; in pool mode a promotion propagates the instant the
            # handle swaps (the router reads ready_workers live)
            from csmom_tpu_torch.serve.fleet import FleetConfig, FleetController

            FleetController(
                sup, FleetConfig(spares=spares,
                                 min_workers=cfg.n_workers,
                                 max_workers=cfg.n_workers + 2),
                aggregator=fleet_agg).start()
        load_over = dict(scenario.env.get("load", {}))
        deadline = load_over.pop("deadline_s", 3.0)
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=deadline))
        load = LoadConfig(run_id=f"rehearse_{scenario.name}",
                          deadline_s=deadline, **load_over)
        if fleet_agg is not None:
            # the pool path runs no self-probes through the router, so
            # the demand window opens at the measured load's doorstep
            obs_fleet.open_demand_window()
        t_load0 = mono_now_s()
        if mode == "roll":
            roll_box: dict = {}

            def _roll():
                time.sleep(0.2)  # let the load stream establish first
                roll_box["roll"] = sup.rolling_restart()

            # books close only after load AND roll settle (the
            # `concurrent` contract), so the artifact's fleet stats see
            # the post-roll generation, not a mid-roll race
            art = run_pool_loadgen(router, sup, load, concurrent=_roll)
            result["roll"] = roll_box.get("roll")
        else:
            conc = None
            if scenario.env.get("wait_respawn"):
                # the artifact must be built from a fleet where the
                # killed worker's replacement already respawned (its
                # spawn event is the re-pin evidence the check reads) —
                # run_pool_loadgen's `concurrent` contract settles it
                def conc():
                    give_up = time.monotonic() + 15.0
                    while time.monotonic() < give_up:
                        if any(h.generation >= 1 and h.state == "ready"
                               for h in sup.handles):
                            return
                        time.sleep(0.05)

            art = run_pool_loadgen(router, sup, load, concurrent=conc)
        if art is not None:
            write_artifact(box, art, prefix="GPU_SERVE_POOL")
            if trace_book is not None:
                # land the stitched trace evidence next to the pool
                # artifact, the same reconciliation the committed
                # TRACE_rNN.json family carries
                result["trace_book_violations"] = \
                    trace_book.invariant_violations()
                tart = obs_trace.build_artifact(
                    trace_book, load.run_id,
                    requests={k: art["requests"][k]
                              for k in ("admitted", "served", "rejected",
                                        "expired")},
                    fresh_compiles=(art.get("compile") or {}).get(
                        "in_window_fresh_compiles"),
                    platform=(art.get("extra") or {}).get("platform"),
                    workload=(art.get("extra") or {}).get("workload"),
                )
                write_artifact(box, tart, prefix="GPU_TRACE")
                result["trace_artifact"] = tart
            if fleet_agg is not None:
                # drain-stop the pool NOW so every surviving worker's
                # emitter fins before the books freeze — the SIGKILLed
                # generation's severed close reason is already booked,
                # and Channel.request is a synchronous round-trip so
                # stop() returning implies the fins are ingested
                sup.stop()
                obs_fleet.disarm_emitter("loadgen finished")
                fleet_agg.close_all("run-end")
                fart = obs_fleet.build_artifact(
                    fleet_agg, load.run_id,
                    requests={k: art["requests"][k]
                              for k in ("admitted", "served", "rejected",
                                        "expired")},
                    worker_events=obs_fleet.absolute_events(
                        sup.summary()["events"], sup.t0_mono_s),
                    n_workers=cfg.n_workers,
                    window=(t_load0, t_load0 + art["wall_s"]),
                    fresh_compiles=(art.get("compile") or {}).get(
                        "in_window_fresh_compiles"),
                    platform=(art.get("extra") or {}).get("platform"),
                    workload=(art.get("extra") or {}).get("workload"),
                    elastic=(sup.fleet.summary()
                             if getattr(sup, "fleet", None) is not None
                             else None),
                )
                write_artifact(box, fart, prefix="GPU_FLEET")
                result["fleet_artifact"] = fart
        result["trailing"] = art
        result["artifact"] = art
        return result
    finally:
        if trace_book is not None:
            obs_trace.disarm_tracing()
        if sup is not None:
            sup.stop()
        if fleet_agg is not None:
            # idempotent after the success path's own disarm: fin the
            # local emitter, close any still-open books, retract the env
            # contract so the NEXT scenario's spawns stay disarmed
            obs_fleet.disarm("rehearse-end")
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        inject.reset()  # the next scenario must not inherit this plan


def _run_serve_fabric(scenario, box: str) -> dict:
    """Drive the THREE-TIER fabric: stub-engine worker processes, real
    supervised router-replica processes, and the FabricClient in this
    process (serve-smoke buckets, no device anywhere).

    Network fault plans arm in the ROUTER TIER ONLY (via the router
    supervisor's ``extra_env``): the replicas are the processes that
    dial workers at ``serve.transport``, and the rehearse process's own
    client dials must not fire the fault.  ``scenario.env`` carries
    runner kwargs: ``transport`` (unix | tcp; by default unix where the
    sandbox's socket paths fit, else tcp), ``routers``, ``pool`` ->
    worker PoolConfig overrides, ``hedge_fraction``, ``chaos_env`` ->
    extra router-tier environment (fault duration knobs), ``kill`` ->
    {router_after, worker_after} mid-burst SIGKILLs, ``load`` ->
    LoadConfig overrides.
    """
    from csmom_tpu_torch.serve.fabric import (
        build_fabric,
        kill_mid_burst,
        stop_fabric,
    )
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        run_fabric_loadgen,
        write_artifact,
    )
    from csmom_tpu_torch.serve.supervisor import PoolConfig, pick_transport

    result: dict = {"rc": 0, "stdout": "", "stderr": "",
                    "trailing": None, "headline_violations": []}
    wsup = rsup = publisher = None
    try:
        transport = (scenario.env.get("transport")
                     or pick_transport(os.path.join(box, "workers")))
        smoke = dict(profile="serve-smoke", engine="stub",
                     transport=transport, backoff_base_s=0.05,
                     backoff_cap_s=0.5, ready_timeout_s=30.0)
        wcfg = PoolConfig(**{**smoke, **scenario.env.get("pool", {})})
        rcfg = PoolConfig(n_workers=scenario.env.get("routers", 2),
                          **smoke)
        load_over = dict(scenario.env.get("load", {}))
        deadline = load_over.pop("deadline_s", 3.0)

        def arm_router_tier(rsup):
            # fault plans arm in the ROUTER TIER ONLY: the replicas are
            # the processes that dial workers at serve.transport
            if scenario.plan is not None:
                plan_path = os.path.join(box, "plan.toml")
                with open(plan_path, "w") as f:
                    f.write(scenario.plan.to_toml())
                rsup.extra_env[PLAN_ENV] = plan_path
                rsup.extra_env["CSMOM_FAULT_STATE"] = os.path.join(
                    box, "chaos-state")
            rsup.extra_env.update(scenario.env.get("chaos_env", {}))

        wsup, publisher, rsup, client = build_fabric(
            wcfg, rcfg, box,
            deadline_ms=deadline * 1e3,
            hedge_fraction=scenario.env.get("hedge_fraction", 0.35),
            client_deadline_s=deadline,
            configure_router=arm_router_tier)
        load = LoadConfig(run_id=f"rehearse_{scenario.name}",
                          deadline_s=deadline, **load_over)

        kill = scenario.env.get("kill") or {}
        conc = None
        if kill:
            def conc():
                # books are built only from a SETTLED fleet: both
                # victims' replacements must demonstrate ready first
                if not kill_mid_burst(
                        [(kill.get("router_after"), rsup, "router"),
                         (kill.get("worker_after"), wsup, "worker")],
                        settle_timeout_s=30.0):
                    raise RuntimeError(
                        "a killed tier never re-demonstrated ready — "
                        "the scenario's books would come from an "
                        "unsettled fleet")

        art = run_fabric_loadgen(client, rsup, wsup, load,
                                 concurrent=conc)
        write_artifact(box, art, prefix="GPU_SERVE_FABRIC")
        result["artifact"] = art
        result["trailing"] = art
        return result
    finally:
        stop_fabric(publisher, rsup, wsup)


def _run_replay(scenario, box: str) -> dict:
    """Drive the event-time replay IN-PROCESS (stub engine, smoke
    buckets, no device).  The fault plan arms via the env contract so
    the ``stream.*`` checkpoints fire with fresh per-scenario hit
    counters; ``scenario.env`` may carry a ``replay`` dict of
    ReplayConfig overrides."""
    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.stream.replay import (
        ReplayConfig,
        run_replay,
        write_artifact,
    )

    saved = {k: os.environ.get(k) for k in (PLAN_ENV, "CSMOM_FAULT_STATE")}
    try:
        if scenario.plan is not None:
            plan_path = os.path.join(box, "plan.toml")
            with open(plan_path, "w") as f:
                f.write(scenario.plan.to_toml())
            os.environ[PLAN_ENV] = plan_path
        else:
            os.environ.pop(PLAN_ENV, None)
        os.environ["CSMOM_FAULT_STATE"] = os.path.join(box, "chaos-state")
        inject.reset()
        cfg = ReplayConfig(run_id=f"rehearse_{scenario.name}",
                           engine="stub", profile="serve-smoke",
                           **scenario.env.get("replay", {}))
        art = run_replay(cfg)
        write_artifact(box, art, prefix="GPU_REPLAY")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        inject.reset()  # the next scenario must not inherit this plan
    return {
        "rc": 0,
        "stdout": "",
        "stderr": "",
        "trailing": art,
        "headline_violations": [],
        "artifact": art,
    }


_RUNNERS = {
    "mini": _run_mini,
    "shell": _run_shell,
    "bench-child": _run_bench_child,
    "bench": _run_bench_supervisor,
    "warmup": _run_warmup,
    "serve": _run_serve,
    "serve-pool": _run_serve_pool,
    "serve-fabric": _run_serve_fabric,
    "replay": _run_replay,
}


# ------------------------------------------------------------------ cmd ----

def _run_scenario(scenario, sandbox_root: str, device: str = "cuda") -> tuple:
    box = os.path.join(sandbox_root, scenario.name)
    os.makedirs(box, exist_ok=True)
    t0 = time.monotonic()
    try:
        run = _RUNNERS[scenario.pipeline]
        # only the bench and warm-up tiers touch a device
        result = (run(scenario, box, device)
                  if scenario.pipeline in _DEVICE_PIPELINES
                  else run(scenario, box))
        violations = scenario.check(result)
    except subprocess.TimeoutExpired as e:
        violations = [f"scenario runner timed out after {e.timeout:.0f}s"]
        result = {}
    wall = time.monotonic() - t0
    return result, violations, wall


# the generic invariant of a custom plan on each pipeline: the outcome may
# be full or partial, but a schema-valid line must land with zero lost rows
def _check_custom_generic(r):
    out = list(r["headline_violations"])
    obj = r["trailing"]
    if obj is None:
        return out + ["no parseable trailing JSON line — the fault lost "
                      "the measurements"]
    if r["sidecar_rows"] and _rows_of(obj) != r["sidecar_rows"]:
        out.append(
            f"lost measured rows: sidecar has {r['sidecar_rows']}, landed "
            f"line has {_rows_of(obj)}"
        )
    return out


def _check_serve_generic(r):
    # whatever the custom fault did, the landed serve artifact must be
    # schema-valid, which includes balanced request books and zero
    # expired-but-dispatched requests
    return inv.validate(r.get("artifact") or {}, "serve")


def _check_serve_pool_generic(r):
    # one tier up: the pool artifact's schema is the closed cross-process
    # book plus the hedging arithmetic
    return inv.validate(r.get("artifact") or {}, "serve_pool")


def _check_serve_fabric_generic(r):
    # one tier further out: the closed client-tier book plus the
    # replication, cache and hedge rules
    return inv.validate(r.get("artifact") or {}, "serve_fabric")


def _check_replay_generic(r):
    # the closed tick ledger, the closed serve book and the version
    # reconciliation
    return inv.validate(r.get("artifact") or {}, "replay")


_CUSTOM_CHECKS = {
    "mini": _check_custom_generic,
    "bench-child": _check_custom_generic,
    "bench": _check_bench_supervisor_landed,
    "warmup": _check_warmup_healed,
    "serve": _check_serve_generic,
    "serve-pool": _check_serve_pool_generic,
    "serve-fabric": _check_serve_fabric_generic,
    "replay": _check_replay_generic,
}


def _lint_gate() -> list:
    """The unsuppressed findings of the port's whole-project lint sweep
    (``lint --project``); :func:`cmd_rehearse` refuses to start on any."""
    from csmom_tpu_torch.analysis import run_lint

    return run_lint(project=True).findings


def _card_missing(matrix, device: str) -> bool:
    """True when the matrix holds a scenario that runs on ``cuda`` and
    no card is there."""
    if device != "cuda" or not any(s.pipeline in _DEVICE_PIPELINES
                                   for s in matrix):
        return False
    import torch

    return not torch.cuda.is_available()


def _select(matrix, only) -> list:
    """The scenarios ``--only`` names: for each value, the scenario of
    that whole name when there is one, else every scenario whose name
    contains it."""
    picked = set()
    names = {s.name for s in matrix}
    for sub in only:
        picked |= ({sub} if sub in names
                   else {s.name for s in matrix if sub in s.name})
    return [s for s in matrix if s.name in picked]


def cmd_rehearse(args) -> int:
    """Rehearse the capture pipeline and the serving tiers under
    deterministic fault injection."""
    if getattr(args, "plan", None):
        if args.pipeline not in _CUSTOM_CHECKS:
            print(
                f"--pipeline {args.pipeline} does not take a custom plan "
                "(its faults are CSMOM_FAULT_* env-var driven, not "
                "checkpoint-based); use one of "
                f"{', '.join(sorted(_CUSTOM_CHECKS))}",
                file=sys.stderr,
            )
            return 2
        plan = FaultPlan.from_env_value(args.plan)
        custom_plan = True
        matrix = [Scenario(
            plan.name or "custom-plan", args.pipeline, plan,
            _CUSTOM_CHECKS[args.pipeline],
            notes="custom plan (generic invariants: a schema-valid line "
                  "lands, full or explicitly partial, zero lost rows)",
        )]
    else:
        custom_plan = False
        matrix = builtin_matrix(fast=args.fast)
    if getattr(args, "only", None):
        matrix = _select(matrix, args.only)
        if not matrix:
            print(f"no scenario matches --only "
                  f"{' '.join(repr(o) for o in args.only)}",
                  file=sys.stderr)
            return 2
    if getattr(args, "list", False):
        # the scenario matrix, runnable nothing: name, pipeline, tier,
        # the armed plan's fault summary, and the intent line
        for s in matrix:
            tier = "fast" if s.fast else "full"
            print(f"{s.name:32s} {s.pipeline:12s} [{tier}] {s.notes}")
            print(f"{'':32s} {'':12s}        plan: {_plan_summary(s.plan)}")
        return 0
    if _card_missing(matrix, args.device):
        print("error: no CUDA device is available for the bench and "
              "warm-up scenarios; pass --device cpu to run them on the "
              "plain PyTorch versions, or leave them out (--fast, --only)",
              file=sys.stderr)
        return 2
    findings = _lint_gate()
    if findings:
        print(f"refusing to rehearse: `lint --project` reports "
              f"{len(findings)} finding(s) — a tree with findings is not "
              "rehearsed", file=sys.stderr)
        for f in findings[:20]:
            print(f"  {f}", file=sys.stderr)
        if len(findings) > 20:
            print(f"  ... and {len(findings) - 20} more "
                  "(run `python -m csmom_tpu_torch.cli lint --project`)",
                  file=sys.stderr)
        return 1

    sandbox_root = args.sandbox or tempfile.mkdtemp(prefix="csmom-rehearse-")
    os.makedirs(sandbox_root, exist_ok=True)
    print(f"rehearsing {len(matrix)} fault scenario(s) in {sandbox_root} "
          f"({'fast tier' if args.fast else 'full matrix'})\n")

    # the rehearsal is itself a telemetry run: each scenario is a row
    from csmom_tpu_torch import obs
    from csmom_tpu_torch.obs import metrics as obs_metrics
    from csmom_tpu_torch.obs import timeline as obs_tl

    # distinct run ids per flavor, so a custom-plan rehearsal never lands
    # over the built-in matrix's sidecar
    run_id = ("rehearse_custom" if custom_plan
              else "rehearse_fast" if args.fast else "rehearse")
    # an operator-armed run (env contract) carries a foreign run id, whose
    # existing sidecar is kept; our own default names overwrite freely
    operator_armed = os.environ.get(obs.spans.ENV_STREAM,
                                    "") not in ("", "0")
    col = obs.arm_policy(
        "rehearse",
        default_path=os.path.join(sandbox_root, "telemetry_events.jsonl"),
        run_id=run_id,
    )
    telemetry_on = col is not None
    if telemetry_on:
        run_id = col.run_id

    # both counters registered up front, so a green run snapshots an
    # explicit failures=0
    obs_metrics.counter("rehearse.scenarios")
    obs_metrics.counter("rehearse.failures")
    failures = 0
    with obs.span("rehearse.run", root=True, scenarios=len(matrix)):
        for scenario in matrix:
            with obs.span("rehearse.row", phase="row",
                          scenario=scenario.name,
                          pipeline=scenario.pipeline) as sp:
                result, violations, wall = _run_scenario(
                    scenario, sandbox_root, args.device)
                sp.set(ok=not violations)  # before the span record emits
            ok = not violations
            obs_metrics.counter("rehearse.scenarios").inc()
            if not ok:
                obs_metrics.counter("rehearse.failures").inc()
            failures += 0 if ok else 1
            status = "PASS" if ok else "FAIL"
            print(f"  [{status}] {scenario.name:32s} ({scenario.pipeline}, "
                  f"{wall:5.1f}s)")
            for line in result.get("report") or ():
                print(f"         {line}")
            for v in violations:
                print(f"         - {v}")
            if not ok and args.verbose and result.get("stderr"):
                print("         stderr tail:",
                      result["stderr"][-400:].replace("\n", "\n           "))

    if telemetry_on:
        # the sidecar lands in the scratch directory, never beside the
        # tree's files; `timeline` searches it
        out_dir = obs_tl.scratch_dir()
        sidecar = obs_tl.finish_and_write(
            out_dir,
            fallback_metrics=obs_metrics.snapshot(),
            overwrite=not operator_armed,
        )
        loc = (os.path.join(out_dir, sidecar)
               if sidecar.endswith(".json") else sidecar)
        print(f"\ntelemetry: {loc} (render with `python -m "
              f"csmom_tpu_torch.cli timeline {run_id}`)")

    print(f"\n{len(matrix) - failures}/{len(matrix)} scenarios green")
    if failures:
        print("rehearsal FAILED: a rehearsed fault broke an invariant of "
              "its pipeline", file=sys.stderr)
    if not args.keep and not args.sandbox and not failures:
        shutil.rmtree(sandbox_root, ignore_errors=True)
    elif failures:
        print(f"sandbox kept for inspection: {sandbox_root}")
    return 1 if failures else 0


def register(sub) -> None:
    """Attach the ``rehearse`` subparser (called from cli.main)."""
    sp = sub.add_parser(
        "rehearse",
        help="rehearse the capture pipeline and the serving tiers under "
             "deterministic fault injection",
    )
    sp.add_argument("--fast", action="store_true",
                    help="the 16 fast scenarios (mini, shell, serve, "
                         "serve-pool, replay): no card needed")
    sp.add_argument("--plan", metavar="TOML",
                    help="run a custom fault plan (path or inline TOML) "
                         "instead of the built-in matrix")
    sp.add_argument("--pipeline", default="mini",
                    choices=sorted(_RUNNERS),
                    help="pipeline a custom --plan drives (default mini)")
    sp.add_argument("--only", metavar="SUBSTR", action="append",
                    help="run only matrix scenarios whose name contains "
                         "SUBSTR (a whole scenario name selects that one "
                         "alone); may be repeated")
    sp.add_argument("--list", action="store_true",
                    help="print the scenario matrix without running it")
    sp.add_argument("--sandbox", metavar="DIR",
                    help="run in DIR instead of a fresh tmpdir (kept)")
    sp.add_argument("--keep", action="store_true",
                    help="keep the sandbox even when green")
    sp.add_argument("--verbose", action="store_true",
                    help="print stderr tails of failing scenarios")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the bench and warm-up scenarios' device (default "
                         "cuda; without a card a matrix holding one exits 2: "
                         "pass --device cpu to run the plain PyTorch "
                         "versions); the other scenarios touch no device")
    sp.set_defaults(fn=cmd_rehearse)
