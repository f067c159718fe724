"""The serving artifacts' contracts: closed books, ordered percentiles.

Counterpart of ``csmom_tpu.chaos.invariants`` for the three artifact
kinds the port lands, all written by :mod:`csmom_tpu_torch.serve.loadgen`.

``serve_fabric`` (``GPU_SERVE_FABRIC_<run>.json``, schema v1, the
reference's rules copied): closed client-tier books, an availability, a
pool-level cache hit rate and a hedge rate that reconcile with them, no
stale cache hit anywhere in the fleet, at least two router replicas,
ordered total-latency percentiles and each tier's per-process records
and counters.

``serve_pool`` (``GPU_SERVE_POOL_<run>.json``, schema v1, the
reference's rules copied): request books that close across the process
boundary, hedge arithmetic (``hedge_wins`` and ``duplicates_suppressed``
at most ``hedged``), an availability and a hedge rate that reconcile
with the books, ordered total-latency percentiles, the fleet's counters
and per-worker records.

``serve`` (``GPU_SERVE_<run>.json``), with the reference's rules
copied: schema versions 1-4, the record-shaped headline, balanced
request books (``served + rejected + expired == admitted`` and
``expired_dispatched == 0``), non-decreasing percentiles, a batch
histogram that sums to the batch count, per-class and per-endpoint
books that close and sum to the global book, a cache book with zero
stale hits and a reconciling hit rate, the offered-load record, the
per-class error-budget burn and the latency samples.  The endpoint names
are checked against the port's registry.

Validators return a list of violation strings (empty = valid), so a
caller reports every breakage of an artifact, not the first.
"""

from __future__ import annotations

import json

__all__ = ["KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS",
           "KNOWN_SERVE_POOL_SCHEMA_VERSIONS", "KNOWN_SERVE_SCHEMA_VERSIONS",
           "detect_kind", "validate", "validate_file"]

KNOWN_SERVE_SCHEMA_VERSIONS = (1, 2, 3, 4)
KNOWN_SERVE_POOL_SCHEMA_VERSIONS = (1,)
KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS = (1,)

_NUM = (int, float)


def detect_kind(obj: dict) -> str | None:
    """``"serve_fabric"``, ``"serve_pool"`` or ``"serve"`` by the
    artifact's ``kind`` or key signature (the fabric's requests/
    availability/routers/transport, the pool's requests/availability/
    hedge, the service's requests/latency_ms/batches), else None.  The
    reference's order: each kind carries the next one's signature plus
    its own, so the fabric is tested before the pool and the pool before
    the service."""
    if not isinstance(obj, dict):
        return None
    if obj.get("kind") == "serve_fabric" or {"requests", "availability",
                                             "routers",
                                             "transport"} <= set(obj):
        return "serve_fabric"
    if obj.get("kind") == "serve_pool" or {"requests", "availability",
                                           "hedge"} <= set(obj):
        return "serve_pool"
    if obj.get("kind") == "serve" or {"requests", "latency_ms",
                                      "batches"} <= set(obj):
        return "serve"
    return None


def _require(obj, key, types, kind, out, type_name=None):
    if key not in obj:
        out.append(f"{kind}: missing required key {key!r}")
        return None
    v = obj[key]
    if not isinstance(v, types) or isinstance(v, bool) and bool not in (
            types if isinstance(types, tuple) else (types,)):
        out.append(
            f"{kind}: {key!r} must be {type_name or types}, got "
            f"{type(v).__name__}"
        )
        return None
    return v


def _validate_record(obj: dict, kind: str = "record") -> list:
    out: list = []
    _require(obj, "metric", str, kind, out)
    _require(obj, "value", _NUM, kind, out, "a number")
    _require(obj, "unit", str, kind, out)
    _require(obj, "vs_baseline", _NUM, kind, out, "a number")
    extra = obj.get("extra")
    if extra is not None and not isinstance(extra, dict):
        out.append(f"{kind}: extra must be a dict when present")
        extra = None
    if isinstance(extra, dict):
        p = extra.get("partial")
        if p is not None and (not isinstance(p, str) or not p.strip()):
            out.append(
                f"{kind}: extra.partial must be a non-empty string saying "
                "what is missing"
            )
        for k in ("rows", "phases"):
            if k in extra and not isinstance(extra[k], list):
                out.append(f"{kind}: extra.{k} must be a list")
        samples = extra.get("samples")
        if samples is not None:
            # raw per-rep samples, keyed by the
            # matching aggregate field, every sample a number — a string
            # smuggled into a sample list would poison the bootstrap
            if not isinstance(samples, dict):
                out.append(f"{kind}: extra.samples must be a dict of "
                           "leg -> list of raw per-rep numbers")
            else:
                for leg, vals in samples.items():
                    if (not isinstance(vals, list)
                            or not all(isinstance(v, _NUM)
                                       and not isinstance(v, bool)
                                       for v in vals)):
                        out.append(f"{kind}: extra.samples[{leg!r}] must "
                                   "be a list of numbers")
    for k in ("rows", "phases"):
        if k in obj and not isinstance(obj[k], list):
            out.append(f"{kind}: {k} must be a list")
    p = obj.get("partial")
    if p is not None and (not isinstance(p, str) or not p.strip()):
        out.append(f"{kind}: partial must be a non-empty string")
    return out


def _validate_serve_requests(req: dict, kind: str, out: list) -> dict | None:
    """The single-process balanced-request-book rule."""
    for k in ("admitted", "served", "rejected", "expired",
              "expired_dispatched"):
        v = req.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            out.append(f"{kind}: requests.{k} must be a non-negative int "
                       "(the accounting is the contract)")
            return None
    total = req["served"] + req["rejected"] + req["expired"]
    if total != req["admitted"]:
        out.append(
            f"{kind}: request accounting broken — served {req['served']} "
            f"+ rejected {req['rejected']} + expired {req['expired']} = "
            f"{total} != admitted {req['admitted']} (a request was "
            "dropped or double-counted)")
    if req["expired_dispatched"] != 0:
        out.append(
            f"{kind}: expired_dispatched = {req['expired_dispatched']} — "
            "a request that expired while queued must be cancelled, "
            "never dispatched")
    return req


def _validate_latency_side(side, leg: str, kind: str, out: list) -> None:
    """Shared percentile rules: numbers-or-null, non-decreasing."""
    if not isinstance(side, dict):
        out.append(f"{kind}: latency_ms.{leg} must be a dict of "
                   "p50/p95/p99")
        return
    vals = []
    for q in ("p50", "p95", "p99"):
        v = side.get(q)
        if v is None:
            continue
        if not isinstance(v, _NUM) or isinstance(v, bool):
            out.append(f"{kind}: latency_ms.{leg}.{q} must be a number "
                       "(milliseconds) or null")
        else:
            vals.append(v)
    if vals != sorted(vals):
        out.append(f"{kind}: latency_ms.{leg} percentiles must be "
                   "non-decreasing (p50 <= p95 <= p99)")


def _validate_serve(obj: dict) -> list:
    """The serve artifact contract: balanced request books, ordered
    percentiles, consistent batch histogram, a known schema era."""
    out: list = []
    _require(obj, "run_id", str, "serve", out)
    ver = _require(obj, "schema_version", int, "serve", out)
    if ver is not None and ver not in KNOWN_SERVE_SCHEMA_VERSIONS:
        out.append(
            f"serve: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_SERVE_SCHEMA_VERSIONS)}) — the "
            "artifact is from a different era of the code; do not "
            "half-parse it"
        )
    _require(obj, "wall_s", _NUM, "serve", out, "a number")
    # the headline is record-shaped (metric/value/unit/vs_baseline), so
    # the record rules apply verbatim
    out += _validate_record(obj, kind="serve")

    req = _require(obj, "requests", dict, "serve", out)
    served = 0
    if req is not None:
        req = _validate_serve_requests(req, "serve", out)
        if req is not None:
            served = req["served"]

    lat = _require(obj, "latency_ms", dict, "serve", out)
    if lat is not None:
        for leg in ("queue", "service", "total"):
            side = lat.get(leg)
            if not isinstance(side, dict):
                out.append(f"serve: latency_ms.{leg} must be a dict of "
                           "p50/p95/p99")
                continue
            vals = []
            for q in ("p50", "p95", "p99"):
                v = side.get(q)
                if v is None:
                    # legal only when nothing was observed on that leg
                    if leg != "queue" and served:
                        out.append(f"serve: latency_ms.{leg}.{q} is null "
                                   "but requests were served — the "
                                   "latency was measured, record it")
                    continue
                if not isinstance(v, _NUM) or isinstance(v, bool):
                    out.append(f"serve: latency_ms.{leg}.{q} must be a "
                               "number (milliseconds) or null")
                else:
                    vals.append(v)
            if vals != sorted(vals):
                out.append(f"serve: latency_ms.{leg} percentiles must be "
                           "non-decreasing (p50 <= p95 <= p99)")

    batches = _require(obj, "batches", dict, "serve", out)
    if batches is not None:
        count = batches.get("count")
        hist = batches.get("size_hist")
        if not isinstance(count, int) or isinstance(count, bool):
            out.append("serve: batches.count must be an int")
        elif not isinstance(hist, dict):
            out.append("serve: batches.size_hist must be a dict of "
                       "batch-size -> count")
        else:
            bad = [k for k, v in hist.items()
                   if not (isinstance(v, int) and not isinstance(v, bool))
                   or not str(k).isdigit()]
            if bad:
                out.append(f"serve: batches.size_hist has non-int-keyed or "
                           f"non-int-valued entries: {bad}")
            elif sum(hist.values()) != count:
                out.append(
                    f"serve: batches.size_hist sums to "
                    f"{sum(hist.values())} but batches.count is {count} — "
                    "a dispatched batch is missing from the histogram"
                )
    comp = obj.get("compile")
    if comp is not None and not isinstance(comp, dict):
        out.append("serve: compile must be a dict when present")
    elif isinstance(comp, dict):
        fc = comp.get("in_window_fresh_compiles")
        if fc is not None and not isinstance(fc, (int, str)):
            out.append("serve: compile.in_window_fresh_compiles must be "
                       "an int count or a reason string")
    if isinstance(ver, int) and ver >= 2:
        out += _validate_serve_v2(obj, req)
    if isinstance(ver, int) and ver >= 3:
        out += _validate_serve_v3(obj, req)
    if isinstance(ver, int) and ver >= 4:
        out += _validate_serve_v4(obj)
    return out


def _validate_serve_v2(obj: dict, req: dict | None) -> list:
    """The v2 additions: closed PER-CLASS books that sum to the
    global book, a cache book with zero stale hits and a reconciling
    hit rate, and an offered-load record carrying ``offered_rps`` so an
    offered-load-limited headline can never be misread as a saturation
    ceiling."""
    out: list = []
    classes = _require(obj, "classes", dict, "serve", out)
    if isinstance(classes, dict):
        if not classes:
            out.append("serve: classes must name at least one SLO class")
        sums = dict.fromkeys(("admitted", "served", "rejected",
                              "expired"), 0)
        broken = False
        for name, book in classes.items():
            if not isinstance(book, dict):
                out.append(f"serve: classes[{name!r}] must be a dict")
                broken = True
                continue
            for k in ("admitted", "served", "rejected", "expired",
                      "rejected_quota"):
                v = book.get(k)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    out.append(f"serve: classes[{name!r}].{k} must be a "
                               "non-negative int (the per-class book is "
                               "the contract)")
                    broken = True
                    break
            else:
                total = book["served"] + book["rejected"] + book["expired"]
                if total != book["admitted"]:
                    out.append(
                        f"serve: class {name!r} book broken — served "
                        f"{book['served']} + rejected {book['rejected']} + "
                        f"expired {book['expired']} = {total} != admitted "
                        f"{book['admitted']}")
                for k in sums:
                    sums[k] += book[k]
        if not broken and req is not None:
            for k, csum in sums.items():
                if csum != req[k]:
                    out.append(
                        f"serve: class books do not sum to the global "
                        f"book — sum({k}) = {csum} != requests.{k} "
                        f"{req[k]} (a request escaped its class ledger)")
    cache = _require(obj, "cache", dict, "serve", out)
    if isinstance(cache, dict) and cache.get("enabled", True):
        ok = True
        for k in ("hits", "misses", "stale_blocked", "stale_hits",
                  "lookups", "inserts", "evictions"):
            v = cache.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve: cache.{k} must be a non-negative int")
                ok = False
        if ok:
            if cache["stale_hits"] != 0:
                out.append(
                    f"serve: cache.stale_hits = {cache['stale_hits']} — a "
                    "result computed from a panel version the floor has "
                    "passed was SERVED; stale cache hits are invalid "
                    "evidence, full stop")
            want = (cache["hits"] + cache["misses"]
                    + cache["stale_blocked"])
            if cache["lookups"] != want:
                out.append(
                    f"serve: cache.lookups {cache['lookups']} != hits + "
                    f"misses + stale_blocked = {want}")
            hr = cache.get("hit_rate")
            if not isinstance(hr, _NUM) or isinstance(hr, bool):
                out.append("serve: cache.hit_rate must be a number")
            elif not 0.0 <= hr <= 1.0:
                out.append(f"serve: cache.hit_rate {hr} outside [0, 1]")
            elif cache["lookups"] and abs(
                    hr - cache["hits"] / cache["lookups"]) > 1e-3:
                out.append(
                    f"serve: cache.hit_rate {hr} does not reconcile with "
                    f"hits/lookups = "
                    f"{cache['hits'] / cache['lookups']:.4f}")
    offered = _require(obj, "offered", dict, "serve", out)
    if isinstance(offered, dict):
        orps = offered.get("offered_rps")
        if not isinstance(orps, _NUM) or isinstance(orps, bool) \
                or orps < 0:
            out.append("serve: offered.offered_rps must be a non-negative "
                       "number (the achieved-vs-offered distinction)")
        if not isinstance(offered.get("schedule_kind"), str):
            out.append("serve: offered.schedule_kind must be a string "
                       "(bursty/diurnal/adversarial/custom)")
    if not isinstance(obj.get("offered_limited"), bool):
        out.append("serve: offered_limited must be a bool (did the run "
                   "measure the load or the ceiling?)")
    return out


def _registered_serve_endpoints() -> tuple:
    """The port's live endpoint registry (the v3 ground truth), imported
    lazily: validators that never see a v3 artifact need no registry."""
    from csmom_tpu_torch.registry import serve_endpoints

    return serve_endpoints()


def _validate_serve_v3(obj: dict, req: dict | None) -> list:
    """The v3 additions: per-ENDPOINT books that close and sum to the
    global book, with the endpoint name set validated against the
    validating process's live engine registry (an artifact of an
    endpoint registered at run time validates only in a process that
    registers it too)."""
    out: list = []
    registered = _registered_serve_endpoints()
    eps = _require(obj, "endpoints", dict, "serve", out)
    if isinstance(eps, dict):
        if not eps:
            out.append("serve: endpoints must name at least one endpoint "
                       "(the per-endpoint book is v3's contract)")
        served_sum = 0
        broken = False
        for name, book in eps.items():
            if name not in registered:
                out.append(
                    f"serve: endpoints[{name!r}] is not a registered "
                    f"engine (registry: {list(registered)}) — the "
                    "artifact's endpoint set must come from the "
                    "registry, not a literal")
                broken = True
                continue
            if not isinstance(book, dict):
                out.append(f"serve: endpoints[{name!r}] must be a dict")
                broken = True
                continue
            for k in ("submitted", "served", "rejected", "expired"):
                v = book.get(k)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    out.append(f"serve: endpoints[{name!r}].{k} must be a "
                               "non-negative int")
                    broken = True
                    break
            else:
                total = (book["served"] + book["rejected"]
                         + book["expired"])
                if total != book["submitted"]:
                    out.append(
                        f"serve: endpoint {name!r} book broken — served "
                        f"{book['served']} + rejected {book['rejected']} "
                        f"+ expired {book['expired']} = {total} != "
                        f"submitted {book['submitted']}")
                served_sum += book["served"]
                _validate_latency_side(book.get("latency_ms"),
                                       f"endpoints.{name}", "serve", out)
        if not broken and req is not None and served_sum != req["served"]:
            out.append(
                f"serve: endpoint books do not sum to the global book — "
                f"sum(served) = {served_sum} != requests.served "
                f"{req['served']} (a request escaped its endpoint "
                "ledger)")
    kinds = (obj.get("offered") or {}).get("kinds")
    if isinstance(kinds, list):
        rogue = [k for k in kinds if k not in registered]
        if rogue:
            out.append(
                f"serve: offered.kinds contains unregistered endpoints "
                f"{rogue} (registry: {list(registered)})")
    return out


def _validate_serve_v4(obj: dict) -> list:
    """The v4 additions: per-class SLO error-budget burn accounting
    (``violations``/``budget_burn`` in every class book) and bounded
    per-request latency samples in ``extra.samples``."""
    out: list = []
    classes = obj.get("classes")
    if isinstance(classes, dict):
        for name, book in classes.items():
            if not isinstance(book, dict):
                continue  # already reported by the v2 rules
            v = book.get("violations")
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve: classes[{name!r}].violations must be "
                           "a non-negative int (v4 burn accounting)")
            elif isinstance(book.get("served"), int) and v > book["served"]:
                out.append(f"serve: classes[{name!r}].violations {v} > "
                           f"served {book['served']}")
            burn = book.get("budget_burn")
            if burn is not None and (not isinstance(burn, _NUM)
                                     or isinstance(burn, bool)
                                     or burn < 0):
                out.append(f"serve: classes[{name!r}].budget_burn must "
                           "be a non-negative number or null")
            if (burn is None and isinstance(book.get("served"), int)
                    and book["served"] > 0
                    and book.get("budget_ms") is not None):
                out.append(f"serve: classes[{name!r}] served requests "
                           "against a budget but budget_burn is null — "
                           "the burn was computable, record it")
    samples = (obj.get("extra") or {}).get("samples")
    if not isinstance(samples, dict) or "serve_total_ms" not in samples:
        out.append("serve: v4 artifacts must carry extra.samples with a "
                   "serve_total_ms list (the bootstrap-CI backing for "
                   "the p99 gate rows)")
    req = obj.get("requests")
    if (isinstance(samples, dict)
            and isinstance(samples.get("serve_total_ms"), list)
            and isinstance(req, dict)
            and isinstance(req.get("served"), int)):
        n = len(samples["serve_total_ms"])
        if req["served"] and not n:
            out.append("serve: requests were served but "
                       "extra.samples.serve_total_ms is empty — the "
                       "latencies were measured, persist them")
    return out


def _validate_serve_pool(obj: dict) -> list:
    """The pool artifact contract: the closed request book ACROSS the
    process boundary, exactly-once hedging arithmetic, and an
    availability figure that reconciles with its own counters."""
    out: list = []
    _require(obj, "run_id", str, "serve_pool", out)
    ver = _require(obj, "schema_version", int, "serve_pool", out)
    if ver is not None and ver not in KNOWN_SERVE_POOL_SCHEMA_VERSIONS:
        out.append(
            f"serve_pool: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_SERVE_POOL_SCHEMA_VERSIONS)}) — the "
            "artifact is from a different era of the code; do not "
            "half-parse it"
        )
    _require(obj, "wall_s", _NUM, "serve_pool", out, "a number")
    out += _validate_record(obj, kind="serve_pool")

    req = _require(obj, "requests", dict, "serve_pool", out)
    if req is not None:
        for k in ("admitted", "served", "rejected", "expired",
                  "rejected_infra", "hedged", "hedge_wins",
                  "duplicates_suppressed"):
            v = req.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve_pool: requests.{k} must be a "
                           "non-negative int (the accounting is the "
                           "contract)")
                req = None
                break
    if req is not None:
        total = req["served"] + req["rejected"] + req["expired"]
        if total != req["admitted"]:
            out.append(
                f"serve_pool: request accounting broken across the "
                f"process boundary — served {req['served']} + rejected "
                f"{req['rejected']} + expired {req['expired']} = {total} "
                f"!= admitted {req['admitted']} (a request was dropped "
                "or double-counted between router and workers)"
            )
        if req["rejected_infra"] > req["rejected"]:
            out.append("serve_pool: rejected_infra exceeds rejected")
        if req["hedge_wins"] > req["hedged"]:
            out.append(
                f"serve_pool: hedge_wins {req['hedge_wins']} > hedged "
                f"{req['hedged']}")
        if req["duplicates_suppressed"] > req["hedged"]:
            out.append(
                f"serve_pool: duplicates_suppressed "
                f"{req['duplicates_suppressed']} > hedged {req['hedged']}"
                " — a duplicate terminal without a hedge means "
                "exactly-once broke"
            )

    avail = _require(obj, "availability", _NUM, "serve_pool", out,
                     "a number")
    if isinstance(avail, _NUM) and not isinstance(avail, bool):
        if not 0.0 <= avail <= 1.0:
            out.append(f"serve_pool: availability {avail} outside [0, 1]")
        elif req is not None and req["admitted"]:
            want = 1.0 - req["rejected_infra"] / req["admitted"]
            if abs(avail - want) > 1e-4:
                out.append(
                    f"serve_pool: availability {avail} does not reconcile "
                    f"with 1 - rejected_infra/admitted = {want:.6f} — the "
                    "headline must be computable from the books"
                )

    hedge = _require(obj, "hedge", dict, "serve_pool", out)
    if hedge is not None and req is not None and req["admitted"]:
        rate = hedge.get("rate")
        if not isinstance(rate, _NUM) or isinstance(rate, bool):
            out.append("serve_pool: hedge.rate must be a number")
        elif abs(rate - req["hedged"] / req["admitted"]) > 1e-3:
            out.append(
                f"serve_pool: hedge.rate {rate} does not reconcile with "
                f"hedged/admitted = {req['hedged'] / req['admitted']:.4f}"
            )

    lat = _require(obj, "latency_ms", dict, "serve_pool", out)
    if lat is not None:
        _validate_latency_side(lat.get("total"), "total", "serve_pool", out)

    pool = _require(obj, "pool", dict, "serve_pool", out)
    if pool is not None:
        for k in ("n_workers", "kills", "restarts"):
            v = pool.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve_pool: pool.{k} must be a non-negative "
                           "int")
        if "events" in pool and not isinstance(pool["events"], list):
            out.append("serve_pool: pool.events must be a list")

    workers = _require(obj, "workers", list, "serve_pool", out)
    if workers is not None:
        for i, w in enumerate(workers):
            if not isinstance(w, dict) or not isinstance(
                    w.get("worker_id"), str):
                out.append(f"serve_pool: workers[{i}] must be a dict with "
                           "a worker_id")
    comp = obj.get("compile")
    if comp is not None and not isinstance(comp, dict):
        out.append("serve_pool: compile must be a dict when present")
    elif isinstance(comp, dict):
        fc = comp.get("in_window_fresh_compiles")
        if fc is not None and not isinstance(fc, (int, str)):
            out.append("serve_pool: compile.in_window_fresh_compiles must "
                       "be an int count or a reason string")
    return out


def _validate_serve_fabric(obj: dict) -> list:
    """The three-tier fabric contract: closed CLIENT-tier
    books (the outermost ledger — the one a SIGKILLed router replica
    cannot take with it), availability reconciling with its own infra
    counter, a pool-level cache book whose hit rate reconciles with the
    client's cache-hit count and whose fleet-aggregated ``stale_hits``
    is structurally zero across rebalances, hedge arithmetic, and at
    least TWO router replicas (replication is the kind's point)."""
    out: list = []
    _require(obj, "run_id", str, "serve_fabric", out)
    ver = _require(obj, "schema_version", int, "serve_fabric", out)
    if ver is not None and ver not in KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS:
        out.append(
            f"serve_fabric: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS)}) — "
            "the artifact is from a different era of the code; do not "
            "half-parse it")
    _require(obj, "wall_s", _NUM, "serve_fabric", out, "a number")
    out += _validate_record(obj, kind="serve_fabric")

    trans = _require(obj, "transport", dict, "serve_fabric", out)
    if isinstance(trans, dict):
        if trans.get("scheme") not in ("unix", "tcp"):
            out.append(f"serve_fabric: transport.scheme "
                       f"{trans.get('scheme')!r} must be 'unix' or 'tcp'")
        nr = trans.get("routers")
        if not isinstance(nr, int) or isinstance(nr, bool) or nr < 2:
            out.append(f"serve_fabric: transport.routers {nr!r} — the "
                       "fabric requires >= 2 router replicas (one "
                       "router is the r11 pool, not a fabric)")
        nw = trans.get("workers")
        if not isinstance(nw, int) or isinstance(nw, bool) or nw < 1:
            out.append(f"serve_fabric: transport.workers must be a "
                       f"positive int, got {nw!r}")

    req = _require(obj, "requests", dict, "serve_fabric", out)
    if isinstance(req, dict):
        counters = ("admitted", "served", "rejected", "expired",
                    "rejected_infra", "served_cache_hits",
                    "served_hedged", "router_conn_failures", "failovers")
        ok = True
        for k in counters:
            v = req.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve_fabric: requests.{k} must be a "
                           "non-negative int (the client-tier ledger is "
                           "the contract)")
                ok = False
        if not ok:
            # malformed counters: the availability/cache/hedge reconcile
            # blocks below divide by these values — a violation must stay
            # a violation, not become a TypeError out of validate()
            req = None
        else:
            total = req["served"] + req["rejected"] + req["expired"]
            if total != req["admitted"]:
                out.append(
                    f"serve_fabric: client books broken — served "
                    f"{req['served']} + rejected {req['rejected']} + "
                    f"expired {req['expired']} = {total} != admitted "
                    f"{req['admitted']} (a request died with a replica)")
            if req["rejected_infra"] > req["rejected"]:
                out.append("serve_fabric: rejected_infra exceeds rejected")
            if req["served_cache_hits"] > req["served"]:
                out.append("serve_fabric: served_cache_hits exceeds served")
            if req["served_hedged"] > req["served"]:
                out.append("serve_fabric: served_hedged exceeds served")

    avail = _require(obj, "availability", _NUM, "serve_fabric", out,
                     "a number")
    if isinstance(avail, _NUM) and not isinstance(avail, bool):
        if not 0.0 <= avail <= 1.0:
            out.append(f"serve_fabric: availability {avail} outside [0, 1]")
        elif isinstance(req, dict) and req.get("admitted"):
            want = round(1.0 - req.get("rejected_infra", 0)
                         / req["admitted"], 6)
            if abs(avail - want) > 1e-6:
                out.append(
                    f"serve_fabric: availability {avail} does not "
                    f"reconcile with 1 - rejected_infra/admitted = {want}")

    cache = _require(obj, "cache", dict, "serve_fabric", out)
    if isinstance(cache, dict):
        hr = cache.get("pool_hit_rate")
        if not isinstance(hr, _NUM) or isinstance(hr, bool) \
                or not 0.0 <= hr <= 1.0:
            out.append(f"serve_fabric: cache.pool_hit_rate {hr!r} must "
                       "be a number in [0, 1]")
        elif isinstance(req, dict) and req.get("served"):
            want = round(req.get("served_cache_hits", 0)
                         / req["served"], 4)
            if abs(hr - want) > 1e-4:
                out.append(
                    f"serve_fabric: cache.pool_hit_rate {hr} does not "
                    f"reconcile with served_cache_hits/served = {want}")
        wagg = cache.get("workers")
        if not isinstance(wagg, dict):
            out.append("serve_fabric: cache.workers (the fleet-aggregated "
                       "worker cache book) must be a dict")
        else:
            sh = wagg.get("stale_hits")
            if not isinstance(sh, int) or isinstance(sh, bool):
                out.append("serve_fabric: cache.workers.stale_hits must "
                           "be an int")
            elif sh != 0:
                out.append(
                    f"serve_fabric: cache.workers.stale_hits = {sh} — a "
                    "STALE entry was returned somewhere in the fleet; "
                    "the version floor must make this structurally "
                    "impossible, rebalances included")

    hedge = _require(obj, "hedge", dict, "serve_fabric", out)
    if isinstance(hedge, dict):
        rate = hedge.get("rate")
        if not isinstance(rate, _NUM) or isinstance(rate, bool):
            out.append("serve_fabric: hedge.rate must be a number")
        elif isinstance(req, dict) and req.get("admitted"):
            want = round(req.get("served_hedged", 0)
                         / max(1, req["admitted"]), 4)
            if abs(rate - want) > 1e-4:
                out.append(
                    f"serve_fabric: hedge.rate {rate} does not reconcile "
                    f"with served_hedged/admitted = {want}")
        rt = hedge.get("router_tier")
        if isinstance(rt, dict):
            if isinstance(rt.get("wins"), int) and \
                    isinstance(rt.get("hedged"), int) and \
                    rt["wins"] > rt["hedged"]:
                out.append(
                    f"serve_fabric: router_tier hedge_wins {rt['wins']} "
                    f"> hedged {rt['hedged']} — a hedge cannot win more "
                    "than it fired")

    lat = _require(obj, "latency_ms", dict, "serve_fabric", out)
    if isinstance(lat, dict):
        _validate_latency_side(lat.get("total"), "total", "serve_fabric",
                               out)

    for tier, id_key in (("routers", "router_id"), ("workers", "worker_id")):
        block = _require(obj, tier, dict, "serve_fabric", out)
        if not isinstance(block, dict):
            continue
        rows = block.get("replicas" if tier == "routers" else "stats")
        if not isinstance(rows, list):
            out.append(f"serve_fabric: {tier} must carry its per-process "
                       "stats list")
        else:
            for i, r in enumerate(rows):
                if not isinstance(r, dict) or id_key not in r:
                    out.append(f"serve_fabric: {tier} row {i} must be a "
                               f"dict with a {id_key}")
        for k in ("kills", "restarts"):
            v = block.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"serve_fabric: {tier}.{k} must be a "
                           "non-negative int")

    comp = obj.get("compile")
    if comp is not None and not isinstance(comp, dict):
        out.append("serve_fabric: compile must be a dict when present")
    elif isinstance(comp, dict):
        fc = comp.get("in_window_fresh_compiles")
        if fc is not None and not isinstance(fc, (int, str)):
            out.append("serve_fabric: compile.in_window_fresh_compiles "
                       "must be an int count or a reason string")
    return out


def validate(obj, kind: str | None = None) -> list:
    """All contract violations of one serve, serve_pool or serve_fabric
    artifact (empty = valid)."""
    if not isinstance(obj, dict):
        return [f"artifact must be a JSON object, got {type(obj).__name__}"]
    kind = kind or detect_kind(obj)
    if kind is None:
        return ["unrecognized artifact shape: not a serve artifact (no "
                "kind 'serve', 'serve_pool' or 'serve_fabric', no "
                "requests/latency_ms/batches, requests/availability/hedge "
                "or requests/availability/routers/transport keys)"]
    if kind == "serve_fabric":
        return _validate_serve_fabric(obj)
    if kind == "serve_pool":
        return _validate_serve_pool(obj)
    if kind != "serve":
        return [f"unknown artifact kind {kind!r}: this validator checks "
                "serve, serve_pool and serve_fabric artifacts only"]
    return _validate_serve(obj)


def validate_file(path: str) -> list:
    """Violations of one artifact file (unreadable/unparseable included)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except OSError as e:
        return [f"unreadable: {e}"]
    except json.JSONDecodeError as e:
        return [f"not valid JSON: {e}"]
    return validate(obj)
