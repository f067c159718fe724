"""The serving artifacts' contracts: closed books, ordered percentiles.

Counterpart of ``csmom_tpu.chaos.invariants`` for the seven artifact
kinds the port lands, written by :mod:`csmom_tpu_torch.serve.loadgen`,
:mod:`csmom_tpu_torch.obs.fleet`, :mod:`csmom_tpu_torch.obs.trace`,
:mod:`csmom_tpu_torch.stream.replay` and
:mod:`csmom_tpu_torch.obs.timeline`, and the rules ``rehearse`` checks
with: :func:`trailing_json` (the last JSON-object line of a process's
stdout) and :func:`committable_sidecar` (which ``GPU_*`` file names are
round evidence and which are regenerated scratch).

``telemetry`` (``GPU_TELEMETRY_<run>.json``, schema v1, the reference's
rules copied): a known schema version, named phases without duplicates
whose durations account for the run's wall within 5% (floored at 0.02
s), and per-shape memory records with int byte counts and a platform.

``trace`` (``GPU_TRACE_<run>.json``, schema v1, the reference's rules
copied): closed trace books (every opened trace complete or partial with
a reason), reason-counted orphan halves, stage sums that reconcile with
each request wall within ``epsilon_ms``, slowest-k critical paths that
reconcile too, per-class burn arithmetic, and the books held to the
driven run's request book (``complete == served``, ``partial ==
rejected + expired``).

``replay`` (``GPU_REPLAY_<run>.json``, schema v1, the reference's rules
copied): the closed tick book (``applied + merged_late + quarantined +
deduped == offered == generated + duplicated - dropped_gap``), the
embedded serve book, ingest-vs-serve version reconciliation (no response
from a version ingest never issued; skew refusals equal the service's
``rejected_version_skew``), reconcile counters and ordered staleness
percentiles.

``fleet`` (``GPU_FLEET_<run>.json``, schema v1, the reference's rules
copied, its ``elastic`` block included): reason-closed stream books, no
orphan series, monotone counter series, demand that reconciles with its
per-second buckets and the embedded serve request book, capacity
arithmetic in bounds; spares held out of the lifecycle and kill-window
books, each promotion exactly once, every autoscaler decision reasoned,
applied quotas within their declared bounds.

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

``lint`` (``lint --format json``, schema v1-2) and ``record`` (a
metric/value headline), with the reference's rules copied.  The ledger
(:mod:`csmom_tpu_torch.obs.ledger`) also detects the capture tooling's
kinds, ``driver_capture``, ``multichip``, ``phases`` and ``tpu_cache``,
whose validators are not ported yet; it reads records with
:func:`is_partial`, and :func:`measured_rows` and :func:`upgrade_ok` are
the rule for landing a capture over one of the same name.

Validators return a list of violation strings (empty = valid), so a
caller reports every breakage of an artifact, not the first.
"""

from __future__ import annotations

import json
import re

__all__ = ["KNOWN_FLEET_SCHEMA_VERSIONS", "KNOWN_LINT_SCHEMA_VERSIONS",
           "KNOWN_REPLAY_SCHEMA_VERSIONS",
           "KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS",
           "KNOWN_SERVE_POOL_SCHEMA_VERSIONS", "KNOWN_SERVE_SCHEMA_VERSIONS",
           "KNOWN_TELEMETRY_SCHEMA_VERSIONS", "KNOWN_TRACE_SCHEMA_VERSIONS",
           "committable_sidecar", "detect_kind", "is_partial",
           "measured_rows", "trailing_json", "upgrade_ok", "validate",
           "validate_file", "validate_tree"]

KNOWN_TELEMETRY_SCHEMA_VERSIONS = (1,)
KNOWN_SERVE_SCHEMA_VERSIONS = (1, 2, 3, 4)
KNOWN_SERVE_POOL_SCHEMA_VERSIONS = (1,)
KNOWN_SERVE_FABRIC_SCHEMA_VERSIONS = (1,)
KNOWN_FLEET_SCHEMA_VERSIONS = (1,)
KNOWN_TRACE_SCHEMA_VERSIONS = (1,)
KNOWN_REPLAY_SCHEMA_VERSIONS = (1,)
KNOWN_LINT_SCHEMA_VERSIONS = (1, 2)
_LINT_V2_KEYS = frozenset({
    "schema_version", "ok", "files_scanned", "rules", "project",
    "findings", "suppressed", "cache", "rule_timings_s",
})
_LINT_FINDING_KEYS = frozenset({"rule", "path", "line", "message",
                                "chain"})

# only round artifacts are committed evidence: GPU_<family>_r<NN>.json.
# Rehearse, smoke and scratch files (GPU_TELEMETRY_rehearse_*,
# GPU_SERVE_smoke*, pid-suffixed reruns) are regenerated by every run and
# land in .csmom_scratch/ or a chip run's output, never in the tree
_REGENERATED_PREFIXES = ("GPU_TELEMETRY_", "GPU_SERVE_", "GPU_REPLAY_",
                         "GPU_TRACE_", "GPU_FLEET_")
_COMMITTED_SIDECAR_RE = re.compile(
    r"^GPU_(?:TELEMETRY|SERVE|SERVE_POOL|SERVE_MESH|SERVE_FABRIC|REPLAY"
    r"|TRACE|FLEET)_r\d+\.json$")

_NUM = (int, float)


def committable_sidecar(basename: str) -> bool:
    """True iff this ``GPU_*`` artifact file name may be committed (round
    artifacts only); other name families are not this rule's business."""
    if not basename.startswith(_REGENERATED_PREFIXES):
        return True
    return bool(_COMMITTED_SIDECAR_RE.match(basename))


def trailing_json(text: str):
    """The last line of ``text`` that parses as a JSON object, or None."""
    for line in reversed((text or "").strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def detect_kind(obj: dict) -> str | None:
    """``"fleet"``, ``"trace"``, ``"replay"``, ``"serve_fabric"``,
    ``"serve_pool"``, ``"serve"``, ``"telemetry"``, ``"lint"``,
    ``"tpu_cache"``, ``"multichip"``, ``"phases"``, ``"record"`` or
    ``"driver_capture"`` by the artifact's ``kind`` or key signature (the
    fleet's series/demand/capacity, the trace's books/stages/reconcile,
    the replay's ticks/panel/reconcile, the fabric's requests/
    availability/routers/transport, the pool's requests/availability/
    hedge, the service's requests/latency_ms/batches, the sidecar's
    run_id/wall_s/phases, the lint report's files_scanned/rules/findings,
    a session cache's captured_utc/record, a multichip check's
    n_devices/ok, a phases profile's phases/metric, a record's metric/
    value, a driver capture's rc/tail), else None.  The reference's
    order: the fleet and the trace embed a request book of their own,
    and each serve kind carries the next one's signature plus its own,
    so the fleet is tested first, the trace and the replay before the
    serve kinds, the fabric before the pool, the pool before the service
    and the service before the record; the ledger routes by these
    kinds."""
    if not isinstance(obj, dict):
        return None
    if obj.get("kind") == "fleet" or {"series", "demand",
                                      "capacity"} <= set(obj):
        return "fleet"
    if obj.get("kind") == "trace" or {"books", "stages",
                                      "reconcile"} <= set(obj):
        return "trace"
    if obj.get("kind") == "replay" or {"ticks", "panel",
                                       "reconcile"} <= set(obj):
        return "replay"
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
    if obj.get("kind") == "telemetry" or {"run_id", "wall_s",
                                          "phases"} <= set(obj):
        return "telemetry"
    if {"files_scanned", "rules", "findings"} <= set(obj):
        return "lint"
    if {"captured_utc", "record"} <= set(obj):
        return "tpu_cache"
    if {"n_devices", "ok"} <= set(obj):
        return "multichip"
    if "phases" in obj and "metric" in obj:
        return "phases"
    if {"metric", "value"} <= set(obj):
        return "record"
    if {"rc", "tail"} <= set(obj):
        return "driver_capture"
    return None


def measured_rows(obj: dict) -> int:
    """A capture's substance: the length of its measurement list
    (``rows`` or ``phases``, at the top or under ``extra``); listless
    records count 0."""
    if not isinstance(obj, dict):
        return 0
    for k in ("rows", "phases"):
        v = obj.get(k)
        if isinstance(v, list):
            return len(v)
        extra = obj.get("extra")
        if isinstance(extra, dict) and isinstance(extra.get(k), list):
            return len(extra[k])
    return 0


def is_partial(obj: dict) -> bool:
    """True when the record carries a ``partial`` marker, at the top or
    under ``extra``."""
    if not isinstance(obj, dict):
        return False
    extra = obj.get("extra")
    return bool(obj.get("partial")
                or (isinstance(extra, dict) and extra.get("partial")))


def upgrade_ok(old, new) -> list:
    """The monotone-upgrade rule for landing an artifact over one of the
    same name: full beats partial; a partial only replaces a partial with
    strictly more measured rows; nothing replaces a full.  Returns the
    violations of ``new`` landing over ``old``."""
    if old is None:
        return []
    if not is_partial(old):
        return ["landing over a FULL artifact: a full capture is never "
                "overwritten"]
    if is_partial(new) and measured_rows(new) <= measured_rows(old):
        return [
            f"partial-over-partial downgrade: new has {measured_rows(new)} "
            f"measured rows, existing partial has {measured_rows(old)}"
        ]
    return []


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


def _validate_fleet(obj: dict) -> list:
    """The fleet observatory contract (FLEET_*.json, obs/fleet.py):

    - CLOSED stream books: every process that ever streamed ends with a
      non-empty close reason (fin on clean drain, ``stream severed`` on
      SIGKILL) — a series that just stops without a reason is the r4
      silent-truncation failure wearing a new coat.
    - No orphan series: every ``points`` entry's proc has a process
      book (data from a process the aggregator never opened is forged
      or corrupted).
    - Counter series are MONOTONE: the aggregator reconstructs counters
      as ``cum += max(0, delta)``, so a decreasing counter series can
      only mean the artifact was edited after landing.
    - Demand reconciles three ways: per-second buckets sum to the class
      totals, ``admitted <= offered`` per class, and the run totals
      match the embedded serve request book — BY SCHEMA, not by eye.
    - Capacity account arithmetic: fractions in [0, 1], available never
      exceeds nominal, and every kill window's ready stamp is at or
      after its kill stamp."""
    out: list = []
    _require(obj, "run_id", str, "fleet", out)
    ver = _require(obj, "schema_version", int, "fleet", out)
    if ver is not None and ver not in KNOWN_FLEET_SCHEMA_VERSIONS:
        out.append(
            f"fleet: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_FLEET_SCHEMA_VERSIONS)}) — the "
            "artifact is from a different era of the code; do not "
            "half-parse it")
    _require(obj, "cadence_s", _NUM, "fleet", out, "a number")
    _require(obj, "window_s", _NUM, "fleet", out, "a number")
    out += _validate_record(obj, kind="fleet")

    series = _require(obj, "series", dict, "fleet", out)
    procs: dict = {}
    if isinstance(series, dict):
        books = series.get("books")
        if not isinstance(books, dict):
            out.append("fleet: series.books (the stream ledger) must be "
                       "a dict")
            books = {}
        for k in ("procs_opened", "procs_closed", "frames",
                  "frames_malformed", "seq_gaps",
                  "frames_dropped_by_emitters", "series_count",
                  "series_dropped"):
            v = books.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"fleet: series.books.{k} must be a "
                           "non-negative int")
        procs = series.get("processes")
        if not isinstance(procs, dict):
            out.append("fleet: series.processes must be a dict of "
                       "per-process stream books")
            procs = {}
        for name, book in procs.items():
            if not isinstance(book, dict):
                out.append(f"fleet: process book {name!r} must be a dict")
                continue
            if not book.get("closed") or not book.get("close_reason"):
                out.append(
                    f"fleet: process {name!r} stream is not reason-"
                    "closed — every series must end with fin or a "
                    "severed-stream reason, never silence (a SIGKILLed "
                    "emitter reads as a reason-closed gap, not "
                    "truncation)")
        if isinstance(books.get("procs_opened"), int) and \
                isinstance(books.get("procs_closed"), int) and \
                books["procs_opened"] != books["procs_closed"]:
            out.append(
                f"fleet: series books not closed — procs_opened "
                f"{books['procs_opened']} != procs_closed "
                f"{books['procs_closed']}")
        points = series.get("points")
        if not isinstance(points, dict):
            out.append("fleet: series.points must be a dict of series")
            points = {}
        for key, s in points.items():
            if not isinstance(s, dict):
                out.append(f"fleet: series point {key!r} must be a dict")
                continue
            if s.get("proc") not in procs:
                out.append(
                    f"fleet: orphan series {key!r} — proc "
                    f"{s.get('proc')!r} has no process book (data from "
                    "a stream the aggregator never opened)")
            ts, vs = s.get("t_s"), s.get("v")
            if not isinstance(ts, list) or not isinstance(vs, list) \
                    or len(ts) != len(vs):
                out.append(f"fleet: series {key!r} t_s/v must be "
                           "parallel lists")
                continue
            if s.get("kind") == "counter":
                for i in range(1, len(vs)):
                    if vs[i] < vs[i - 1]:
                        out.append(
                            f"fleet: counter series {key!r} decreases "
                            f"at index {i} ({vs[i - 1]} -> {vs[i]}) — "
                            "counters are monotone by construction "
                            "(cum += max(0, delta)); a decrease means "
                            "the artifact was edited after landing")
                        break

    req = obj.get("requests")
    if req is not None and not isinstance(req, dict):
        out.append("fleet: requests (the driven serve run's book) must "
                   "be a dict when present")
        req = None
    demand = _require(obj, "demand", dict, "fleet", out)
    if isinstance(demand, dict):
        classes = demand.get("classes")
        per_s = demand.get("per_second")
        if not isinstance(classes, dict):
            out.append("fleet: demand.classes must be a dict")
            classes = {}
        if not isinstance(per_s, list):
            out.append("fleet: demand.per_second must be a list")
            per_s = []
        bucket_sums: dict = {}
        for row in per_s:
            if not isinstance(row, dict):
                out.append("fleet: demand.per_second rows must be dicts")
                continue
            for cls, ev in row.items():
                if cls == "t_s" or not isinstance(ev, dict):
                    continue
                b = bucket_sums.setdefault(cls, {})
                for e, n in ev.items():
                    b[e] = b.get(e, 0) + (n if isinstance(n, int) else 0)
        for cls, tot in classes.items():
            if not isinstance(tot, dict):
                out.append(f"fleet: demand.classes[{cls!r}] must be a "
                           "dict")
                continue
            if bucket_sums.get(cls, {}) != tot:
                out.append(
                    f"fleet: demand per-second buckets for {cls!r} sum "
                    f"to {bucket_sums.get(cls, {})} but the class total "
                    f"says {tot} — the time series and the totals are "
                    "the same events; they cannot disagree")
            if tot.get("admitted", 0) > tot.get("offered", 0):
                out.append(f"fleet: demand class {cls!r} admitted "
                           f"{tot.get('admitted')} > offered "
                           f"{tot.get('offered')}")
        if isinstance(req, dict):
            for event, book_key in (("admitted", "admitted"),
                                    ("served", "served")):
                d_tot = sum(tot.get(event, 0)
                            for tot in classes.values()
                            if isinstance(tot, dict))
                want = req.get(book_key)
                if isinstance(want, int) and d_tot != want:
                    out.append(
                        f"fleet: unreconciled demand — {event} totals "
                        f"across classes = {d_tot} but the embedded "
                        f"serve book says requests.{book_key} = {want} "
                        "(demand telemetry and the request ledger "
                        "count the same run)")

    cap = _require(obj, "capacity", dict, "fleet", out)
    if isinstance(cap, dict):
        nom, avail = cap.get("nominal_worker_s"), cap.get(
            "available_worker_s")
        if isinstance(nom, _NUM) and isinstance(avail, _NUM) and \
                not isinstance(nom, bool) and not isinstance(avail, bool):
            if avail > nom + 1e-6:
                out.append(
                    f"fleet: capacity.available_worker_s {avail} > "
                    f"nominal_worker_s {nom} — a fleet cannot serve "
                    "more worker-seconds than it has slots")
        for k in ("kill_window_loss_frac", "steady_state_loss_frac"):
            v = cap.get(k)
            if not isinstance(v, _NUM) or isinstance(v, bool) \
                    or not 0.0 <= v <= 1.0:
                out.append(f"fleet: capacity.{k} {v!r} must be a number "
                           "in [0, 1]")
        kws = cap.get("kill_windows")
        if not isinstance(kws, list):
            out.append("fleet: capacity.kill_windows must be a list")
            kws = []
        for i, kw in enumerate(kws):
            if not isinstance(kw, dict):
                out.append(f"fleet: kill_windows[{i}] must be a dict")
                continue
            tk, tr = kw.get("t_kill_s"), kw.get("t_ready_s")
            if isinstance(tk, _NUM) and isinstance(tr, _NUM) and tr < tk:
                out.append(
                    f"fleet: kill_windows[{i}] t_ready_s {tr} < "
                    f"t_kill_s {tk} — a victim cannot be ready before "
                    "it was killed")
            lf = kw.get("loss_frac")
            if lf is not None and (not isinstance(lf, _NUM)
                                   or isinstance(lf, bool)
                                   or not 0.0 <= lf <= 1.0):
                out.append(f"fleet: kill_windows[{i}].loss_frac {lf!r} "
                           "must be a number in [0, 1]")
    lc = obj.get("lifecycle")
    if lc is not None and not isinstance(lc, dict):
        out.append("fleet: lifecycle must be a dict when present")
    elif isinstance(lc, dict):
        rw = lc.get("ready_walls_s")
        if not isinstance(rw, list) or any(
                not isinstance(w, _NUM) or isinstance(w, bool) or w < 0
                for w in rw):
            out.append("fleet: lifecycle.ready_walls_s must be a list "
                       "of non-negative numbers")
    out += _validate_fleet_elastic(obj)
    return out


def _validate_fleet_elastic(obj: dict) -> list:
    """The ``fleet.elastic`` block: spares held out of the
    serving books BY SCHEMA, promotions exactly-once, every autoscaler
    decision reasoned."""
    el = obj.get("elastic")
    if el is None:
        return []
    if not isinstance(el, dict):
        return ["fleet: elastic must be a dict when present"]
    out = []
    spare_ids = el.get("spare_ids")
    if not isinstance(spare_ids, list) or any(
            not isinstance(s, str) for s in spare_ids):
        out.append("fleet: elastic.spare_ids must be a list of strings")
        spare_ids = []
    # spares never enter the serving books: lifecycle samples and kill
    # windows may not carry a spare's id (the victim's SLOT keeps its
    # own id through a promotion)
    spares = set(spare_ids)
    lc = obj.get("lifecycle") or {}
    for e in (lc.get("events") or []):
        if isinstance(e, dict) and e.get("worker_id") in spares:
            out.append(
                f"fleet: spare {e['worker_id']!r} appears in "
                "lifecycle.events — a parked spare must be held out of "
                "the serving lifecycle book by schema")
    cap = obj.get("capacity") or {}
    for kw in (cap.get("kill_windows") or []):
        if isinstance(kw, dict) and kw.get("worker_id") in spares:
            out.append(
                f"fleet: spare {kw['worker_id']!r} opened a kill window "
                "— a parked spare was never serving, so its death digs "
                "no capacity hole")
    promos = el.get("promotions")
    if not isinstance(promos, list):
        out.append("fleet: elastic.promotions must be a list")
        promos = []
    seen_spares, seen_slots = set(), set()
    for i, p in enumerate(promos):
        if not isinstance(p, dict):
            out.append(f"fleet: elastic.promotions[{i}] must be a dict")
            continue
        tk, tr = p.get("t_kill_s"), p.get("t_ready_s")
        if isinstance(tk, _NUM) and isinstance(tr, _NUM) and tr < tk:
            out.append(
                f"fleet: elastic.promotions[{i}] t_ready_s {tr} < "
                f"t_kill_s {tk} — a promotion cannot complete before "
                "the kill it answers")
        sid = p.get("spare")
        if sid in seen_spares:
            out.append(
                f"fleet: spare {sid!r} promoted twice — promotion must "
                "be exactly-once per spare (one process cannot fill two "
                "slots)")
        seen_spares.add(sid)
        slot = (p.get("victim"), p.get("generation"))
        if slot in seen_slots:
            out.append(
                f"fleet: slot generation {slot!r} filled by two "
                "promotions — promotion must be exactly-once per "
                "(victim, generation)")
        seen_slots.add(slot)
        if sid is not None and sid not in spares:
            out.append(f"fleet: promotion spare {sid!r} is not a "
                       "declared spare id")
    sp = el.get("spares")
    if not isinstance(sp, dict):
        out.append("fleet: elastic.spares must be a dict of counters")
    elif isinstance(sp.get("promoted"), int) \
            and sp["promoted"] != len(promos):
        out.append(
            f"fleet: elastic.spares.promoted {sp['promoted']} != "
            f"{len(promos)} promotion records — the counter and the "
            "record list count the same events")
    decisions = el.get("decisions")
    if not isinstance(decisions, list):
        out.append("fleet: elastic.decisions must be a list")
        decisions = []
    for i, d in enumerate(decisions):
        if not isinstance(d, dict):
            out.append(f"fleet: elastic.decisions[{i}] must be a dict")
            continue
        if not str(d.get("reason") or "").strip():
            out.append(
                f"fleet: elastic.decisions[{i}] "
                f"({d.get('action')!r}) has no reason — every "
                "autoscaler decision must be a reasoned event")
        if d.get("action") not in ("scale_up", "scale_down", "hold",
                                   "tune_quota"):
            out.append(f"fleet: elastic.decisions[{i}].action "
                       f"{d.get('action')!r} unknown")
    quota = el.get("quota")
    if isinstance(quota, dict):
        floor, ceil = quota.get("floor_rps"), quota.get("ceiling_rps")
        for q in (quota.get("applied") or []):
            r = q.get("quota_rps") if isinstance(q, dict) else None
            if isinstance(r, _NUM) and isinstance(floor, _NUM) \
                    and isinstance(ceil, _NUM) \
                    and not (floor - 1e-9 <= r <= ceil + 1e-9):
                out.append(
                    f"fleet: applied quota {r} rps outside the declared "
                    f"floor/ceiling [{floor}, {ceil}] — auto-tuning must "
                    "respect its declared bounds")
    return out


def _validate_replay(obj: dict) -> list:
    """The replay artifact contract: closed tick books, closed serve
    books, and ingest-vs-serve panel-version reconciliation."""
    out: list = []
    _require(obj, "run_id", str, "replay", out)
    ver = _require(obj, "schema_version", int, "replay", out)
    if ver is not None and ver not in KNOWN_REPLAY_SCHEMA_VERSIONS:
        out.append(
            f"replay: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_REPLAY_SCHEMA_VERSIONS)}) — the "
            "artifact is from a different era of the code; do not "
            "half-parse it")
    _require(obj, "wall_s", _NUM, "replay", out, "a number")
    out += _validate_record(obj, kind="replay")

    ticks = _require(obj, "ticks", dict, "replay", out)
    if ticks is not None:
        keys = ("generated", "offered", "applied", "merged_late",
                "quarantined", "deduped", "dropped_gap", "duplicated")
        for k in keys:
            v = ticks.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"replay: ticks.{k} must be a non-negative int "
                           "(the tick ledger is the contract)")
                ticks = None
                break
    if ticks is not None:
        landed = (ticks["applied"] + ticks["merged_late"]
                  + ticks["quarantined"] + ticks["deduped"])
        if landed != ticks["offered"]:
            out.append(
                f"replay: tick accounting broken — applied "
                f"{ticks['applied']} + merged_late {ticks['merged_late']} "
                f"+ quarantined {ticks['quarantined']} + deduped "
                f"{ticks['deduped']} = {landed} != offered "
                f"{ticks['offered']} (a tick vanished between the feed "
                "and the ledger)")
        want_offered = (ticks["generated"] + ticks["duplicated"]
                        - ticks["dropped_gap"])
        if ticks["offered"] != want_offered:
            out.append(
                f"replay: feed accounting broken — offered "
                f"{ticks['offered']} != generated {ticks['generated']} + "
                f"duplicated {ticks['duplicated']} - dropped_gap "
                f"{ticks['dropped_gap']} = {want_offered}")

    panel = _require(obj, "panel", dict, "replay", out)
    if panel is not None:
        for k in ("version_final", "bars_appended", "gap_bars",
                  "stale_bars", "unfilled_cells"):
            v = panel.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"replay: panel.{k} must be a non-negative int")

    serve = _require(obj, "serve", dict, "replay", out)
    req = None
    if serve is not None:
        sreq = serve.get("requests")
        if not isinstance(sreq, dict):
            out.append("replay: serve.requests must be a dict (the serve "
                       "book rides inside the replay artifact)")
        else:
            req = _validate_serve_requests(sreq, "replay serve", out)
        _validate_latency_side((serve.get("latency_ms") or {}).get("total"),
                               "total", "replay", out)

    versions = _require(obj, "versions", dict, "replay", out)
    if versions is not None and panel is not None:
        vf = versions.get("ingest_final")
        if not isinstance(vf, int) or isinstance(vf, bool):
            out.append("replay: versions.ingest_final must be an int")
        elif isinstance(panel.get("version_final"), int) \
                and vf != panel["version_final"]:
            out.append(
                f"replay: versions.ingest_final {vf} != "
                f"panel.version_final {panel['version_final']} — the "
                "ingest side must agree with itself")
        smax = versions.get("serve_max")
        smin = versions.get("serve_min")
        for name, v in (("serve_min", smin), ("serve_max", smax)):
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                out.append(f"replay: versions.{name} must be a "
                           "non-negative int or null")
        if (isinstance(smax, int) and isinstance(vf, int)
                and smax > vf):
            out.append(
                f"replay: version reconciliation broken — serve answered "
                f"from panel version {smax} but ingest only ever issued "
                f"up to {vf} (a response was computed from a version "
                "that never existed)")
        if (isinstance(smin, int) and isinstance(smax, int)
                and smin > smax):
            out.append("replay: versions.serve_min > serve_max")
        for name in ("skew_events", "skew_attempts", "skew_refusals"):
            v = versions.get(name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"replay: versions.{name} must be a "
                           "non-negative int")
        sk = versions.get("skew_refusals")
        ska = versions.get("skew_attempts")
        if isinstance(sk, int) and isinstance(ska, int) and sk > ska:
            out.append(
                f"replay: skew_refusals {sk} > skew_attempts {ska} — "
                "more refusals than stale requests were ever submitted")
        if (isinstance(sk, int) and req is not None
                and sk != req.get("rejected_version_skew", 0)):
            out.append(
                f"replay: versions.skew_refusals {sk} does not reconcile "
                f"with serve.requests.rejected_version_skew "
                f"{req.get('rejected_version_skew', 0)}")

    rec = _require(obj, "reconcile", dict, "replay", out)
    if rec is not None:
        for k in ("count", "drift_events", "rebuilds"):
            v = rec.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"replay: reconcile.{k} must be a non-negative "
                           "int")
        # r14's window-slide counter: optional (pre-r14 artifacts lack
        # it) but typed like its sibling counters when present
        v = rec.get("reanchors")
        if v is not None and (not isinstance(v, int) or isinstance(v, bool)
                              or v < 0):
            out.append("replay: reconcile.reanchors must be a "
                       "non-negative int when present")
        if (isinstance(rec.get("count"), int)
                and isinstance(rec.get("drift_events"), int)
                and rec["drift_events"] > rec["count"]):
            out.append("replay: reconcile.drift_events exceeds "
                       "reconcile.count")

    stale = _require(obj, "staleness_ms", dict, "replay", out)
    if stale is not None:
        vals = []
        for q in ("p50", "p95", "p99"):
            v = stale.get(q)
            if v is None:
                continue
            if not isinstance(v, _NUM) or isinstance(v, bool):
                out.append(f"replay: staleness_ms.{q} must be a number "
                           "(milliseconds) or null")
            else:
                vals.append(v)
        if vals != sorted(vals):
            out.append("replay: staleness_ms percentiles must be "
                       "non-decreasing")

    comp = obj.get("compile")
    if comp is not None and not isinstance(comp, dict):
        out.append("replay: compile must be a dict when present")
    elif isinstance(comp, dict):
        fc = comp.get("in_window_fresh_compiles")
        if fc is not None and not isinstance(fc, (int, str)):
            out.append("replay: compile.in_window_fresh_compiles must be "
                       "an int count or a reason string")
    return out


def _validate_trace(obj: dict) -> list:
    """The trace artifact contract (``TRACE_*.json``, obs.trace): CLOSED
    trace books (every opened trace ends complete or reasoned-partial),
    telescoping stage reconciliation under epsilon, per-class burn
    arithmetic, and reconciliation against the driven serve run's
    request book (``complete == served``, ``partial == rejected +
    expired``) — the decomposition is only evidence if it covers every
    request the serve books admitted."""
    out: list = []
    _require(obj, "run_id", str, "trace", out)
    ver = _require(obj, "schema_version", int, "trace", out)
    if ver is not None and ver not in KNOWN_TRACE_SCHEMA_VERSIONS:
        out.append(
            f"trace: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_TRACE_SCHEMA_VERSIONS)}) — the "
            "artifact is from a different era of the code; do not "
            "half-parse it")
        return out
    out += _validate_record(obj, kind="trace")

    books = _require(obj, "books", dict, "trace", out)
    if books is not None:
        for k in ("opened", "complete", "partial"):
            v = books.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"trace: books.{k} must be a non-negative int "
                           "(the closed trace books are the contract)")
                books = None
                break
    if books is not None:
        if books["complete"] + books["partial"] != books["opened"]:
            out.append(
                f"trace: books broken — complete {books['complete']} + "
                f"partial {books['partial']} = "
                f"{books['complete'] + books['partial']} != opened "
                f"{books['opened']} (a request's trace never closed)")
        reasons = books.get("partial_reasons")
        if not isinstance(reasons, dict):
            out.append("trace: books.partial_reasons must be a dict of "
                       "reason -> count")
        elif books["partial"] and sum(reasons.values()) != books["partial"]:
            out.append(
                f"trace: partial_reasons sum to {sum(reasons.values())} "
                f"but partial is {books['partial']} — a partial trace "
                "closed without a reason")

    orphans = _require(obj, "orphans", dict, "trace", out)
    if isinstance(orphans, dict):
        oc = orphans.get("count")
        if not isinstance(oc, int) or isinstance(oc, bool) or oc < 0:
            out.append("trace: orphans.count must be a non-negative int")
        reasons = orphans.get("reasons")
        if not isinstance(reasons, dict):
            out.append("trace: orphans.reasons must be a dict of "
                       "reason -> count")
        elif isinstance(oc, int) and sum(reasons.values()) != oc:
            out.append(
                f"trace: orphan reasons sum to {sum(reasons.values())} "
                f"but count is {oc} — an orphan half was closed without "
                "its reason")

    stages = _require(obj, "stages", dict, "trace", out)
    if isinstance(stages, dict):
        if not stages and books and books.get("complete"):
            out.append("trace: complete traces exist but the stage "
                       "decomposition is empty")
        for name, s in stages.items():
            if not isinstance(s, dict):
                out.append(f"trace: stages[{name!r}] must be a dict")
                continue
            c = s.get("count")
            if not isinstance(c, int) or isinstance(c, bool) or c < 0:
                out.append(f"trace: stages[{name!r}].count must be a "
                           "non-negative int")
            _validate_latency_side(
                {q: s.get(q) for q in ("p50", "p95", "p99")},
                f"stages.{name}", "trace", out)

    rec = _require(obj, "reconcile", dict, "trace", out)
    if isinstance(rec, dict):
        for k in ("checked", "violations"):
            v = rec.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"trace: reconcile.{k} must be a non-negative "
                           "int")
        eps = rec.get("epsilon_ms")
        res = rec.get("max_abs_residual_ms")
        for name, v in (("epsilon_ms", eps), ("max_abs_residual_ms", res)):
            if not isinstance(v, _NUM) or isinstance(v, bool) or v < 0:
                out.append(f"trace: reconcile.{name} must be a "
                           "non-negative number")
        if rec.get("violations"):
            out.append(
                f"trace: {rec['violations']} trace(s) whose stage walls "
                "do not sum to the request wall within epsilon — the "
                "decomposition lost track of where the time went; "
                "invalid evidence, full stop")
        if (isinstance(eps, _NUM) and isinstance(res, _NUM)
                and not isinstance(eps, bool) and res > eps):
            out.append(
                f"trace: reconcile.max_abs_residual_ms {res} exceeds "
                f"epsilon_ms {eps} but violations claims none — the "
                "reconcile block disagrees with itself")

    slowest = _require(obj, "slowest", list, "trace", out)
    if isinstance(slowest, list) and isinstance(rec, dict):
        eps = rec.get("epsilon_ms")
        for i, e in enumerate(slowest):
            if not isinstance(e, dict) or not isinstance(
                    e.get("stages"), dict):
                out.append(f"trace: slowest[{i}] must be a dict with a "
                           "stages breakdown")
                continue
            wall = e.get("wall_ms")
            if not isinstance(wall, _NUM) or isinstance(wall, bool):
                out.append(f"trace: slowest[{i}].wall_ms must be a number")
                continue
            ssum = sum(v for v in e["stages"].values()
                       if isinstance(v, _NUM) and not isinstance(v, bool))
            if isinstance(eps, _NUM) and abs(ssum - wall) > eps:
                out.append(
                    f"trace: slowest[{i}] stage walls sum to {ssum:.3f} "
                    f"ms but wall_ms is {wall:.3f} (off by more than "
                    f"epsilon {eps} ms) — the critical path does not "
                    "reconcile")

    classes = _require(obj, "classes", dict, "trace", out)
    if isinstance(classes, dict):
        for name, book in classes.items():
            if not isinstance(book, dict):
                out.append(f"trace: classes[{name!r}] must be a dict")
                continue
            for k in ("count", "served", "violations"):
                v = book.get(k)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    out.append(f"trace: classes[{name!r}].{k} must be a "
                               "non-negative int")
                    break
            else:
                if book["violations"] > book["served"]:
                    out.append(f"trace: classes[{name!r}].violations "
                               f"{book['violations']} > served "
                               f"{book['served']}")
                burn = book.get("budget_burn")
                if burn is not None and (not isinstance(burn, _NUM)
                                         or isinstance(burn, bool)
                                         or burn < 0):
                    out.append(f"trace: classes[{name!r}].budget_burn "
                               "must be a non-negative number or null")

    req = _require(obj, "requests", dict, "trace", out)
    if isinstance(req, dict):
        ok = True
        for k in ("admitted", "served", "rejected", "expired"):
            v = req.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(f"trace: requests.{k} must be a non-negative "
                           "int (the serve book this trace run must "
                           "reconcile against)")
                ok = False
        if ok and books is not None:
            if books["complete"] != req["served"]:
                out.append(
                    f"trace: books.complete {books['complete']} != "
                    f"requests.served {req['served']} — a served request "
                    "has no complete trace (or a trace claims a serve "
                    "that never happened)")
            if books["partial"] != req["rejected"] + req["expired"]:
                out.append(
                    f"trace: books.partial {books['partial']} != "
                    f"rejected {req['rejected']} + expired "
                    f"{req['expired']} — the partial ledger does not "
                    "cover every non-served request")

    comp = obj.get("compile")
    if comp is not None and not isinstance(comp, dict):
        out.append("trace: compile must be a dict when present")
    elif isinstance(comp, dict):
        fc = comp.get("in_window_fresh_compiles")
        if fc is not None and not isinstance(fc, (int, str)):
            out.append("trace: compile.in_window_fresh_compiles must be "
                       "an int count or a reason string")
    return out


def _validate_telemetry(obj: dict) -> list:
    """The telemetry sidecar contract (``GPU_TELEMETRY_<run>.json``,
    obs/timeline.py): the phases account for the run's wall."""
    out: list = []
    _require(obj, "run_id", str, "telemetry", out)
    ver = _require(obj, "schema_version", int, "telemetry", out)
    if ver is not None and ver not in KNOWN_TELEMETRY_SCHEMA_VERSIONS:
        out.append(
            f"telemetry: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_TELEMETRY_SCHEMA_VERSIONS)}) — the "
            "sidecar is from a different era of the code; do not "
            "half-parse it"
        )
    wall = _require(obj, "wall_s", _NUM, "telemetry", out, "a number")
    phases = _require(obj, "phases", list, "telemetry", out)
    if phases is not None:
        names = []
        total = 0.0
        for i, ph in enumerate(phases):
            if not isinstance(ph, dict):
                out.append(f"telemetry: phases[{i}] must be an object")
                continue
            if not isinstance(ph.get("name"), str):
                out.append(f"telemetry: phases[{i}].name must be a string")
            else:
                names.append(ph["name"])
            if not isinstance(ph.get("dur_s"), _NUM):
                out.append(f"telemetry: phases[{i}].dur_s must be a number")
            else:
                total += ph["dur_s"]
        if len(names) != len(set(names)):
            out.append("telemetry: duplicate phase names")
        # the sidecar's claim: the phases account for the wall, within 5%
        # (rounding, torn tail events), floored so a sub-second run is
        # not failed over microseconds
        if isinstance(wall, _NUM) and not out:
            tol = max(0.05 * wall, 0.02)
            if abs(total - wall) > tol:
                out.append(
                    f"telemetry: phase durations sum to {total:.4f}s but "
                    f"wall_s is {wall:.4f}s (off by more than 5% — the "
                    "timeline lost track of where the time went)"
                )
    if "spans" in obj and not isinstance(obj["spans"], list):
        out.append("telemetry: spans must be a list")
    # the device-memory records of the metrics snapshot (obs.memstats)
    metrics = obj.get("metrics")
    mem = metrics.get("memory") if isinstance(metrics, dict) else None
    if mem is not None:
        if not isinstance(mem, dict):
            out.append("telemetry: metrics.memory must be a dict of "
                       "shape -> byte stats")
        else:
            for shape, stats in mem.items():
                if isinstance(stats, str):
                    continue  # a capture-failure reason is a valid value
                if not isinstance(stats, dict):
                    out.append(f"telemetry: metrics.memory[{shape!r}] must "
                               "be a byte-stats dict or a reason string")
                    continue
                pk = stats.get("peak_bytes")
                if not isinstance(pk, int) or isinstance(pk, bool):
                    out.append(f"telemetry: metrics.memory[{shape!r}] "
                               "missing int peak_bytes (the ledger's "
                               "comparable scalar)")
                if not isinstance(stats.get("platform"), str):
                    out.append(f"telemetry: metrics.memory[{shape!r}] "
                               "missing str platform — compiled bytes "
                               "are per-backend and must say whose they "
                               "are")
                for k, v in stats.items():
                    if k.endswith("_in_bytes") and (
                            not isinstance(v, int) or isinstance(v, bool)):
                        out.append(f"telemetry: metrics.memory[{shape!r}]."
                                   f"{k} must be an int byte count")
    return out


def _validate_lint(obj: dict) -> list:
    """The lint report's contract (``lint --format json``): a known
    schema version, the closed v2 key world, findings of a coherent shape,
    and ``ok`` meaning zero findings."""
    out: list = []
    ver = _require(obj, "schema_version", int, "lint", out)
    if ver is not None and ver not in KNOWN_LINT_SCHEMA_VERSIONS:
        out.append(
            f"lint: unknown schema_version {ver} (this checker "
            f"understands {list(KNOWN_LINT_SCHEMA_VERSIONS)}) — the "
            "report is from a different era of the code; do not "
            "half-parse it")
        return out
    _require(obj, "ok", bool, "lint", out)
    _require(obj, "files_scanned", int, "lint", out)
    _require(obj, "rules", list, "lint", out)
    findings = _require(obj, "findings", list, "lint", out)
    _require(obj, "suppressed", list, "lint", out)
    if ver == 2:
        unknown = sorted(set(obj) - _LINT_V2_KEYS)
        if unknown:
            out.append(f"lint: unknown v2 keys {unknown} — the report "
                       "key world is closed; bump the schema version "
                       "for new fields")
        _require(obj, "project", bool, "lint", out)
        cache = _require(obj, "cache", dict, "lint", out)
        if cache is not None and not isinstance(cache.get("enabled"),
                                                bool):
            out.append("lint: cache.enabled must be a bool")
        _require(obj, "rule_timings_s", dict, "lint", out)
    if findings is not None:
        for i, f in enumerate(findings):
            if not isinstance(f, dict):
                out.append(f"lint: findings[{i}] must be an object")
                continue
            missing = {"rule", "path", "line", "message"} - set(f)
            if missing:
                out.append(f"lint: findings[{i}] missing {sorted(missing)}")
            if ver == 2 and not set(f) <= _LINT_FINDING_KEYS:
                out.append(f"lint: findings[{i}] carries unknown keys "
                           f"{sorted(set(f) - _LINT_FINDING_KEYS)}")
        if isinstance(obj.get("ok"), bool) and obj["ok"] != (
                len(findings) == 0):
            out.append("lint: ok flag disagrees with the findings list "
                       "(ok means ZERO unsuppressed findings)")
    return out


# kinds the ledger detects whose validators belong to the capture tooling
# (bench.py and capture_lib.sh, ROADMAP.md Queue 1 item 8b)
_CAPTURE_KINDS = ("driver_capture", "multichip", "phases", "tpu_cache")


def validate(obj, kind: str | None = None) -> list:
    """All contract violations of one serve, serve_pool, serve_fabric,
    fleet, trace, replay, telemetry, lint or record artifact (empty =
    valid).  A driver capture, multichip check, phases profile or session
    cache is detected but not validated: one violation says so."""
    if not isinstance(obj, dict):
        return [f"artifact must be a JSON object, got {type(obj).__name__}"]
    kind = kind or detect_kind(obj)
    if kind is None:
        return ["unrecognized artifact shape: none of the known key "
                "signatures (record / driver_capture / multichip / phases "
                "/ tpu_cache / telemetry / serve / serve_pool / "
                "serve_fabric / fleet / replay / trace / lint) match"]
    if kind in _CAPTURE_KINDS:
        return [f"{kind}: no validator in the port yet — the capture "
                "tooling's validators (driver capture, multichip, phases, "
                "session cache) come with bench.py and capture_lib.sh "
                "(ROADMAP.md, Queue 1 item 8b)"]
    if kind == "record":
        return _validate_record(obj)
    if kind == "lint":
        return _validate_lint(obj)
    if kind == "telemetry":
        return _validate_telemetry(obj)
    if kind == "fleet":
        return _validate_fleet(obj)
    if kind == "trace":
        return _validate_trace(obj)
    if kind == "replay":
        return _validate_replay(obj)
    if kind == "serve_fabric":
        return _validate_serve_fabric(obj)
    if kind == "serve_pool":
        return _validate_serve_pool(obj)
    if kind != "serve":
        return [f"unknown artifact kind {kind!r}"]
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


def validate_tree(root: str, patterns=("GPU_SERVE_*.json",
                                       "GPU_FLEET_*.json",
                                       "GPU_TRACE_*.json",
                                       "GPU_REPLAY_*.json",
                                       "GPU_TELEMETRY_*.json")) -> dict:
    """``{file name: violations}`` for every port artifact directly under
    ``root`` matching ``patterns`` (an empty list = valid, so a caller
    reports coverage, not just failures)."""
    import glob
    import os

    out = {}
    for pat in patterns:
        for path in sorted(glob.glob(os.path.join(root, pat))):
            out[os.path.basename(path)] = validate_file(path)
    return out
