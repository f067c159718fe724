"""Assemble a telemetry event stream into a per-run phase timeline.

Counterpart of ``csmom_tpu.obs.timeline``, copied; the sidecar is
``GPU_TELEMETRY_<run>.json`` (``TELEMETRY_*`` names are the reference's,
which its own checks sweep at the repository root).  The sidecar answers
"where did the time go in this run?": the run's wall, partitioned into
the capture pipeline's phases

    warmup -> probe -> compile -> row -> land   (+ other)

plus per-span aggregates and the final metrics snapshot.  It is
schema-validated by :mod:`csmom_tpu_torch.chaos.invariants` (kind
``telemetry``).

Phase accounting is a sweep, not a sum of span durations: spans nest and
processes overlap (a child's compile spans live inside the supervisor's
attempt span), so naively summing double-counts.  Instead every instant
of the run's wall is assigned to exactly ONE phase — the
highest-priority phase with a span covering that instant (land > row >
compile > probe > warmup), and ``other`` where none does.  Phase
durations therefore partition the wall by construction: their sum equals
``wall_s`` up to rounding, which is the invariant the schema validator
pins (within 5%).

Cross-process composition works because every event's timestamps are
``time.monotonic()`` and CLOCK_MONOTONIC is system-wide on Linux: a
child appending to the supervisor's stream lands its spans at the right
offsets on the same timeline.
"""

from __future__ import annotations

import datetime
import json
import os

__all__ = [
    "PHASES",
    "assemble",
    "finish_and_write",
    "load_sidecar",
    "phase_of",
    "read_events",
    "render",
    "scratch_dir",
    "sidecar_name",
    "sidecar_search_roots",
    "write_sidecar",
]

# regenerated (uncommittable) sidecars land here instead of the working
# directory; the directory is gitignored as a whole, and `timeline`
# searches it
SCRATCH_DIRNAME = ".csmom_scratch"

SCHEMA_VERSION = 1

# priority order: when spans of two phases cover the same instant (a
# compile checkpoint inside a measured row, a child's rows inside the
# supervisor's probe loop) the more specific/later pipeline stage wins
PHASES = ("warmup", "probe", "compile", "row", "land")
_PRIORITY = {name: i for i, name in enumerate(PHASES)}


def phase_of(name: str, attrs: dict | None = None) -> str | None:
    """Map an event to its pipeline phase (an explicit ``phase`` attr
    wins; otherwise by name convention, matching the checkpoint
    vocabulary of chaos.plan)."""
    if attrs:
        p = attrs.get("phase")
        if p in _PRIORITY:
            return p
    n = name.lower()
    if "warmup" in n:
        return "warmup"
    if "probe" in n:
        return "probe"
    if "compile" in n or n.startswith("aot."):
        return "compile"
    if "land" in n or "finish" in n:
        return "land"
    if "row" in n:
        return "row"
    return None


def read_events(path: str) -> list:
    """Parse a JSONL event stream; damaged lines are skipped (the stream
    is append-flushed per event, so at most the killed writer's last line
    is torn)."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict):
                    out.append(ev)
    except OSError:
        pass
    return out


def _phase_partition(intervals: list, t0: float, t1: float) -> dict:
    """Assign every instant of [t0, t1] to the highest-priority covering
    phase; returns phase -> seconds (plus ``other`` for uncovered time).
    O(n^2) in span count — runs see tens of spans, not thousands."""
    durs = dict.fromkeys((*PHASES, "other"), 0.0)
    if t1 <= t0:
        return durs
    clipped = [(max(a, t0), min(b, t1), ph) for a, b, ph in intervals
               if min(b, t1) > max(a, t0)]
    cuts = sorted({t0, t1, *(a for a, _, _ in clipped),
                   *(b for _, b, _ in clipped)})
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for x, y, ph in clipped:
            if x <= a and y >= b:
                if best is None or _PRIORITY[ph] > _PRIORITY[best]:
                    best = ph
        durs[best or "other"] += b - a
    return durs


def assemble(events: list, run_id: str | None = None,
             metrics: dict | None = None) -> dict:
    """Build the telemetry sidecar object from an event stream.

    ``metrics`` overrides the stream's last ``kind: metrics`` event (the
    assembling process usually snapshots fresher state than anything a
    child emitted).  With an explicit ``run_id``, events stamped with a
    DIFFERENT run are dropped first: an env-armed stream file is opened
    append, so a reused path can carry yesterday's run too, and a
    timeline mixing two runs corresponds to neither."""
    if run_id is not None:
        events = [e for e in events if e.get("run", run_id) == run_id]
    spans = [e for e in events if e.get("kind") == "span"
             and isinstance(e.get("t0_s"), (int, float))
             and isinstance(e.get("t1_s"), (int, float))]
    points = [e for e in events if e.get("kind") == "point"]

    # the run window: the longest root-flagged span (the supervisor's
    # root encloses every child), else the envelope of everything seen
    roots = [s for s in spans if (s.get("attrs") or {}).get("root")]
    if roots:
        root = max(roots, key=lambda s: s["t1_s"] - s["t0_s"])
        t0, t1, root_name = root["t0_s"], root["t1_s"], root["name"]
    elif spans or points:
        stamps = ([s["t0_s"] for s in spans] + [s["t1_s"] for s in spans]
                  + [p["t_s"] for p in points
                     if isinstance(p.get("t_s"), (int, float))])
        t0, t1 = min(stamps), max(stamps)
        root_name = f"envelope of {len(events)} events (no root span)"
    else:
        t0 = t1 = 0.0
        root_name = "empty event stream"

    intervals, phase_spans = [], dict.fromkeys((*PHASES, "other"), 0)
    for s in spans:
        ph = phase_of(s.get("name", ""), s.get("attrs"))
        phase_spans[ph or "other"] += 1
        if ph is not None and not (s.get("attrs") or {}).get("root"):
            intervals.append((s["t0_s"], s["t1_s"], ph))
    phase_points = dict.fromkeys((*PHASES, "other"), 0)
    for p in points:
        ph = phase_of(p.get("name", ""), p.get("attrs"))
        phase_points[ph or "other"] += 1

    wall = t1 - t0
    durs = _phase_partition(intervals, t0, t1)
    phases = [
        {
            "name": ph,
            "dur_s": round(durs[ph], 6),
            "frac": round(durs[ph] / wall, 4) if wall > 0 else 0.0,
            "n_spans": phase_spans[ph],
            "n_points": phase_points[ph],
        }
        for ph in (*PHASES, "other")
    ]

    # per-name aggregates: the flame summary's rows
    agg: dict = {}
    for s in spans:
        a = agg.setdefault(s.get("name", "?"), {
            "name": s.get("name", "?"),
            "phase": phase_of(s.get("name", ""), s.get("attrs")) or "other",
            "count": 0, "total_s": 0.0, "device_s": 0.0, "max_s": 0.0,
            "errors": 0,
        })
        d = s["t1_s"] - s["t0_s"]
        a["count"] += 1
        a["total_s"] += d
        a["device_s"] += s.get("device_s") or 0.0
        a["max_s"] = max(a["max_s"], d)
        a["errors"] += 1 if s.get("error") else 0
    span_rows = sorted(agg.values(), key=lambda a: -a["total_s"])
    for a in span_rows:
        for k in ("total_s", "device_s", "max_s"):
            a[k] = round(a[k], 6)

    if metrics is None:
        for e in reversed(events):
            if e.get("kind") == "metrics" and isinstance(e.get("data"), dict):
                metrics = e["data"]
                break
    run = run_id or next(
        (e["run"] for e in events if isinstance(e.get("run"), str)), "unknown"
    )
    return {
        "kind": "telemetry",
        "schema_version": SCHEMA_VERSION,
        "run_id": run,
        "generated_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "root": root_name,
        "wall_s": round(wall, 6),
        "t0_s": round(t0, 6),
        "t1_s": round(t1, 6),
        "n_events": len(events),
        "n_spans": len(spans),
        "n_points": len(points),
        "n_processes": len({e.get("pid") for e in events}) if events else 0,
        "phases": phases,
        "spans": span_rows,
        "metrics": metrics if metrics is not None else
        "not captured: no metrics snapshot in this run's event stream",
    }


def sidecar_search_roots(explicit_root: str | None = None) -> list:
    """The artifact search order shared by ``timeline``, ``trace`` and
    ``fleet`` (one list, so the commands cannot drift): an explicit
    ``--root`` wins outright; otherwise the ``CSMOM_TELEMETRY_DIR``
    override first, then the working directory and this checkout, each
    followed by its ``.csmom_scratch`` directory (regenerated rehearse
    and smoke sidecars, see :func:`scratch_dir`)."""
    if explicit_root:
        return [explicit_root]
    roots: list = []
    env_dir = os.environ.get("CSMOM_TELEMETRY_DIR")
    if env_dir:
        roots.append(env_dir)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for base in (os.getcwd(), repo):
        roots += [base, os.path.join(base, SCRATCH_DIRNAME)]
    return roots


def scratch_dir(base: str | None = None) -> str:
    """The scratch directory for regenerated sidecars (rehearse and smoke
    runs: anything ``invariants.committable_sidecar`` refuses).
    ``CSMOM_TELEMETRY_DIR`` overrides; the default is ``<base or
    cwd>/.csmom_scratch``, created on demand."""
    d = (os.environ.get("CSMOM_TELEMETRY_DIR")
         or os.path.join(base or os.getcwd(), SCRATCH_DIRNAME))
    os.makedirs(d, exist_ok=True)
    return d


def sidecar_name(run_id: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in run_id)
    return f"GPU_TELEMETRY_{safe}.json"


def write_sidecar(out_dir: str, run_id: str, events: list | None = None,
                  events_path: str | None = None,
                  metrics: dict | None = None,
                  overwrite: bool = True) -> str:
    """Assemble and atomically land ``GPU_TELEMETRY_<run>.json``; returns
    the file name, or a reason string on failure: a telemetry write must
    never take the run's own record down with it.

    ``overwrite=False`` is for runs whose id came from outside
    (``CSMOM_TELEMETRY_RUN``): an existing sidecar of that name is kept
    and the new run lands pid-suffixed."""
    if events is None:
        events = read_events(events_path) if events_path else []
    obj = assemble(events, run_id=run_id, metrics=metrics)
    name = sidecar_name(run_id)
    path = os.path.join(out_dir, name)
    if not overwrite and os.path.exists(path):
        name = sidecar_name(f"{run_id}-{os.getpid()}")
        path = os.path.join(out_dir, name)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return name
    except OSError as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return f"unwritable ({type(e).__name__}: {e})"[:120]


def load_sidecar(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def finish_and_write(out_dir: str, fallback_metrics: dict | None = None,
                     overwrite: bool = True) -> str:
    """Land the armed collector's run as a sidecar and disarm.

    The one finish sequence ``rehearse`` and ``warmup`` share: read the
    full stream file when there is one (children appended there; the
    in-memory list holds only this process's events), let a ``kind:
    metrics`` event of the run in the stream outrank ``fallback_metrics``,
    write ``GPU_TELEMETRY_<run>.json`` into ``out_dir``, and disarm
    whatever happens.  Returns the sidecar name, or a reason string;
    never raises.
    """
    from csmom_tpu_torch.obs import spans as _spans

    col = _spans.current_collector()
    if col is None:
        return "not captured: telemetry disarmed (CSMOM_TELEMETRY=0)"
    try:
        events = read_events(col.path) if col.path else list(col.events)
        # run-scoped, matching assemble()'s filter: a stale metrics event
        # from an older run in a reused stream must not suppress the live
        # fallback snapshot (it would then be dropped by the filter too)
        has_metrics = any(
            e.get("kind") == "metrics"
            and e.get("run", col.run_id) == col.run_id
            for e in events
        )
        return write_sidecar(out_dir, col.run_id, events=events,
                             metrics=None if has_metrics else fallback_metrics,
                             overwrite=overwrite)
    except Exception as e:  # never cost the caller's own record
        return f"telemetry assembly failed: {type(e).__name__}: {e}"[:160]
    finally:
        _spans.disarm()


def render(obj: dict, top: int = 12, width: int = 40) -> str:
    """The text flame summary ``timeline`` prints."""
    wall_raw = obj.get("wall_s")
    wall = wall_raw if isinstance(wall_raw, (int, float)) else 0.0
    lines = [
        f"run {obj.get('run_id')}  wall {wall:.3f}s  "
        f"root {obj.get('root')}",
        f"events {obj.get('n_events')} ({obj.get('n_spans')} spans, "
        f"{obj.get('n_points')} points) across "
        f"{obj.get('n_processes')} process(es)   "
        f"generated {obj.get('generated_utc')}",
        "",
        "phase     dur_s      %   spans  points",
    ]
    # .get throughout: render stays best-effort on a damaged sidecar so
    # cmd_timeline can still print the schema violations after it
    for ph in obj.get("phases", []):
        if not isinstance(ph, dict):
            continue
        frac = ph.get("frac") or 0.0
        bar = "#" * max(1 if (ph.get("dur_s") or 0) > 0 else 0,
                        int(round(frac * width)))
        lines.append(
            f"{ph.get('name', '?'):<8} {ph.get('dur_s') or 0.0:>8.3f} "
            f"{frac:>6.1%}  {ph.get('n_spans', 0):>5}  "
            f"{ph.get('n_points', 0):>6}  {bar}"
        )
    rows = [a for a in obj.get("spans", []) if isinstance(a, dict)]
    if rows:
        lines += ["", f"top spans by total wall (of {len(rows)}):"]
        for a in rows[:top]:
            total = a.get("total_s") or 0.0
            dev = (f"  device {a['device_s']:.3f}s"
                   if a.get("device_s") else "")
            err = f"  errors {a['errors']}" if a.get("errors") else ""
            share = f" {total / wall:>6.1%}" if wall > 0 else ""
            lines.append(
                f"  {a.get('name', '?'):<34} {a.get('count', 0):>3}x "
                f"{total:>9.3f}s{share}  [{a.get('phase', '?')}]{dev}{err}"
            )
    m = obj.get("metrics")
    if isinstance(m, dict):
        bits = []
        for k, v in (m.get("counters") or {}).items():
            bits.append(f"{k}={v}")
        for k, v in (m.get("gauges") or {}).items():
            bits.append(f"{k}={v}")
        comp = m.get("compile")
        if isinstance(comp, dict):
            bits.append(f"cache_hits={comp.get('cache_hits')}")
            bits.append(f"cache_misses={comp.get('cache_misses')}")
            bits.append(f"backend_compiles={comp.get('backend_compiles')}")
        if bits:
            lines += ["", "metrics: " + "  ".join(str(b) for b in bits)]
    return "\n".join(lines)
