"""``fleet <run>``: render a run's ``GPU_FLEET_<run>.json`` observatory
capture.

Counterpart of ``csmom_tpu.cli.fleet``; it prints what ``csmom fleet``
prints.  The serve and fabric artifacts say what a run ended with; this
says what the fleet looked like while it ran.  Given a fleet artifact
(:mod:`csmom_tpu_torch.obs.fleet`), it validates it (kind ``fleet``) and
prints:

- the **kill-window capacity account**: nominal against available
  worker-seconds, each kill window's width, loss fraction and the
  demand offered inside it, and the steady-state loss;
- **lifecycle walls**: every (re)spawn's spawn -> ready wall with the
  worker-reported bind and warm walls;
- the **demand book**: per-class offered / admitted / served totals
  (which reconcile with the serve request book by schema) and the peak
  per-second offered rate;
- **occupancy**: queue-depth and in-flight quantiles per process;
- the **stream books**: each process's series span and close reason.

It reads the artifact's bytes only (no clock, no device): exit 0 when
the artifact is valid, 1 when it violates its schema, 2 when no
artifact is found or it is unreadable.
"""

from __future__ import annotations

import glob
import json
import os
import sys

__all__ = ["cmd_fleet", "register"]

# the checkout that owns this module: the second place an artifact is
# looked for, after the working directory
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _locate(run: str, root: str | None) -> str | None:
    if os.path.isfile(run):
        return run
    roots = [root] if root else [os.getcwd(), _REPO]
    for r in roots:
        for pat in (f"GPU_FLEET_{run}.json", f"GPU_FLEET_*{run}*.json"):
            hits = sorted(glob.glob(os.path.join(r, pat)))
            if hits:
                return hits[0]
    return None


def _fmt(v, w=8, p=3) -> str:
    return f"{v:>{w}.{p}f}" if isinstance(v, (int, float)) else f"{'—':>{w}}"


def _print_capacity(obj: dict) -> None:
    for label, cap in (("worker", obj.get("capacity")),
                       ("router", obj.get("router_capacity"))):
        if not isinstance(cap, dict):
            continue
        print(f"\n{label}-tier capacity account "
              f"({cap.get('n_slots')} slot(s), "
              f"{cap.get('window_s')} s window):")
        print(f"  worker-seconds: nominal {cap.get('nominal_worker_s')} "
              f"available {cap.get('available_worker_s')}")
        print(f"  loss fraction: kill-window "
              f"{cap.get('kill_window_loss_frac')}  steady-state "
              f"{cap.get('steady_state_loss_frac')}")
        kws = cap.get("kill_windows") or []
        if not kws:
            print("  kill windows: none")
            continue
        print(f"  {'victim':<10} {'t_kill_s':>9} {'t_ready_s':>9} "
              f"{'width_s':>8} {'loss':>7} {'offered_in_window':>18}")
        for kw in kws:
            tr = (f"{_fmt(kw.get('t_ready_s'), 9)}"
                  if not kw.get("open_ended")
                  else f"{'(never)':>9}")
            print(f"  {str(kw.get('worker_id')):<10} "
                  f"{_fmt(kw.get('t_kill_s'), 9)} {tr} "
                  f"{_fmt(kw.get('width_s'), 8)} "
                  f"{_fmt(kw.get('loss_frac'), 7, 4)} "
                  f"{kw.get('demand_offered_in_window', '—'):>18}")


def _print_lifecycle(obj: dict) -> None:
    events = (obj.get("lifecycle") or {}).get("events") or []
    if not events:
        return
    print("\nlifecycle walls (one row per (re)spawn reaching ready):")
    print(f"  {'worker':<10} {'gen':>4} {'spawn→ready':>12} "
          f"{'main→bind':>10} {'warm':>8}")
    for e in events:
        walls = e.get("walls") or {}
        print(f"  {str(e.get('worker_id')):<10} "
              f"{str(e.get('generation', '—')):>4} "
              f"{_fmt(e.get('wall_s'), 12)} "
              f"{_fmt(walls.get('main_to_bind_s'), 10)} "
              f"{_fmt(walls.get('warm_s'), 8)}")


def _print_demand(obj: dict) -> None:
    demand = obj.get("demand") or {}
    classes = demand.get("classes") or {}
    if not classes:
        print("\ndemand book: (window never opened)")
        return
    window_s = obj.get("window_s") or 0
    print("\ndemand book (client-tier arrivals, reconciles with the "
          "serve request ledger by schema):")
    print(f"  {'class':<12} {'offered':>8} {'admitted':>9} {'served':>8} "
          f"{'rps':>8}")
    for cls, tot in sorted(classes.items()):
        rps = (round(tot.get("offered", 0) / window_s, 2)
               if window_s else None)
        print(f"  {cls:<12} {tot.get('offered', 0):>8} "
              f"{tot.get('admitted', 0):>9} {tot.get('served', 0):>8} "
              f"{_fmt(rps, 8, 2)}")
    per_s = demand.get("per_second") or []
    peak, peak_t = 0, None
    for row in per_s:
        n = sum(ev.get("offered", 0) for k, ev in row.items()
                if k != "t_s" and isinstance(ev, dict))
        if n > peak:
            peak, peak_t = n, row.get("t_s")
    if peak_t is not None:
        print(f"  peak offered: {peak} req/s at t={peak_t} s "
              f"({len(per_s)} one-second buckets)")


def _print_occupancy(obj: dict) -> None:
    occ = obj.get("occupancy") or {}
    if not occ:
        return
    print("\noccupancy (per-process series quantiles over the capture):")
    print(f"  {'process':<14} {'depth p50':>10} {'p95':>7} {'max':>7} "
          f"{'inflight p50':>13} {'p95':>7} {'max':>7}")
    for proc, q in sorted(occ.items()):
        d = q.get("queue_depth") or {}
        f = q.get("in_flight") or {}
        print(f"  {proc:<14} {_fmt(d.get('p50'), 10, 1)} "
              f"{_fmt(d.get('p95'), 7, 1)} {_fmt(d.get('max'), 7, 1)} "
              f"{_fmt(f.get('p50'), 13, 1)} {_fmt(f.get('p95'), 7, 1)} "
              f"{_fmt(f.get('max'), 7, 1)}")


def _print_streams(obj: dict) -> None:
    series = obj.get("series") or {}
    books = series.get("books") or {}
    print(f"\nstream books: {books.get('procs_opened')} process stream(s) "
          f"opened, {books.get('procs_closed')} closed; "
          f"{books.get('frames')} frames ({books.get('frames_malformed')} "
          f"malformed), {books.get('seq_gaps')} seq gap(s), "
          f"{books.get('frames_dropped_by_emitters')} dropped by "
          f"emitters; {books.get('series_count')} series")
    procs = series.get("processes") or {}
    for name, book in sorted(procs.items()):
        span = (f"t {book.get('t_first_s')}–{book.get('t_last_s')} s, "
                f"{book.get('samples')} frame(s), pid {book.get('pid')}")
        print(f"  {name:<14} {span:<44} closed: "
              f"{book.get('close_reason')}")


def cmd_fleet(args) -> int:
    """Render a run's GPU_FLEET_<run>.json: the kill-window capacity
    account, lifecycle walls, demand book, occupancy and the
    reason-closed stream books."""
    from csmom_tpu_torch.chaos import invariants as inv

    path = _locate(args.run, args.root)
    if path is None:
        print(f"error: no fleet artifact matches {args.run!r} (looked for "
              "a file path, then GPU_FLEET_<run>.json in "
              f"{args.root or '. and the repository root'}).  Capture one "
              "with `loadgen --fabric --fleet` (or --pool --fleet).",
              file=sys.stderr)
        return 2
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: unreadable fleet artifact {path}: {e}",
              file=sys.stderr)
        return 2
    violations = inv.validate(obj, "fleet")
    if args.json:
        json.dump(obj, sys.stdout, indent=1)
        print()
    else:
        print(f"[{os.path.relpath(path)}]")
        extra = obj.get("extra") or {}
        print(f"run {obj.get('run_id')}  platform "
              f"{extra.get('platform')}  cadence {obj.get('cadence_s')} s"
              f"  window {obj.get('window_s')} s  fresh compiles in "
              f"window "
              f"{(obj.get('compile') or {}).get('in_window_fresh_compiles')!r}")
        if extra.get("workload"):
            print(f"workload: {extra['workload']}")
        try:
            _print_capacity(obj)
            _print_lifecycle(obj)
            _print_demand(obj)
            _print_occupancy(obj)
            _print_streams(obj)
        except Exception as e:  # a damaged artifact still gets its
            print(f"(render failed: {type(e).__name__}: {e} — "  # diagnosis
                  "schema report below)")
    if violations:
        print("\nschema violations (the artifact is damaged or "
              "stale-format):", file=sys.stderr)
        for v in violations:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


def register(sub) -> None:
    """Attach the ``fleet`` subparser."""
    sp = sub.add_parser(
        "fleet",
        help="render a run's GPU_FLEET_<run>.json observatory capture "
             "(kill-window capacity account, lifecycle walls, demand "
             "book, occupancy, reason-closed stream books)",
    )
    sp.add_argument("run",
                    help="fleet artifact path or run id (resolved as "
                         "GPU_FLEET_<run>.json in . and the repository root)")
    sp.add_argument("--root", help="artifact directory (default: cwd, "
                                   "then the repository checkout)")
    sp.add_argument("--json", action="store_true",
                    help="dump the artifact object instead of rendering")
    sp.set_defaults(fn=cmd_fleet)
