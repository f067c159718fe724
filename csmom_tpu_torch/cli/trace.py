"""``trace <run>``: render a run's ``GPU_TRACE_<run>.json`` request-path
decomposition.

Counterpart of ``csmom_tpu.cli.trace``; it prints what ``csmom trace``
prints.  Given a trace artifact (:mod:`csmom_tpu_torch.obs.trace`, landed
by ``loadgen --trace``), it validates it (kind ``trace``) and prints:

- the **per-stage decomposition table**: p50/p95/p99 per stage (admit,
  queue_wait, coalesce, pad, dispatch, serialize, plus route/transport
  for pool- and fabric-stitched runs), so a tail names its layer;
- the **critical path** of the slowest-k complete requests, largest
  stage first;
- **padding-waste goodput per bucket**: used against padded lanes and
  the fire-reason mix for every (endpoint, bucket) the run dispatched;
- the **closed trace books**: complete/partial with reasons, orphan
  halves (a SIGKILLed worker's or replica's unstitchable dispatches)
  with reasons, and the per-class SLO error-budget burn.

It reads the artifact's bytes only (no clock, no device): its output is
a function of the file.  Exit 0 when the artifact is valid, 1 when it
violates its schema, 2 when no artifact is found or it is unreadable.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from csmom_tpu_torch.chaos import invariants as inv

__all__ = ["cmd_trace", "register"]

# the checkout that owns this module
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a run's regenerated scratch artifacts, beside its committed ones
_SCRATCH_DIRNAME = ".csmom_scratch"


def _search_roots(explicit_root: str | None) -> list:
    """The reference's artifact search order, copied: an explicit
    ``--root`` wins outright; otherwise ``CSMOM_TELEMETRY_DIR`` first,
    then the working directory and this checkout, each followed by its
    ``.csmom_scratch`` directory."""
    if explicit_root:
        return [explicit_root]
    roots: list = []
    env_dir = os.environ.get("CSMOM_TELEMETRY_DIR")
    if env_dir:
        roots.append(env_dir)
    for base in (os.getcwd(), _REPO):
        roots += [base, os.path.join(base, _SCRATCH_DIRNAME)]
    return roots


def _locate(run: str, root: str | None) -> str | None:
    if os.path.isfile(run):
        return run
    for r in _search_roots(root):
        for pat in (f"GPU_TRACE_{run}.json", f"GPU_TRACE_*{run}*.json"):
            hits = sorted(glob.glob(os.path.join(r, pat)))
            if hits:
                return hits[0]
    return None


def _fmt_ms(v) -> str:
    return f"{v:>9.3f}" if isinstance(v, (int, float)) else f"{'—':>9}"


def _print_stages(obj: dict) -> None:
    stages = obj.get("stages") or {}
    if not stages:
        print("\n(no complete traces: no stage decomposition)")
        return
    # request-path order first, anything else after
    from csmom_tpu_torch.obs.trace import STAGES

    order = [s for s in STAGES if s in stages]
    order += [s for s in sorted(stages) if s not in order]
    print("\nper-stage decomposition (ms, complete traces):")
    print(f"  {'stage':<12} {'count':>6} {'p50':>9} {'p95':>9} "
          f"{'p99':>9} {'max':>9} {'total_s':>9}")
    for name in order:
        s = stages[name]
        print(f"  {name:<12} {s.get('count', 0):>6} "
              f"{_fmt_ms(s.get('p50'))} {_fmt_ms(s.get('p95'))} "
              f"{_fmt_ms(s.get('p99'))} {_fmt_ms(s.get('max_ms'))} "
              f"{s.get('total_s', 0.0):>9.3f}")


def _print_slowest(obj: dict, top: int) -> None:
    slowest = obj.get("slowest") or []
    if not slowest:
        return
    print(f"\ncritical path of the slowest {min(top, len(slowest))} "
          "complete request(s):")
    for e in slowest[:top]:
        attrs = e.get("attrs") or {}
        bits = [f"{e.get('endpoint')}/{e.get('class')}"]
        if attrs.get("fire_reason"):
            bits.append(f"fire={attrs['fire_reason']}")
        if attrs.get("bucket"):
            bits.append(f"bucket={attrs['bucket']}")
        if attrs.get("mesh_shards"):
            bits.append(f"shards={attrs['mesh_shards']}"
                        f"/{attrs.get('mesh_devices')}d")
        if attrs.get("worker"):
            bits.append(f"worker={attrs['worker']}")
        print(f"  {e.get('trace_id')}  wall {e.get('wall_ms')} ms  "
              f"[{', '.join(bits)}]")
        ranked = sorted((e.get("stages") or {}).items(),
                        key=lambda kv: -(kv[1] or 0.0))
        wall = e.get("wall_ms") or 0.0
        for stage, ms in ranked:
            share = f" {ms / wall:>6.1%}" if wall else ""
            print(f"      {stage:<12} {_fmt_ms(ms)} ms{share}")


def _print_padding(obj: dict) -> None:
    padding = obj.get("padding") or {}
    if not padding:
        return
    print("\npadding-waste goodput per bucket:")
    print(f"  {'bucket':<28} {'batches':>7} {'used':>8} {'padded':>8} "
          f"{'pad_frac':>8}  fire reasons")
    for key, b in sorted(padding.items()):
        fr = ",".join(f"{k}:{v}" for k, v in
                      sorted((b.get("fire_reasons") or {}).items()))
        print(f"  {key:<28} {b.get('batches', 0):>7} "
              f"{b.get('used_lanes', 0):>8} {b.get('pad_lanes', 0):>8} "
              f"{b.get('pad_fraction', 0.0):>8.4f}  {fr}")


def _print_books(obj: dict) -> None:
    books = obj.get("books") or {}
    print(f"\ntrace books: opened {books.get('opened')} = complete "
          f"{books.get('complete')} + partial {books.get('partial')}")
    for reason, n in sorted((books.get("partial_reasons") or {}).items()):
        print(f"  partial x{n}: {reason}")
    orphans = obj.get("orphans") or {}
    if orphans.get("count"):
        print(f"orphan halves: {orphans['count']} (dispatches whose "
              "worker died before replying — closed with reason):")
        for reason, n in sorted((orphans.get("reasons") or {}).items()):
            print(f"  x{n}: {reason}")
    else:
        print("orphan halves: 0")
    rec = obj.get("reconcile") or {}
    print(f"reconcile: {rec.get('checked')} trace(s), max residual "
          f"{rec.get('max_abs_residual_ms')} ms (epsilon "
          f"{rec.get('epsilon_ms')} ms), violations "
          f"{rec.get('violations')}")
    classes = obj.get("classes") or {}
    if classes:
        print("per-class SLO error-budget burn "
              f"(target {next(iter(classes.values())).get('slo_target')}):")
        for name, book in sorted(classes.items()):
            burn = book.get("budget_burn")
            verdict = ("—" if burn is None
                       else "within budget" if burn <= 1.0 else "BURNING")
            print(f"  {name:<12} served {book.get('served'):>5}  "
                  f"violations {book.get('violations'):>4}  p99 "
                  f"{_fmt_ms((book.get('latency_ms') or {}).get('p99'))} "
                  f"ms vs budget {_fmt_ms(book.get('budget_ms'))} ms  "
                  f"burn {burn if burn is not None else '—'} "
                  f"[{verdict}]")


def cmd_trace(args) -> int:
    """Render a run's GPU_TRACE_<run>.json: per-stage p50/p99 decomposition,
    slowest-k critical paths, padding goodput per bucket, closed books."""
    path = _locate(args.run, args.root)
    if path is None:
        print(f"error: no trace artifact matches {args.run!r} (looked for "
              "a file path, then GPU_TRACE_<run>.json in "
              f"{args.root or '. and the repository root'}).  Capture one "
              "with `loadgen --trace` (add --pool or --fabric for the "
              "stitched multi-process decomposition).", file=sys.stderr)
        return 2
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: unreadable trace artifact {path}: {e}",
              file=sys.stderr)
        return 2
    violations = inv.validate(obj, "trace")
    if args.json:
        json.dump(obj, sys.stdout, indent=1)
        print()
    else:
        print(f"[{os.path.relpath(path)}]")
        print(f"run {obj.get('run_id')}  platform "
              f"{(obj.get('extra') or {}).get('platform')}  "
              f"fresh compiles in window "
              f"{(obj.get('compile') or {}).get('in_window_fresh_compiles')!r}")
        wl = (obj.get("extra") or {}).get("workload")
        if wl:
            print(f"workload: {wl}")
        try:
            _print_books(obj)
            _print_stages(obj)
            _print_slowest(obj, args.top)
            _print_padding(obj)
        except Exception as e:  # a damaged artifact must still get its
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
    """Attach the ``trace`` subparser."""
    sp = sub.add_parser(
        "trace",
        help="render a run's GPU_TRACE_<run>.json request-path decomposition "
             "(per-stage p99s, slowest-request critical paths, padding "
             "goodput, closed trace books)",
    )
    sp.add_argument("run",
                    help="trace artifact path or run id (resolved as "
                         "GPU_TRACE_<run>.json in . and the repository "
                         "root)")
    sp.add_argument("--root", help="artifact directory (default: cwd, "
                                   "then the repository checkout)")
    sp.add_argument("--top", type=int, default=8,
                    help="slowest traces to break down (default 8)")
    sp.add_argument("--json", action="store_true",
                    help="dump the artifact object instead of rendering")
    sp.set_defaults(fn=cmd_trace)
