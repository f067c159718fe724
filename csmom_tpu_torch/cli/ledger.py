"""``ledger``: the port's cross-run perf trajectory, diffed and gated.

Counterpart of ``csmom_tpu.cli.ledger`` over the port's ``GPU_*`` round
artifacts (default root: the checkout this package lives in).  Four
subcommands:

``ledger show [--markdown] [--metric SUBSTR] [--run rNN]``
    The normalized trajectory table: every metric's per-run values with
    platform / device kind / workload fingerprint / provenance flags.
    ``--markdown`` emits the tables ``roadmap`` splices.

``ledger roadmap [--write]``
    Regenerate the span of a markdown file between the port's
    ``gpu-trajectory-tables`` markers, in place.  A file without them
    (ROADMAP.md, whose span is the JAX package's) is refused with exit 1
    and left unchanged.

``ledger diff rA rB [--device {cuda,cpu}]``
    Per-metric verdicts between two runs.  Metrics whose rows carry raw
    repeat samples get a block-bootstrap CI on each side, computed on the
    device, and an interval-overlap verdict
    (:mod:`csmom_tpu_torch.obs.regress`); everything else gets a point
    delta labeled as such.

``ledger gate [--offline] [--device {cuda,cpu}]``
    Nonzero exit iff the newest run shows a confirmed regression
    (disjoint CIs in the bad direction, change past ``--min-rel``) or
    unexplained memory growth (same shape, same backend, more bytes than
    ``--mem-tol`` allows).  Point-delta drifts surface as ``suspect`` but
    never fail the gate.  ``--offline`` states the contract: the gate
    reads committed artifacts only and never launches a measurement.

``show`` and ``roadmap`` compute nothing on a device.  ``diff`` and
``gate`` run their bootstraps on the card unless ``--device cpu`` is
given; with no card the command exits 2 before reading anything.  The
reference pins its bootstrap to the CPU; the port has no such pin.
"""

from __future__ import annotations

import os
import re
import sys

from csmom_tpu_torch.cli.main import PROG

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["ROADMAP_BEGIN", "ROADMAP_END", "cmd_ledger", "diff_pairs",
           "register", "roadmap_rows", "splice_roadmap"]


def _fmt_v(v: float) -> str:
    return f"{v:,.6g}"


def _fmt_ci(side: dict) -> str:
    if "lo" in side:
        return (f"{_fmt_v(side['point'])} "
                f"[{_fmt_v(side['lo'])}, {_fmt_v(side['hi'])}] "
                f"(n={side['n']})")
    return f"{_fmt_v(side['point'])} (n={side.get('n', 1)})"


def _load(args):
    from csmom_tpu_torch.obs import ledger as ld

    root = os.path.abspath(args.root)
    if not os.path.isdir(root):
        print(f"error: ledger root {root} is not a directory", file=sys.stderr)
        return None
    L = ld.load(root)
    if not L.rows and not L.problems:
        print(f"error: no round artifacts (GPU_BENCH_*/GPU_MULTICHIP_*/"
              f"GPU_TELEMETRY_*/GPU_SERVE_* ...) under {root} — point "
              f"--root at a directory of the port's GPU_* artifacts",
              file=sys.stderr)
        return None
    return L


def _print_problems(L, stream=None) -> None:
    # resolved at call time: a default bound at import would pin the
    # interpreter's original stdout under test capture
    stream = stream if stream is not None else sys.stdout
    if not L.problems:
        return
    print("\nartifact gaps (files that contribute no trajectory rows):",
          file=stream)
    for p in L.problems:
        print(f"  - {p['source']}: {p['note']}", file=stream)


def _markdown_tables(rows, metric_filter: str | None = None) -> str:
    """The generated per-metric markdown tables: one renderer for
    ``ledger show --markdown`` and ``ledger roadmap``, so the spliced
    span and the ad-hoc output can never drift."""
    groups: dict = {}
    for r in rows:
        groups.setdefault(r.metric, []).append(r)
    out = [f"<!-- generated by `{PROG} ledger show --markdown"
           f"{' --metric ' + metric_filter if metric_filter else ''}` -->"]
    for metric in sorted(groups):
        g = sorted(groups[metric], key=lambda r: (r.run_num, r.source))
        better = "lower" if g[0].direction == "lower" else "higher"
        unit = g[0].unit
        out.append(f"\n#### `{metric}` ({unit}, {better} is better)\n")
        out.append("| run | value | platform | workload | samples | flags "
                   "| source |")
        out.append("|---|---|---|---|---|---|---|")
        for r in g:
            wl = (r.workload or "—").replace("|", "/")
            out.append(f"| {r.run} | {_fmt_v(r.value)} | "
                       f"{r.platform or '—'}/{r.device_kind or '—'} | {wl} | "
                       f"{len(r.samples) or '—'} | "
                       f"{', '.join(r.flags) or '—'} | `{r.source}` |")
    return "\n".join(out)


def cmd_show(args) -> int:
    L = _load(args)
    if L is None:
        return 2
    rows = L.rows
    if args.metric:
        rows = [r for r in rows if args.metric in r.metric]
    if args.run:
        from csmom_tpu_torch.obs.ledger import _norm_run

        rows = [r for r in rows if r.run == _norm_run(args.run)]
    if not rows:
        print("error: no ledger rows match the given filters (see "
              f"`{PROG} ledger show` without filters for the full table)",
              file=sys.stderr)
        _print_problems(L, stream=sys.stderr)
        return 1
    if args.markdown:
        print(_markdown_tables(rows, args.metric))
        return 0
    print(f"perf ledger: {len(rows)} rows, runs "
          f"{', '.join(L.runs())}  (root {os.path.relpath(L.root)})")
    groups: dict = {}
    for r in rows:
        groups.setdefault(r.metric, []).append(r)
    for metric in sorted(groups):
        g = sorted(groups[metric], key=lambda r: (r.run_num, r.source))
        better = "lower" if g[0].direction == "lower" else "higher"
        unit = g[0].unit
        print(f"\n{metric}  ({unit}, {better} is better)")
        for r in g:
            sam = f"  samples={len(r.samples)}" if r.samples else ""
            fl = f"  [{', '.join(r.flags)}]" if r.flags else ""
            print(f"  {r.run}  {_fmt_v(r.value):>14}  "
                  f"{(r.platform or '—'):>4}/{r.device_kind or '—'}"
                  f"{sam}{fl}  {r.workload or ''}  <{r.source}>")
    _print_problems(L)
    return 0


# the markers the roadmap subcommand rewrites between: the port's own,
# so it never touches the span of the JAX package's markers
# ("trajectory-tables:begin (csmom ledger roadmap --write)") in
# ROADMAP.md.  A generated span is replaced whole by its generator,
# never hand-edited.
ROADMAP_BEGIN = ("<!-- gpu-trajectory-tables:begin (python -m "
                 "csmom_tpu_torch.cli ledger roadmap --write) -->")
ROADMAP_END = "<!-- gpu-trajectory-tables:end -->"


def splice_roadmap(text: str, tables: str) -> str:
    """Replace the marker-delimited generated-tables span of a markdown
    document with ``tables``; raises ValueError when the markers are
    missing/misordered (a hand-edited file must fail loudly, not get a
    second copy appended)."""
    begin = text.find(ROADMAP_BEGIN)
    end = text.find(ROADMAP_END)
    if begin < 0 or end < 0 or end < begin:
        raise ValueError(
            f"ROADMAP markers missing or misordered: need "
            f"{ROADMAP_BEGIN!r} before {ROADMAP_END!r} around the "
            "generated tables")
    head = text[:begin + len(ROADMAP_BEGIN)]
    tail = text[end:]
    return f"{head}\n\n{tables.strip()}\n\n{tail}"


def roadmap_rows(rows) -> list:
    """The spliced subset: every metric carrying at least one
    gate-pairable (non-info) row.  Pure-info trajectories (phase walls,
    served counts, offered rates) and the per-shape memory-bytes family
    stay visible in ``ledger show`` but would bury the tables a reader
    actually scans."""
    keep = {r.metric for r in rows
            if "info" not in r.flags and r.metric != "mem_peak_bytes"}
    return [r for r in rows if r.metric in keep]


def cmd_roadmap(args) -> int:
    L = _load(args)
    if L is None:
        return 2
    tables = _markdown_tables(roadmap_rows(L.rows))
    path = os.path.abspath(args.roadmap)
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2
    try:
        new = splice_roadmap(text, tables)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.write:
        print(new[new.find(ROADMAP_BEGIN):new.find(ROADMAP_END)
                  + len(ROADMAP_END)])
        print(f"\n(dry run: `{PROG} ledger roadmap --write` rewrites "
              f"{os.path.relpath(path)} in place)", file=sys.stderr)
        return 0
    if new == text:
        print(f"{os.path.relpath(path)}: generated tables already "
              "current")
        return 0
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(new)
    os.replace(tmp, path)
    print(f"{os.path.relpath(path)}: regenerated the trajectory tables "
          f"({len(L.rows)} ledger rows)")
    return 0


def _verdict_for(cand, ref, args) -> dict:
    import zlib

    from csmom_tpu_torch.obs import regress

    if cand.metric == "mem_peak_bytes":
        return regress.compare_memory(int(cand.value), int(ref.value),
                                      tol_rel=args.mem_tol)
    # bootstrap seed derives from the comparability key, not from the
    # enumeration position: an unrelated artifact landing must not shift
    # another metric's resample stream and flip a borderline CI verdict
    seed = zlib.crc32(repr(cand.key()).encode()) & 0xFFFF
    return regress.compare(
        cand.value, ref.value,
        cand_samples=cand.samples, ref_samples=ref.samples,
        direction=cand.direction, min_rel=args.min_rel,
        suspect_rel=args.suspect_rel, seed=seed, device=args.device,
    )


def _print_verdict(cand, ref, v) -> None:
    mark = {"regression": "FAIL", "memory-growth": "FAIL",
            "improvement": "ok+", "suspect": "warn"}.get(v["verdict"], "ok")
    rel = v.get("rel_change")
    rel_s = f"{rel:+.1%}" if isinstance(rel, float) and abs(rel) != float(
        "inf") else str(rel)
    print(f"[{mark:>4}] {cand.metric}  ({cand.unit}, {cand.direction} is "
          f"better)  {v['verdict']}  {rel_s}")
    print(f"       key: platform={cand.platform}/{cand.device_kind}  "
          f"workload={cand.workload or '—'}")
    print(f"       {ref.run}: {_fmt_ci(v['reference'])}   ->   "
          f"{cand.run}: {_fmt_ci(v['candidate'])}   [{v['basis']}]")
    # footnotes: documented costs ride the verdict, asymmetries ride
    # loudest — a note present on only one side means the two rows were
    # captured under different provenance (e.g. observatory armed vs
    # not) and the delta includes that documented cost
    cn, rn = set(getattr(cand, "notes", ())), set(getattr(ref, "notes", ()))
    for n in sorted(cn | rn):
        side = ("both" if n in cn and n in rn
                else f"{cand.run} only" if n in cn else f"{ref.run} only")
        print(f"       note[{n}]: {side}" + (
            " — delta includes this documented cost" if side != "both"
            else ""))


def _pair(a, b):
    """The best like-for-like pair: rows only compare when their
    provenance flags are IDENTICAL (a session capture's weaker timing vs
    a live row is exactly the silent cross-provenance verdict the ledger
    exists to prevent).  Unflagged live pairs win; else any shared
    flag-set (watcher-vs-watcher is a valid comparison); else no pair."""
    shared = {r.flags for r in a} & {r.flags for r in b}
    if not shared:
        return None
    flags = min(shared, key=lambda f: (f != (), str(f)))
    return ([r for r in a if r.flags == flags][-1],
            [r for r in b if r.flags == flags][-1])


def diff_pairs(L, run_a: str, run_b: str):
    """``(rows of run_a, rows of run_b, (ref, cand) or None)`` for every
    comparability key both runs have, in the order ``diff`` prints them;
    None where no identical flag-set pairs them."""
    for _, rows in sorted(L.by_key().items(), key=str):
        a = [r for r in rows if r.run == run_a]
        b = [r for r in rows if r.run == run_b]
        if a and b:
            yield a, b, _pair(a, b)


def cmd_diff(args) -> int:
    from csmom_tpu_torch.obs.ledger import _norm_run

    L = _load(args)
    if L is None:
        return 2
    run_a, run_b = _norm_run(args.run_a), _norm_run(args.run_b)
    known = set(L.runs())
    missing = [r for r in (run_a, run_b) if r not in known]
    if missing:
        print(f"error: no ledger rows for run(s) {', '.join(missing)} — "
              f"known runs: {', '.join(sorted(known))}", file=sys.stderr)
        return 2
    n = 0
    for a, b, pair in diff_pairs(L, run_a, run_b):
        if pair is None:
            print(f"[skip] {a[-1].metric}: incomparable provenance — "
                  f"{run_a} has [{' / '.join(', '.join(r.flags) or 'live' for r in a)}], "
                  f"{run_b} has [{' / '.join(', '.join(r.flags) or 'live' for r in b)}] "
                  "(no identical flag-set on both sides)")
            continue
        ref, cand = pair
        v = _verdict_for(cand, ref, args)
        _print_verdict(cand, ref, v)
        n += 1
    if n == 0:
        print(f"error: runs {run_a} and {run_b} share no comparable "
              "(metric, platform, device, workload) key — nothing to diff "
              "(cpu rows never compare against gpu rows)",
              file=sys.stderr)
        return 1
    print(f"\n{n} comparable metric key(s) between {run_a} and {run_b}")
    return 0


def cmd_gate(args) -> int:
    from csmom_tpu_torch.obs import regress
    from csmom_tpu_torch.obs.ledger import _norm_run

    L = _load(args)
    if L is None:
        return 2
    eligible = [r for r in L.rows if r.gate_eligible()]
    if not eligible:
        print("gate: no gate-eligible (unflagged) rows in the "
              "ledger — nothing to regress against; PASS by vacuity")
        _print_problems(L)
        return 0
    candidate = (_norm_run(args.candidate) if args.candidate
                 else max(eligible, key=lambda r: r.run_num).run)
    if not re.fullmatch(r"r\d+", candidate):
        print(f"error: --candidate {args.candidate!r} is not a run id "
              "(expected rNN, e.g. r05)", file=sys.stderr)
        return 2
    cand_num = int(candidate.lstrip("r"))
    if not any(r.run == candidate for r in eligible):
        print(f"error: no gate-eligible rows for candidate run "
              f"{candidate}", file=sys.stderr)
        return 2
    failures, suspects, vanished, checked, fresh = [], [], [], 0, 0
    no_samples = []
    for key, rows in sorted(L.by_key().items(), key=str):
        er = [r for r in rows if r.gate_eligible()]
        cand_rows = [r for r in er if r.run == candidate]
        if cand_rows and not cand_rows[-1].samples:
            # a gate-pairable row with no bootstrap samples can only
            # ever earn a point-delta/suspect verdict — the gate must
            # SAY so instead of silently degrading
            no_samples.append(cand_rows[-1])
        if not cand_rows:
            # a key the reference history measured but the candidate
            # did not: could be a budget skip — or a leg that now FAILS
            # outright (bench records a reason string, which yields no
            # row).  Not a confirmable regression without a number, but
            # it must never vanish silently from the gate report.
            prior = [r for r in er if r.run_num < cand_num]
            if prior:
                vanished.append(prior[-1])
            continue
        cand = cand_rows[-1]
        refs = [r for r in er if r.run_num < cand_num]
        if not refs:
            fresh += 1
            continue  # first observation of this key: nothing to regress
        ref = refs[-1]
        v = _verdict_for(cand, ref, args)
        checked += 1
        _print_verdict(cand, ref, v)
        if v["verdict"] in regress.GATE_FAILING:
            failures.append((cand, ref, v))
        elif v["verdict"] == "suspect":
            suspects.append((cand, ref, v))
        # ratchet guard: per-PR comparison against the previous run lets
        # sub-tolerance drift COMPOUND (nine +9% rounds pass every gate
        # while doubling the wall).  Also measure against the OLDEST
        # eligible reference and surface cumulative drift as a suspect —
        # visible every round, not gating (growth accepted round by
        # round was accepted; the trajectory just must not hide it).
        if len(refs) >= 2 and v["verdict"] not in regress.GATE_FAILING:
            oldest = refs[0]
            tol = (args.mem_tol if cand.metric == "mem_peak_bytes"
                   else args.suspect_rel)
            cum = regress.compare_points(
                cand.value, oldest.value, direction=cand.direction,
                suspect_rel=tol,
                reason=f"cumulative drift since {oldest.run}",
                n_cand=len(cand.samples), n_ref=len(oldest.samples),
            )
            if cum["verdict"] == "suspect":
                suspects.append((cand, oldest, cum))
    print(f"\ngate over {os.path.relpath(L.root)}: candidate {candidate}, "
          f"{checked} key(s) checked, {fresh} first-seen, "
          f"{len(vanished)} vanished, {len(suspects)} suspect, "
          f"{len(failures)} confirmed failure(s)")
    if vanished:
        print("vanished metrics (measured in an earlier run, absent from "
              "the candidate — a budget skip or a leg that now fails; "
              "check the candidate's FULL record for the reason string):")
        for r in vanished:
            print(f"  - {r.metric} (last measured {r.run}: "
                  f"{_fmt_v(r.value)} {r.unit}; {r.platform}, "
                  f"{r.workload or 'no workload'})")
    if suspects:
        print("suspect drifts (not CI-confirmed — re-measure with raw "
              "samples before trusting either direction):")
        for cand, sref, v in suspects:
            print(f"  - {cand.metric} {v['rel_change']:+.1%} vs {sref.run} "
                  f"({cand.platform}, {cand.workload or 'no workload'}; "
                  f"{v['basis']})")
    if no_samples:
        print(f"sample-coverage gaps ({len(no_samples)} gate-pairable "
              "row(s) without a bootstrap samples array — their verdicts "
              "can never rise above point-delta/suspect; attach per-rep "
              "samples in the producing artifact's extra.samples):")
        for r in no_samples:
            print(f"  - {r.metric} ({r.run}, {r.platform or '—'}, "
                  f"{r.workload or 'no workload'}) <{r.source}>")
    _print_problems(L)
    if failures:
        print("\nGATE FAILED: confirmed regression / unexplained memory "
              "growth — see FAIL lines above", file=sys.stderr)
        return 1
    print("gate PASSED")
    return 0


def cmd_ledger(args) -> int:
    if not getattr(args, "ledger_cmd", None):
        print(f"usage: {PROG} ledger {{show,roadmap,diff,gate}} ... "
              f"(see {PROG} ledger --help)", file=sys.stderr)
        return 2
    return args.ledger_fn(args)


def register(sub) -> None:
    """Attach the ``ledger`` subparser (called from cli.main)."""
    sp = sub.add_parser(
        "ledger",
        help="cross-run perf trajectory over the GPU_* round artifacts: "
             "show the table, diff two runs with bootstrap CIs, gate a "
             "change on confirmed regressions",
    )
    lsub = sp.add_subparsers(dest="ledger_cmd")

    show = lsub.add_parser("show", help="print the per-metric trajectory "
                                        "table (--markdown for docs)")
    show.add_argument("--root", default=_REPO,
                      help="artifact directory (default: this repo checkout)")
    show.add_argument("--markdown", action="store_true",
                      help="emit markdown tables (what `ledger roadmap` "
                           "splices)")
    show.add_argument("--metric", help="only metrics containing SUBSTR")
    show.add_argument("--run", help="only this run's rows")
    show.set_defaults(ledger_fn=cmd_show)

    # thresholds are single-sourced from obs.regress (the module whose
    # verdicts they parameterize); it imports torch only to bootstrap
    from csmom_tpu_torch.obs.regress import (
        DEFAULT_MEM_TOL,
        DEFAULT_MIN_REL,
        DEFAULT_SUSPECT_REL,
    )

    def _thresholds(sp_):
        sp_.add_argument("--min-rel", dest="min_rel", type=float,
                         default=DEFAULT_MIN_REL,
                         help="practical-significance floor for a "
                              "confirmed CI verdict (default "
                              f"{DEFAULT_MIN_REL})")
        sp_.add_argument("--suspect-rel", dest="suspect_rel", type=float,
                         default=DEFAULT_SUSPECT_REL,
                         help="point-delta drift worth flagging as "
                              f"suspect (default {DEFAULT_SUSPECT_REL})")
        sp_.add_argument("--mem-tol", dest="mem_tol", type=float,
                         default=DEFAULT_MEM_TOL,
                         help="tolerated relative memory growth "
                              f"(default {DEFAULT_MEM_TOL})")

    def _device(sp_):
        sp_.add_argument("--device", choices=["cuda", "cpu"],
                         default="cuda",
                         help="where the bootstrap CIs are computed "
                              "(default cuda; exits 2 without a card)")

    roadmap = lsub.add_parser(
        "roadmap",
        help="regenerate a markdown file's gpu-trajectory-tables span "
             "from the GPU_* round artifacts (refuses a file without "
             "the port's markers)")
    roadmap.add_argument("--root", default=_REPO,
                         help="artifact directory (default: this repo "
                              "checkout)")
    roadmap.add_argument("--roadmap",
                         default=os.path.join(_REPO, "ROADMAP.md"),
                         help="the markdown file carrying the port's "
                              "markers (default: ROADMAP.md at the repo "
                              "root, which carries none and is refused)")
    roadmap.add_argument("--write", action="store_true",
                         help="rewrite the file in place (default: print "
                              "the regenerated span, change nothing)")
    roadmap.set_defaults(ledger_fn=cmd_roadmap)

    diff = lsub.add_parser("diff", help="CI-aware per-metric verdicts "
                                        "between two runs")
    diff.add_argument("run_a", help="reference run (e.g. r04)")
    diff.add_argument("run_b", help="candidate run (e.g. r05)")
    diff.add_argument("--root", default=_REPO)
    _thresholds(diff)
    _device(diff)
    diff.set_defaults(ledger_fn=cmd_diff)

    gate = lsub.add_parser("gate", help="exit nonzero on a confirmed "
                                        "regression or unexplained memory "
                                        "growth in the newest run")
    gate.add_argument("--root", default=_REPO)
    gate.add_argument("--offline", action="store_true",
                      help="committed-artifacts-only mode (the only mode: "
                           "the flag documents that the gate never "
                           "launches a measurement)")
    gate.add_argument("--candidate", help="run to gate (default: newest "
                                          "gate-eligible run)")
    _thresholds(gate)
    _device(gate)
    gate.set_defaults(ledger_fn=cmd_gate)

    sp.set_defaults(fn=cmd_ledger)
