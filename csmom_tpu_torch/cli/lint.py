"""``lint``: run the static-analysis sweep over the port.

Counterpart of ``csmom lint``.  Runs every registered kind-``lint`` rule
over the port's package (:func:`csmom_tpu_torch.analysis.default_sources`)
in one parse per file; ``--project`` adds the whole-program rules
(lock-order, compile-surface) on the project call graph.  Exit 0 means
the tree is clean (no unsuppressed finding; a stale pragma counts as
one); exit 1 names every defect as ``path:line: [rule] message``; an
unknown ``--rule`` exits 2.

``--format`` selects the output:

- ``text`` (default): the findings and a per-rule timing line;
- ``json``: the schema_version-2 report (project flag, per-finding call
  chains, cache stats, rule timings); ``--json`` is an alias;
- ``github``: ``::error file=...,line=...`` workflow annotations.

The incremental cache (``build/csmom_tpu_torch/lint_cache/``, keyed by
content digest) makes a sweep of an unchanged tree nearly free;
``--no-cache`` bypasses it.  The sweep's wall time lands on the
``lint.sweep_s`` gauge (:mod:`csmom_tpu_torch.obs.metrics`) when
telemetry is armed.  The command computes nothing on a device and
imports no torch.
"""

from __future__ import annotations

import sys

__all__ = ["cmd_lint", "register"]


def _print_github(report) -> None:
    for f in report.findings:
        # one line per finding; newlines would break the annotation
        msg = f.message.replace("\n", " ")
        print(f"::error file={f.path},line={f.line},"
              f"title=lint:{f.rule}::{msg}")
    print(f"{len(report.findings)} finding(s) over {report.files} "
          f"file(s)")


def cmd_lint(args) -> int:
    """Run the registered static-analysis rules over the tree."""
    from csmom_tpu_torch.analysis import run_lint
    from csmom_tpu_torch.obs import metrics
    from csmom_tpu_torch.registry import lint_rules
    from csmom_tpu_torch.utils.deadline import mono_now_s

    if getattr(args, "rules_list", False):
        specs = lint_rules()
        for spec in specs:
            scope = getattr(spec.rule_cls, "scope", "file")
            print(f"{spec.name}" + ("  [project]"
                                    if scope == "project" else ""))
            print(f"    {spec.description}")
        print(f"\n{len(specs)} rules registered (kind 'lint'): register "
              "one more with register_engine(name=..., kind='lint', "
              "rule_cls=...) and it joins this sweep, tier-1 and the "
              "fixture self-test with no other file edited")
        return 0
    # an explicit --format always wins; --json is only a default-filler
    # alias (``--format github --json`` must not silently emit JSON)
    fmt = (getattr(args, "format", None)
           or ("json" if getattr(args, "json", False) else "text"))
    t0 = mono_now_s()
    try:
        report = run_lint(paths=args.paths or None, rule=args.rule,
                          project=getattr(args, "project", False),
                          cache=not getattr(args, "no_cache", False),
                          timer=mono_now_s)
    except KeyError as e:
        print(str(e).strip('"'), file=sys.stderr)
        return 2
    sweep_s = mono_now_s() - t0
    metrics.gauge("lint.sweep_s").set(round(sweep_s, 6))
    if fmt == "json":
        print(report.to_json())
        return 0 if report.ok else 1
    if fmt == "github":
        _print_github(report)
        return 0 if report.ok else 1
    for f in report.findings:
        print(f)
    cache = report.cache
    cache_txt = (
        f"cache {cache['hits']} hit/{cache['misses']} miss"
        + ("+project" if cache.get("project_hit") else "")
        if cache.get("enabled") else "cache off")
    print(f"{len(report.findings)} finding(s) over {report.files} "
          f"file(s); {len(report.suppressed)} suppressed by pragma "
          f"({len(report.rules)} rules"
          + (", project scope" if report.project else "")
          + f"; {cache_txt}; {sweep_s:.2f}s)")
    if report.rule_timings_s:
        slowest = sorted(report.rule_timings_s.items(),
                         key=lambda kv: -kv[1])
        print("per-rule: " + ", ".join(
            f"{rid} {s * 1000:.0f}ms" for rid, s in slowest))
    if not report.ok:
        print("fix the findings or, for a justified exception, add "
              "`lint: allow" + "[<rule>] <reason>` on (or directly "
              "above) the offending line; unused pragmas fail the "
              "sweep too", file=sys.stderr)
    return 0 if report.ok else 1


def register(sub) -> None:
    """Attach the ``lint`` subparser."""
    sp = sub.add_parser(
        "lint",
        help="run the static-analysis sweep: the registered rules for "
             "clock/lock/dial/enumeration discipline, plus the "
             "whole-program lock-order and compile-surface rules with "
             "--project (tier-1 runs it)",
    )
    sp.add_argument("--format", choices=("text", "json", "github"),
                    help="output format: human text (default), the "
                         "schema_version-2 JSON report, or GitHub "
                         "workflow annotations (::error file=...)")
    sp.add_argument("--json", action="store_true",
                    help="alias for --format json")
    sp.add_argument("--project", action="store_true",
                    help="add the whole-program rules (lock-order, "
                         "compile-surface) on the project call graph")
    sp.add_argument("--no-cache", action="store_true",
                    help="bypass the incremental sweep cache "
                         "(build/csmom_tpu_torch/lint_cache/)")
    sp.add_argument("--rule", metavar="ID",
                    help="run only this rule id (see --rules)")
    sp.add_argument("--paths", nargs="+", metavar="PATH",
                    help="files or directories to scan (default: the "
                         "port's package)")
    sp.add_argument("--rules", dest="rules_list", action="store_true",
                    help="list the registered rules and exit")
    sp.set_defaults(fn=cmd_lint)
