"""``timeline <run>``: render a run's telemetry sidecar as a text flame
summary.

Counterpart of ``csmom_tpu.cli.timeline``; it prints what ``csmom
timeline`` prints.  It takes a path to a ``GPU_TELEMETRY_*.json``
sidecar, a raw JSONL event stream (assembled on the fly), or a bare run
id (the sidecar is found by glob along
:func:`~csmom_tpu_torch.obs.timeline.sidecar_search_roots`).  Output is
the phase table (where the wall went: warmup/probe/compile/row/land/
other), the top spans by total wall, and the run's final metrics
snapshot; ``--json`` prints the sidecar object instead.  The sidecar is
validated (kind ``telemetry``): exit 0 when valid, 1 on a schema
violation, 2 when no sidecar is found or it is unreadable.  No device
and no torch: rendering evidence never depends on a card.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.obs import timeline as tl

__all__ = ["cmd_timeline", "register"]


def _locate(run: str) -> str | None:
    """Resolve a run argument to a sidecar or event-stream path, along
    ``obs.timeline.sidecar_search_roots`` (the list ``trace`` and
    ``fleet`` search too)."""
    if os.path.isfile(run):
        return run
    hits: list = []
    for root in tl.sidecar_search_roots():
        hits += sorted(glob.glob(os.path.join(root,
                                              f"GPU_TELEMETRY_*{run}*.json")))
        hits += sorted(glob.glob(os.path.join(root, f"GPU_TELEMETRY_{run}")))
    return hits[0] if hits else None


def cmd_timeline(args) -> int:
    """Render a run's telemetry sidecar (or raw event stream) as a text
    flame summary."""
    path = _locate(args.run)
    if path is None:
        print(
            f"error: no GPU_TELEMETRY sidecar matches {args.run!r} (looked "
            "for a file path, then GPU_TELEMETRY_*<run>*.json in "
            "$CSMOM_TELEMETRY_DIR, . and the repo root and their "
            ".csmom_scratch).  Runs emit one when telemetry is armed "
            "(CSMOM_TELEMETRY; rehearse arms it by default).",
            file=sys.stderr,
        )
        return 2
    if path.endswith((".jsonl", ".events")):
        events = tl.read_events(path)
        # a reused (append-mode) stream can carry several runs; render
        # the most recent one rather than a blended timeline that
        # corresponds to none of them
        runs = [e.get("run") for e in events if e.get("run")]
        latest = runs[-1] if runs else None
        if len(set(runs)) > 1:
            print(
                f"note: stream carries {len(set(runs))} runs; rendering "
                f"the most recent ({latest!r})", file=sys.stderr,
            )
        obj = tl.assemble(events, run_id=latest)
    else:
        try:
            obj = tl.load_sidecar(path)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: unreadable sidecar {path}: {e}", file=sys.stderr)
            return 2
    violations = inv.validate(obj, "telemetry")
    if args.json:
        json.dump(obj, sys.stdout, indent=1)
        print()
    else:
        print(f"[{os.path.relpath(path)}]")
        try:
            print(tl.render(obj, top=args.top))
        except Exception as e:  # a damaged sidecar must still get its
            print(f"(render failed: {type(e).__name__}: {e} — "  # diagnosis
                  "schema report below)")
    if violations:
        print("\nschema violations (the sidecar is damaged or stale-format):",
              file=sys.stderr)
        for v in violations:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


def register(sub) -> None:
    """Attach the ``timeline`` subparser (called from cli.main)."""
    sp = sub.add_parser(
        "timeline",
        help="render a run's GPU_TELEMETRY_*.json sidecar (phases, top "
             "spans, metrics) as a text flame summary",
    )
    sp.add_argument("run",
                    help="sidecar path, raw .jsonl event stream, or run id "
                         "(globbed as GPU_TELEMETRY_*<run>*.json)")
    sp.add_argument("--top", type=int, default=12,
                    help="span aggregates to show (default 12)")
    sp.add_argument("--json", action="store_true",
                    help="dump the assembled sidecar object instead of "
                         "rendering")
    sp.set_defaults(fn=cmd_timeline)
