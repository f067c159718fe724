"""``replay``: drive a trading day's tick log through the live loop.

Counterpart of ``csmom_tpu.cli.replay``; it prints what ``csmom replay``
prints.  Runs the event-time replay harness
(:mod:`csmom_tpu_torch.stream.replay`): a seeded synthetic tick log ->
watermark ingest -> incremental signal updates -> serving from versioned
snapshots -> periodic full-panel reconciliation, and lands
``GPU_REPLAY_<run>.json`` (kind ``replay`` in
:mod:`csmom_tpu_torch.chaos.invariants`).

Fault injection: ``--chaos builtin`` arms the canonical replay fault
plan (late, out-of-order, duplicate and gap ticks, one ingest-serve
version-skew event); ``--chaos PATH_OR_TOML`` arms a custom plan; a
plan already armed through ``CSMOM_FAULT_PLAN`` is honored as is.  The
run must keep both closed books (ticks and serve) and the version
reconciliation, or the command exits 1.

It also exits 1 when a torch-engine replay built or loaded a kernel
library inside the window: build the kernels first
(``python -m csmom_tpu_torch.ops.build``).

The flags that differ from the reference's: ``--engine {torch,stub}``
(default torch, the card engine; the reference's ``jax``) and
``--device {cuda,cpu}`` (default cuda; without a card the command exits
2 naming ``--device cpu``); ``--stub`` needs no device.
"""

from __future__ import annotations

import json
import os
import sys

__all__ = ["cmd_replay", "register"]


def _arm_chaos(args, cfg) -> dict | None:
    """Arm the requested fault plan via the env contract; returns the
    saved env state to restore, or None when nothing was armed."""
    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.chaos.plan import PLAN_ENV

    if not args.chaos:
        return None
    saved = {k: os.environ.get(k) for k in (PLAN_ENV, "CSMOM_FAULT_STATE")}
    if args.chaos == "builtin":
        from csmom_tpu_torch.stream.replay import builtin_fault_plan

        plan = builtin_fault_plan(cfg)
        os.environ[PLAN_ENV] = plan.to_toml()
    else:
        os.environ[PLAN_ENV] = args.chaos
    inject.reset()  # re-read the plan with fresh hit counters
    return saved


def _restore_chaos(saved: dict | None) -> None:
    from csmom_tpu_torch.chaos import inject

    if saved is None:
        return
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    inject.reset()


def cmd_replay(args) -> int:
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.stream.replay import (
        ReplayConfig,
        run_replay,
        write_artifact,
    )

    smoke = bool(args.smoke)
    engine = "stub" if args.stub else args.engine
    # full-mode preset first, explicit flags override it (merged BEFORE
    # unpacking: two ** expansions sharing a key is a TypeError)
    kw = {} if smoke else {"n_assets": 32, "bars": 96,
                           "serve_every_bars": 6,
                           "reconcile_every_bars": 16}
    if args.assets is not None:
        kw["n_assets"] = args.assets
    if args.bars is not None:
        kw["bars"] = args.bars
    if args.capacity is not None:
        kw["capacity"] = args.capacity
    cfg = ReplayConfig(
        run_id=args.run_id,
        seed=args.seed,
        engine=engine,
        device=None if engine == "stub" else args.device,
        profile="serve-smoke" if smoke else "serve",
        **kw,
    )
    saved = _arm_chaos(args, cfg)
    try:
        art = run_replay(cfg)
    finally:
        _restore_chaos(saved)

    out_dir = args.out_dir or os.getcwd()
    path = write_artifact(out_dir, art, prefix="GPU_REPLAY")
    print(f"landed {path}")

    violations = inv.validate(art, "replay")
    t = art["ticks"]
    v = art["versions"]
    print(
        f"ticks: offered {t['offered']} = applied {t['applied']} + "
        f"merged_late {t['merged_late']} + quarantined "
        f"{t['quarantined']} + deduped {t['deduped']} "
        f"(gap bars {art['panel']['gap_bars']}, dup {t['duplicated']}, "
        f"dropped {t['dropped_gap']})"
    )
    print(
        f"versions: ingest v{v['ingest_final']}, served "
        f"[{v['serve_min']}, {v['serve_max']}]; skew: {v['skew_events']} "
        f"event(s), {v['skew_refusals']}/{v['skew_attempts']} stale "
        "request(s) refused"
    )
    print(f"reconcile: {art['reconcile']}")
    fresh = art["compile"]["in_window_fresh_compiles"]
    print(f"throughput: {art['value']} {art['unit']}; in-window fresh "
          f"compiles: {fresh}")
    if isinstance(fresh, int) and fresh > 0:
        violations.append(
            f"{fresh} kernel library build(s) or load(s) inside the replay "
            "window: the warm-up missed a kernel the window ran; build the "
            "kernels first (python -m csmom_tpu_torch.ops.build)")
    if violations:
        print("\nreplay artifact violates its own invariants:",
              file=sys.stderr)
        for viol in violations:
            print(f"  - {viol}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"metric": art["metric"], "value": art["value"],
                          "unit": art["unit"],
                          "vs_baseline": art["vs_baseline"]}))
    return 0


def register(sub) -> None:
    """Attach the ``replay`` subparser."""
    sp = sub.add_parser(
        "replay",
        help="replay a trading day's tick log through ingest -> "
             "incremental signals -> serve, deterministically and "
             "chaos-injectably; lands GPU_REPLAY_<run>.json",
    )
    sp.add_argument("--run-id", dest="run_id", default="smoke",
                    help="artifact run id: GPU_REPLAY_<run-id>.json")
    sp.add_argument("--seed", type=int, default=12,
                    help="tick-log + fault seed (default 12)")
    sp.add_argument("--engine", default="torch", choices=["torch", "stub"],
                    help="serve/reconcile backend (default torch, the card "
                         "engine)")
    sp.add_argument("--stub", action="store_true",
                    help="shortcut for --engine stub (no device)")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch engine serves and reconciles "
                         "(default cuda; without a card the command exits "
                         "2 — pass --device cpu, or --stub)")
    sp.add_argument("--smoke", action="store_true",
                    help="smoke preset: tiny panel, smoke serve buckets, "
                         "sub-second — the tier-1 shape")
    sp.add_argument("--assets", type=int,
                    help="universe size (default: 32 full / 8 smoke)")
    sp.add_argument("--capacity", type=int,
                    help="ring capacity in bars (default: 3/4 of the "
                         "log, floored at the serve window — the ring "
                         "WRAPS by default so the window-slide "
                         "reconcile path is always exercised; pass "
                         "capacity == bars for a non-evicting ring)")
    sp.add_argument("--bars", type=int,
                    help="bars in the day (default: 96 full / 32 smoke)")
    sp.add_argument("--chaos", metavar="PLAN",
                    help="'builtin' for the canonical replay fault plan "
                         "(late/ooo/dup/gap ticks + one version skew), "
                         "or a fault-plan path / inline TOML")
    sp.add_argument("--out-dir", dest="out_dir",
                    help="artifact directory (default: cwd)")
    sp.add_argument("--json", action="store_true",
                    help="also print a record-shaped headline line")
    sp.set_defaults(fn=cmd_replay)
