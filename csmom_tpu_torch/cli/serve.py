"""``serve`` and ``loadgen``: the serving tier's commands, in-process.

Counterpart of ``csmom_tpu.cli.serve``'s in-process half; each prints
what ``csmom`` prints.  ``serve`` starts the micro-batching signal
service (:mod:`csmom_tpu_torch.serve`), warms every bucket shape,
prints the readiness report, runs a self-probe of every endpoint, then
serves until ``--duration`` elapses (0 = until Ctrl-C) and prints the
request accounting.  ``loadgen`` drives an in-process service with the
seeded open-loop generator and lands ``GPU_SERVE_<run>.json``; it exits
1 when the artifact fails its own invariants or when a kernel was built
inside the serving window.

The flags that differ from the reference's:

- ``--device {cuda,cpu}`` (default cuda) takes the place of
  ``--platform``; ``--stub`` needs no device at all;
- the cold-cache gate: with the torch engine on cuda, every kernel the
  serve path launches must already have its library in
  ``build/csmom_tpu_torch/`` (``ops/build.py::library_path``), else the
  command exits 3 (``--allow-cold-cache`` accepts the build pause);
- ``--reuse-fraction`` sets the in-process run's panel reuse;
- the multi-process, fabric, fleet, tracing and mesh flags are not
  ported yet: each exits 2 naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import os
import sys

__all__ = ["cmd_loadgen", "cmd_serve", "register"]

# flags of the reference's serving tier the port does not have yet, by
# the ROADMAP.md Queue 1 item that brings them: (dest, flag, item)
_DEFERRED = (
    ("workers", "--workers", "6b, the multi-process pool"),
    ("pool", "--pool", "6b, the multi-process pool"),
    ("hedge_fraction", "--hedge-fraction", "6b, the multi-process pool"),
    ("kill_worker_after", "--kill-worker-after", "6b, the multi-process pool"),
    ("fabric", "--fabric", "6c, the fabric and fleet"),
    ("routers", "--routers", "6c, the fabric and fleet"),
    ("transport", "--transport", "6c, the fabric and fleet"),
    ("kill_router_after", "--kill-router-after", "6c, the fabric and fleet"),
    ("fleet", "--fleet", "6c, the fabric and fleet"),
    ("spares", "--spares", "6c, the fabric and fleet"),
    ("autoscale", "--autoscale", "6c, the fabric and fleet"),
    ("prefork", "--prefork", "6c, the fabric and fleet"),
    ("trace", "--trace", "6d, tracing and replay"),
    ("mesh", "--mesh", "7, the multi-GPU layer"),
    ("devices_per_worker", "--devices-per-worker", "7, the multi-GPU layer"),
)


def _deferred_flag(args) -> int:
    """Exit code 2 with the item named when a deferred flag was given."""
    for dest, flag, item in _DEFERRED:
        if getattr(args, dest, None) not in (None, False):
            print(f"{flag} is not ported yet (ROADMAP.md, Queue 1 item "
                  f"{item}); the port serves in-process only",
                  file=sys.stderr)
            return 2
    return 0


def _mk_service(args):
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    profile = args.profile or ("serve-smoke" if getattr(args, "smoke", False)
                               else "serve")
    cfg = ServeConfig(
        profile=profile,
        engine="stub" if args.stub else "torch",
        device=None if args.stub else args.device,
        capacity=args.capacity,
        max_wait_s=args.max_wait_ms / 1e3,
        # unset --deadline-ms = the SLO class budgets; 0 = no default
        # deadline; an explicit value wins for every class
        default_deadline_s=("class" if args.deadline_ms is None
                            else None if args.deadline_ms == 0
                            else args.deadline_ms / 1e3),
    )
    return SignalService(cfg)


def _check_cache_honesty(args) -> int:
    """The cold-cache gate: on the card, refuse to 'be ready' by building
    a kernel inside the readiness probe — exit 3 with the build pointer
    instead.  Returns 0 when serving may proceed."""
    if args.stub or args.device == "cpu" or args.allow_cold_cache:
        return 0
    from csmom_tpu_torch.ops import build
    from csmom_tpu_torch.serve.engine import KERNELS

    cold = [n for n in KERNELS if not build.library_path(n).exists()]
    if cold:
        print(f"NOT READY (cold kernel build): no library of "
              f"{', '.join(cold)} in {build.BUILD_DIR}", file=sys.stderr)
        print("readiness is a demonstrated claim — building inside the "
              "ready probe would fake it; build first (python -m "
              "csmom_tpu_torch.ops.build), or pass --allow-cold-cache to "
              "accept the build pause", file=sys.stderr)
        return 3
    print(f"kernel build check: {', '.join(KERNELS)} built in "
          f"{build.BUILD_DIR}")
    return 0


def _print_ready(svc) -> None:
    from csmom_tpu_torch.registry import serve_endpoints

    spec = svc.spec
    print(f"signal service ready: engine {svc.engine.name}, bucket "
          f"profile {spec.name}")
    print(f"  endpoints: {', '.join(serve_endpoints())}")
    print(f"  buckets: B({','.join(map(str, spec.batch_buckets))}) x "
          f"A({','.join(map(str, spec.asset_buckets))}) x {spec.months} "
          f"months ({spec.dtype})")
    print(f"  admission: capacity {svc.config.capacity}, coalesce window "
          f"{svc.config.max_wait_s * 1e3:g} ms, default deadline "
          f"{svc.config.default_deadline_s}")
    print(f"  warmup: {svc.warm_report}")


def cmd_serve(args) -> int:
    """Run the in-process signal service: warm every bucket shape,
    self-probe every endpoint, serve."""
    import time

    import numpy as np

    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.utils.deadline import mono_now_s

    rc = _deferred_flag(args) or _check_cache_honesty(args)
    if rc:
        return rc
    svc = _mk_service(args)
    svc.start()
    _print_ready(svc)

    # a demonstrated "ready": one probe request per endpoint through the
    # full admission -> coalesce -> dispatch path
    spec = svc.spec
    A = spec.asset_buckets[0]
    rng = np.random.default_rng(0)
    probes = []
    for kind in serve_endpoints():
        v = 100.0 * np.exp(np.cumsum(
            rng.normal(0, 0.03, (A, spec.months)), axis=1))
        probes.append(svc.submit(kind, v.astype(np.float32),
                                 np.ones((A, spec.months), bool),
                                 deadline_s=5.0))
    ok = all(p.wait(10.0) and p.state == "served" for p in probes)
    print(f"  self-probe: {'all endpoints served' if ok else 'FAILED'}")
    if not ok:
        svc.stop()
        for p in probes:
            if p.state != "served":
                print(f"    {p.kind}: state={p.state} error={p.error}",
                      file=sys.stderr)
        return 1

    try:
        if args.duration > 0:
            end = mono_now_s() + args.duration
            while mono_now_s() < end:
                time.sleep(min(0.2, max(0.0, end - mono_now_s())))
        else:
            print("serving until interrupted (Ctrl-C) ...")
            while True:
                time.sleep(0.5)
    except KeyboardInterrupt:
        print("\ninterrupted — draining")
    svc.stop(drain=True)
    print(f"accounting: {svc.accounting()}")
    print(f"batches: {svc.batch_stats()}")
    print(f"in-window fresh compiles: {svc.fresh_compiles()}")
    viols = svc.invariant_violations()
    for v in viols:
        print(f"INVARIANT VIOLATION: {v}", file=sys.stderr)
    return 1 if viols else 0


def cmd_loadgen(args) -> int:
    """Open-loop load generation against an in-process service; lands
    GPU_SERVE_<run>.json."""
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        parse_schedule,
        resolve_schedule,
        run_loadgen,
        write_artifact,
    )

    rc = _deferred_flag(args)
    if rc:
        return rc
    if args.smoke:
        raw = args.schedule or "0.8x60"
        run_id = args.run_id or "smoke"
    else:
        raw = args.schedule or "2x40"
        run_id = args.run_id or f"loadgen-{os.getpid()}"
    schedule, schedule_kind, preset = resolve_schedule(raw)
    try:
        parse_schedule(schedule)
    except ValueError as e:
        print(f"--schedule: {e}", file=sys.stderr)
        return 2
    if args.reuse_fraction is not None:
        preset["reuse_fraction"] = args.reuse_fraction
    rc = _check_cache_honesty(args)
    if rc:
        return rc
    svc = _mk_service(args)
    svc.start()
    _print_ready(svc)
    load = LoadConfig(
        schedule=schedule,
        schedule_kind=schedule_kind,
        seed=args.seed,
        deadline_s=(None if args.deadline_ms == 0
                    else 0.5 if args.deadline_ms is None
                    else args.deadline_ms / 1e3),
        run_id=run_id,
        **preset,
    )
    print(f"offering: schedule {schedule_kind} = {schedule} (seed "
          f"{load.seed}, deadline "
          f"{'class budgets' if load.use_class_deadlines else load.deadline_s}"
          ") ...")
    art = run_loadgen(svc, load)
    out_dir = args.out or os.getcwd()
    path = write_artifact(out_dir, art)

    req = art["requests"]
    lat = art["latency_ms"]["total"]
    print(f"\nthroughput: {art['value']} req/s achieved vs "
          f"{art['offered']['offered_rps']} req/s offered over "
          f"{art['wall_s']}s wall"
          + (" (offered-load-limited)" if art["offered_limited"] else ""))
    print(f"requests: admitted {req['admitted']} -> served {req['served']} "
          f"(cache hits {req['served_cache_hits']}, coalesced "
          f"{req['served_coalesced']}), rejected {req['rejected']} "
          f"(queue-full {req['rejected_queue_full']}, quota "
          f"{req['rejected_quota']}, crash "
          f"{req['rejected_worker_crash']}), expired {req['expired']}")
    for name, book in art["classes"].items():
        wb = book["within_budget"]
        print(f"  class {name}: {book['served']}/{book['admitted']} served, "
              f"quota-rejected {book['rejected_quota']}, p99 "
              f"{book['latency_ms']['p99']} ms vs budget "
              f"{book['budget_ms']} ms "
              f"[{'ok' if wb else 'unused' if wb is None else 'BUSTED'}]")
    cache = art["cache"]
    if cache.get("enabled"):
        print(f"cache: hit rate {cache['hit_rate']} ({cache['hits']} hits / "
              f"{cache['lookups']} lookups), stale hits "
              f"{cache['stale_hits']}, stale blocked "
              f"{cache['stale_blocked']}, evictions {cache['evictions']}")
    print(f"latency total ms: p50 {lat['p50']}  p95 {lat['p95']}  "
          f"p99 {lat['p99']}")
    print(f"batches: {art['batches']}")
    print(f"in-window fresh compiles: "
          f"{art['compile']['in_window_fresh_compiles']}")
    print(f"artifact: {path}")

    viols = inv.validate_file(path)
    if viols:
        print("ARTIFACT INVALID:", file=sys.stderr)
        for v in viols:
            print(f"  - {v}", file=sys.stderr)
        return 1
    fresh = art["compile"]["in_window_fresh_compiles"]
    if isinstance(fresh, int) and fresh > 0 and not args.allow_fresh_compiles:
        print(f"error: {fresh} kernel build(s) or load(s) inside the "
              "serving window — a dispatch missed what the warm-up built; "
              "rerun with --allow-fresh-compiles to land anyway",
              file=sys.stderr)
        return 1
    return 0


def _common_flags(sp) -> None:
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch engine scores (default cuda; "
                         "without a card the command exits 2 — pass "
                         "--device cpu for the plain PyTorch versions of "
                         "the kernels, or --stub)")
    sp.add_argument("--profile", choices=["serve", "serve-smoke"],
                    help="bucket grid (default: serve; --smoke implies "
                         "serve-smoke)")
    sp.add_argument("--stub", action="store_true",
                    help="numpy stub engine (no device): plumbing runs")
    sp.add_argument("--capacity", type=int, default=64,
                    help="admission-queue bound (backpressure beyond it; "
                         "default 64)")
    sp.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                    default=10.0,
                    help="micro-batch coalescing window (default 10 ms)")
    sp.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=None,
                    help="default per-request deadline (unset = each "
                         "request inherits its SLO class budget — "
                         "interactive 500 ms / standard 1 s / bulk 3 s; "
                         "an explicit value applies to every class; "
                         "0 = none; a request expiring while queued is "
                         "cancelled, never dispatched)")
    sp.add_argument("--allow-cold-cache", dest="allow_cold_cache",
                    action="store_true",
                    help="serve even when a kernel the serve path "
                         "launches is not built yet (default: exit 3 "
                         "with a build pointer)")
    # the reference's flags the port does not have yet: exit 2
    for flag, kw in (("--workers", dict(type=int)),
                     ("--hedge-fraction", dict(type=float)),
                     ("--mesh", dict(action="store_true", default=None)),
                     ("--devices-per-worker", dict(type=int))):
        sp.add_argument(flag, help="not ported yet (exits 2)", **kw)


def register(sub) -> None:
    """Attach the ``serve`` and ``loadgen`` subparsers."""
    sp = sub.add_parser(
        "serve",
        help="run the in-process micro-batching signal service (warm "
             "bucket shapes, self-probe every endpoint, serve)",
    )
    _common_flags(sp)
    sp.add_argument("--duration", type=float, default=5.0,
                    help="seconds to serve after the self-probe "
                         "(0 = until Ctrl-C; default 5)")
    sp.set_defaults(fn=cmd_serve)

    lg = sub.add_parser(
        "loadgen",
        help="seeded open-loop load generator against an in-process "
             "service; lands a GPU_SERVE_<run>.json latency/throughput "
             "artifact",
    )
    _common_flags(lg)
    lg.add_argument("--smoke", action="store_true",
                    help="small preset: smoke buckets, sub-second "
                         "schedule, GPU_SERVE_smoke.json")
    lg.add_argument("--schedule", metavar="DURxRPS|NAME",
                    help="arrival schedule: explicit segments (2x25,3x60) "
                         "or a named traffic shape — bursty (quiet + hard "
                         "bursts, bulk-heavy mix, panel reuse + mid-run "
                         "panel_version bump), diurnal (compressed-day "
                         "ramp), adversarial (bucket-boundary-hugging "
                         "universe sizes).  Named schedules preset the "
                         "class mix / reuse / version bumps that make "
                         "them meaningful (default: 2x40; smoke: 0.8x60)")
    lg.add_argument("--seed", type=int, default=0,
                    help="load stream seed (arrivals, mixes, panels; "
                         "same seed = same request stream)")
    lg.add_argument("--run-id", dest="run_id",
                    help="artifact run id: GPU_SERVE_<run-id>.json")
    lg.add_argument("--out", help="artifact directory (default: cwd)")
    lg.add_argument("--reuse-fraction", dest="reuse_fraction",
                    type=float, default=None, metavar="F",
                    help="probability a request reuses a recent panel "
                         "(default: the named schedule's preset, else 0)")
    lg.add_argument("--allow-fresh-compiles", dest="allow_fresh_compiles",
                    action="store_true",
                    help="land the artifact even when a kernel was built "
                         "or loaded inside the serving window (default: "
                         "exit 1)")
    for flag, kw in (("--pool", dict(action="store_true", default=None)),
                     ("--fabric", dict(action="store_true", default=None)),
                     ("--routers", dict(type=int)),
                     ("--transport", dict(choices=["unix", "tcp"])),
                     ("--kill-router-after", dict(type=float)),
                     ("--kill-worker-after", dict(type=float)),
                     ("--trace", dict(action="store_true", default=None)),
                     ("--fleet", dict(action="store_true", default=None)),
                     ("--spares", dict(type=int)),
                     ("--autoscale", dict(action="store_true", default=None)),
                     ("--prefork", dict(action="store_true", default=None))):
        lg.add_argument(flag, help="not ported yet (exits 2)", **kw)
    lg.set_defaults(fn=cmd_loadgen)
