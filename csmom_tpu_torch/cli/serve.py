"""``serve`` and ``loadgen``: the serving tier's commands.

Counterpart of ``csmom_tpu.cli.serve``'s in-process, pool and fabric parts;
each prints what ``csmom`` prints.  ``serve`` starts the micro-batching
signal service (:mod:`csmom_tpu_torch.serve`), warms every bucket shape,
prints the readiness report, runs a self-probe of every endpoint, then
serves until ``--duration`` elapses (0 = until Ctrl-C) and prints the
request accounting.  ``loadgen`` drives an in-process service with the
seeded open-loop generator and lands ``GPU_SERVE_<run>.json``; it exits
1 when the artifact fails its own invariants or when a kernel was built
inside the serving window.

``serve --workers N`` runs the multi-process pool instead: N supervised
worker processes (each a ``SignalService``; several share one card)
behind a hedging router, self-probed through the router.  ``loadgen
--pool`` (2 workers unless ``--workers`` says otherwise) drives it and
lands ``GPU_SERVE_POOL_<run>.json``; ``--kill-worker-after SEC``
SIGKILLs worker ``w0`` that far into the run and waits for its warm
replacement.  The pool's requests carry a 500 ms deadline unless
``--deadline-ms`` says otherwise; ``--hedge-fraction`` (0.35) sets when a
straggler is hedged.  On the card the cold-cache gate runs once, in this
process, before any worker is spawned.

``loadgen --fabric`` drives the three-tier fabric: ``--routers N``
(default 2, at least 2) supervised router-replica processes in front of
the worker pool, a fabric client in this process, and
``GPU_SERVE_FABRIC_<run>.json``; ``--kill-router-after SEC`` SIGKILLs
replica ``r0`` mid-burst and combines with ``--kill-worker-after``.
``--transport {unix,tcp}`` sets the pool's and the fabric's sockets.

``loadgen --trace`` arms a per-request trace book
(:mod:`csmom_tpu_torch.obs.trace`) once the tier is ready, in all three
modes (the fabric's router replicas arm their own with ``--trace``), and
lands ``GPU_TRACE_<run>.json`` beside the serve artifact: the stage
decomposition, the closed trace books, the orphan halves of a killed
worker or replica, the padding goodput; it exits 1 when the trace books
are broken (``trace <run>`` renders the artifact).

In pool and fabric modes, ``--fleet`` arms the fleet observatory
(:mod:`csmom_tpu_torch.obs.fleet`) before any process spawns and lands
``GPU_FLEET_<run>.json`` beside the serve artifact (exit 1 when its
books are broken; ``fleet <run>`` renders it); ``--spares N``,
``--autoscale`` and ``--prefork`` arm the elastic tier
(:mod:`csmom_tpu_torch.serve.fleet`), with the configured worker count
as the autoscaler's floor and two more as its ceiling.

The flags that differ from the reference's:

- ``--device {cuda,cpu}`` (default cuda) takes the place of
  ``--platform``; ``--stub`` needs no device at all;
- the cold-cache gate: with the torch engine on cuda, every kernel the
  serve path launches must already have its library in
  ``build/csmom_tpu_torch/`` (``ops/build.py::library_path``), else the
  command exits 3 (``--allow-cold-cache`` accepts the build pause);
- ``--reuse-fraction`` sets the in-process and fabric runs' panel reuse;
- ``--transport`` unset picks unix sockets, or tcp when a socket path
  under the temporary run directory would pass 107 bytes
  (``supervisor.pick_transport``), where the reference defaults to unix;
- the fleet and trace artifacts are ``GPU_FLEET_<run>.json`` and
  ``GPU_TRACE_<run>.json``;
- ``--mesh`` runs the mesh engine (``torch-mesh``) over the visible
  cards, or the worker's pinned slice of them; on a machine with one
  card that is the one-shard path, the single-device scorer itself.
  ``--shards N`` asks for N shards: the first N visible cards with
  ``--device cuda`` (more exits 2), or N logical shards of the CPU with
  ``--device cpu``, the form ``grid --shards`` takes.  In a pool,
  ``--devices-per-worker N`` pins slot k to the slice ``k*N:N`` of the
  visible cards (more than there are exits 2), or to N logical CPU
  shards with ``--device cpu``.  ``loadgen --mesh`` lands
  ``GPU_SERVE_MESH_<run>.json``, with the engine's ``mesh`` block
  (placements, shard counts, the scaling probe).
"""

from __future__ import annotations

import os
import sys

__all__ = ["cmd_loadgen", "cmd_serve", "register"]

def _engine_name(args) -> str:
    """``torch-mesh`` with ``--mesh``, else ``torch``, or ``stub``."""
    if args.stub:
        return "stub"
    return "torch-mesh" if getattr(args, "mesh", False) else "torch"


def _mesh_devices_arg(args):
    """The in-process mesh engine's device list from ``--shards N`` (N
    logical CPU shards, or the first N visible cards), or None: the
    engine resolves ``--device``."""
    n = args.shards
    if not n or _engine_name(args) != "torch-mesh":
        return None
    return ("cpu",) * n if args.device == "cpu" else tuple(
        f"cuda:{i}" for i in range(n))


def _pooled(args) -> bool:
    """Whether the command runs worker processes (a pool or a fabric)."""
    return (args.workers > 0 or getattr(args, "pool", False)
            or getattr(args, "fabric", False))


def _visible_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _mesh_flags_rc(args) -> int:
    """Warn where the reference warns (``--mesh`` with ``--stub``, pinning
    or shards without ``--mesh``); 2 when the mesh flags are out of range
    or ask for more cards than are visible."""
    mesh = getattr(args, "mesh", False)
    if args.stub and mesh:
        print("warning: --mesh has no effect with --stub (the numpy stub has "
              "no devices to shard over)", file=sys.stderr)
    elif not mesh and (args.devices_per_worker > 0 or args.shards):
        print("warning: --devices-per-worker and --shards without --mesh are "
              "no-ops (only the torch-mesh engine builds a mesh); add --mesh",
              file=sys.stderr)
    if args.shards is not None and args.shards < 1:
        print("--shards must be at least 1", file=sys.stderr)
        return 2
    if args.devices_per_worker < 0:
        print("--devices-per-worker must be >= 0", file=sys.stderr)
        return 2
    if _engine_name(args) != "torch-mesh" or args.device != "cuda":
        return 0
    if args.shards and args.shards > _visible_cards():
        print(f"--shards {args.shards} exceeds the {_visible_cards()} visible "
              f"card(s); pass --device cpu to run {args.shards} logical CPU "
              "shards", file=sys.stderr)
        return 2
    need = max(args.workers, 2) * args.devices_per_worker
    if _pooled(args) and need > _visible_cards():
        print(f"--devices-per-worker {args.devices_per_worker} pins {need} "
              f"cards over the workers, more than the {_visible_cards()} "
              "visible; pass --device cpu for logical CPU shards",
              file=sys.stderr)
        return 2
    return 0


def _mk_service(args):
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    profile = args.profile or ("serve-smoke" if getattr(args, "smoke", False)
                               else "serve")
    cfg = ServeConfig(
        profile=profile,
        engine=_engine_name(args),
        device=None if args.stub else args.device,
        devices=_mesh_devices_arg(args),
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
    from csmom_tpu_torch.serve.health import (
        BUILD_POINTER,
        cache_readiness,
        mesh_devices_of,
    )

    # the device count each mesh engine meshes: the worker's slice in a
    # pinned pool, else --shards, else every visible card
    pinned = args.devices_per_worker if _pooled(args) else args.shards
    ready, reason = cache_readiness(mesh_devices=mesh_devices_of(
        _engine_name(args), args.device, pinned))
    if not ready:
        print(f"NOT READY ({reason})", file=sys.stderr)
        print("readiness is a demonstrated claim — building inside the "
              f"ready probe would fake it; build first ({BUILD_POINTER}), "
              "or pass --allow-cold-cache to accept the build pause",
              file=sys.stderr)
        return 3
    print(reason)
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


# ----------------------------------------------------------------- trace ---

def _arm_trace(args):
    """Arm the request-trace book when ``--trace`` was given; returns it,
    or None.  Called once the tier is ready, so probe traffic never
    enters the books."""
    if not args.trace:
        return None
    from csmom_tpu_torch.obs import trace as obs_trace

    return obs_trace.arm_tracing(seed=args.seed)


def _disarm_trace(book) -> None:
    if book is not None:
        from csmom_tpu_torch.obs import trace as obs_trace

        obs_trace.disarm_tracing()


def _land_trace(book, run_id: str, art: dict, out_dir: str) -> int:
    """Build, validate and land ``GPU_TRACE_<run>.json`` from an armed
    book and the serve artifact its books must reconcile with; disarms
    the book.  Returns 1 when the trace books are broken, else 0."""
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.obs import trace as obs_trace
    from csmom_tpu_torch.serve.loadgen import write_artifact

    viols = book.invariant_violations()
    trace_art = obs_trace.build_artifact(
        book, run_id,
        requests={k: art["requests"][k]
                  for k in ("admitted", "served", "rejected", "expired")},
        fresh_compiles=art["compile"]["in_window_fresh_compiles"],
        platform=art["extra"].get("platform"),
        workload=art["extra"].get("workload"),
    )
    obs_trace.disarm_tracing()
    path = write_artifact(out_dir, trace_art, prefix="GPU_TRACE")
    books = trace_art["books"]
    print(f"\ntrace books: opened {books['opened']} = complete "
          f"{books['complete']} + partial {books['partial']}; orphan "
          f"halves {trace_art['orphans']['count']}; max stage-sum "
          f"residual {trace_art['reconcile']['max_abs_residual_ms']} ms")
    print(f"trace artifact: {path} (render with "
          f"`python -m csmom_tpu_torch.cli trace {run_id}`)")
    schema = inv.validate_file(path)
    if viols or schema:
        print("TRACE INVALID:", file=sys.stderr)
        for v in viols + schema:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


# ------------------------------------------------------------------ pool ---

def _transport(args, run_dir: str) -> str:
    """``--transport``, else unix sockets unless a socket path under
    ``run_dir`` would be too long (``pick_transport``).  ``serve`` has no
    such flag."""
    from csmom_tpu_torch.serve.supervisor import pick_transport

    return getattr(args, "transport", None) or pick_transport(run_dir)


def _worker_config(args, run_dir: str):
    """The worker fleet's ``PoolConfig`` of a pool or fabric run, whose
    sockets go under ``run_dir``."""
    from csmom_tpu_torch.serve.supervisor import PoolConfig

    profile = args.profile or ("serve-smoke" if getattr(args, "smoke", False)
                               else "serve")
    engine = _engine_name(args)
    return PoolConfig(
        # --pool without --workers means a pool: two workers is the
        # smallest fleet hedging can route around
        n_workers=args.workers if args.workers > 0 else 2,
        profile=profile,
        engine=engine,
        device=args.device,
        transport=_transport(args, run_dir),
        capacity=args.capacity,
        max_wait_ms=args.max_wait_ms,
        # the pool's wire carries each request's deadline from the router,
        # so the worker-side default keeps plain float semantics
        deadline_ms=500.0 if args.deadline_ms is None else args.deadline_ms,
        devices_per_worker=(args.devices_per_worker
                            if engine == "torch-mesh" else 0),
        # the parent ran the cold-cache gate; each worker checks again
        require_warm_cache=(engine != "stub" and args.device == "cuda"
                            and not args.allow_cold_cache),
    )


def _mk_pool(args, run_dir: str):
    """Start the supervised fleet and its router (serve and loadgen)."""
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.supervisor import PoolSupervisor

    cfg = _worker_config(args, run_dir)
    sup = PoolSupervisor(cfg, run_dir).start()
    router = Router(sup.ready_workers, RouterConfig(
        profile=cfg.profile,
        default_deadline_s=(None if cfg.deadline_ms == 0
                            else cfg.deadline_ms / 1e3),
        hedge_fraction=args.hedge_fraction,
    ), retry_after_fn=sup.retry_after_s)
    return sup, router


def _print_pool_ready(sup, router) -> None:
    print(f"serving pool ready: {len(sup.ready_workers())}/"
          f"{sup.config.n_workers} workers (engine {sup.config.engine}, "
          f"profile {sup.config.profile}, {sup.config.transport} sockets)")
    print(f"  cache version: {sup.expect_cache_version}")
    for h in sup.handles:
        rep = h.ready_report or {}
        walls = rep.get("walls") or {}
        wall = (f" ready_wall {h.t_ready_s - h.t_spawned_s:.2f}s"
                f" (bind {walls.get('main_to_bind_s', '—')}s, warm "
                f"{walls.get('warm_s', '—')}s)"
                if h.t_ready_s is not None else "")
        print(f"  {h.worker_id} g{h.generation} [{h.state}] pid "
              f"{h.proc.pid if h.proc else '-'} platform "
              f"{rep.get('platform')} fresh_compiles "
              f"{rep.get('fresh_compiles')!r}{wall}")
    print(f"  hedging: fraction {router.config.hedge_fraction}, floor "
          f"{router.config.hedge_floor_s * 1e3:g} ms, max attempts "
          f"{router.config.max_attempts}")


def _pool_self_probe(submitter, spec=None) -> list:
    """One probe request per endpoint through ``submitter`` (the pool's
    router, or a fabric client): the tier's demonstrated-ready claim.
    Returns the failed probes (empty = ok).  ``spec`` defaults to the
    router's bucket spec (a fabric client carries none)."""
    import numpy as np

    from csmom_tpu_torch.registry import serve_endpoints

    spec = spec if spec is not None else submitter.spec
    A = spec.asset_buckets[0]
    rng = np.random.default_rng(0)
    probes = []
    for kind in serve_endpoints():
        v = 100.0 * np.exp(np.cumsum(
            rng.normal(0, 0.03, (A, spec.months)), axis=1))
        probes.append(submitter.submit(kind, v.astype(np.float32),
                                       np.ones((A, spec.months), bool),
                                       deadline_s=10.0))
    for p in probes:
        p.wait(15.0)
    return [p for p in probes if p.state != "served"]


def _start_pool(args, run_dir: str):
    """``(sup, router)``, or an exit code: the cold-cache gate runs here,
    once, before any worker is spawned (N workers must never race N
    builds inside their readiness windows)."""
    rc = _check_cache_honesty(args)
    if rc:
        return rc
    try:
        return _mk_pool(args, run_dir)
    except RuntimeError as e:
        print(f"pool failed to start: {e}", file=sys.stderr)
        return 1


def _cmd_serve_pool(args) -> int:
    """The multi-process tier behind ``serve --workers N``."""
    import shutil
    import tempfile
    import time

    from csmom_tpu_torch.utils.deadline import mono_now_s

    run_dir = tempfile.mkdtemp(prefix="csmom-pool-")
    try:
        started = _start_pool(args, run_dir)
        if isinstance(started, int):
            return started
        sup, router = started
        # from here every exit path must stop the fleet: worker processes
        # would outlive a crashed CLI
        try:
            _print_pool_ready(sup, router)
            failed = _pool_self_probe(router)
            print(f"  self-probe: "
                  f"{'all endpoints served' if not failed else 'FAILED'}")
            if failed:
                for p in failed:
                    print(f"    {p.kind}: state={p.state} error={p.error}",
                          file=sys.stderr)
                return 1
            try:
                if args.duration > 0:
                    end = mono_now_s() + args.duration
                    while mono_now_s() < end:
                        time.sleep(min(0.2, max(0.0, end - mono_now_s())))
                else:
                    print("pool serving until interrupted (Ctrl-C) ...")
                    while True:
                        time.sleep(0.5)
            except KeyboardInterrupt:
                print("\ninterrupted — draining the fleet")
            acct = router.accounting()
            viols = router.invariant_violations()
        finally:
            sup.stop()
            router.channels.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    summary = sup.summary()
    print(f"pool accounting: {acct}")
    print(f"availability: {router.availability()}")
    print(f"fleet: kills {summary['kills']}, restarts "
          f"{summary['restarts']}, rolls {summary['rolls_completed']}")
    for v in viols:
        print(f"INVARIANT VIOLATION: {v}", file=sys.stderr)
    return 1 if viols else 0


def _kill_w0_after(sup, kill_after: float):
    """The ``concurrent`` action of a pool run: SIGKILL worker ``w0``
    ``kill_after`` seconds in, then wait (up to the ready timeout) for its
    replacement to demonstrate ready, so the artifact is built from a
    settled fleet (a parked slot is reported by the artifact)."""
    from csmom_tpu_torch.serve.fabric import kill_mid_burst

    def concurrent():
        kill_mid_burst([(kill_after, sup, "worker")],
                       settle_timeout_s=sup.config.ready_timeout_s,
                       announce=lambda tier, victim, at_s: print(
                           f"  [chaos] SIGKILL {tier} {victim} ({at_s:g}s "
                           "into the run)", flush=True))

    return concurrent


def _fleet_artifact_rc(args, path: str, art: dict) -> int:
    """A pool or fabric run's exit code: 1 when its artifact fails its
    own invariants, or when a worker built or loaded a kernel inside the
    serving window (unless ``--allow-fresh-compiles``)."""
    from csmom_tpu_torch.chaos import invariants as inv

    viols = inv.validate_file(path)
    if viols:
        print("ARTIFACT INVALID:", file=sys.stderr)
        for v in viols:
            print(f"  - {v}", file=sys.stderr)
        return 1
    fresh = art["compile"]["in_window_fresh_compiles"]
    if isinstance(fresh, int) and fresh > 0 and not args.allow_fresh_compiles:
        print(f"error: {fresh} kernel build(s) or load(s) inside the serving "
              "window across the fleet — a worker missed what its warm-up "
              "built; rerun with --allow-fresh-compiles to land anyway",
              file=sys.stderr)
        return 1
    return 0


# ----------------------------------------------------------------- fleet ---

def _arm_fleet(args, run_id: str, transport: str, run_dir: str):
    """Arm the fleet observatory when ``--fleet`` was given
    (:mod:`csmom_tpu_torch.obs.fleet`); returns the aggregator or None.

    Runs before the supervisors spawn: arming exports the ``CSMOM_FLEET``
    environment contract, and a worker or router replica joins the
    aggregator only if it inherits it.  The aggregator listens on the
    pool's transport, its unix socket under ``run_dir`` when the path
    fits (``supervisor.pick_transport``), else on loopback tcp."""
    if not args.fleet:
        return None
    from csmom_tpu_torch.obs import fleet as obs_fleet
    from csmom_tpu_torch.serve.supervisor import pick_transport

    if transport == "unix" and pick_transport(run_dir) != "unix":
        transport = "tcp"
    agg = obs_fleet.arm(run_id, transport=transport, scratch_dir=run_dir)
    print(f"fleet observatory armed: aggregator at {agg.address} "
          f"(cadence {agg.cadence_s}s)")
    return agg


def _disarm_fleet(agg, reason: str) -> None:
    if agg is not None:
        from csmom_tpu_torch.obs import fleet as obs_fleet

        obs_fleet.disarm(reason)


def _elastic_config(args, n_workers: int):
    """The ``FleetConfig`` that ``--spares``, ``--autoscale`` and
    ``--prefork`` ask for (None when none was given).  The configured
    fleet size is the autoscaler's floor: a drain never shrinks the
    fleet below what the operator asked to run."""
    spares = args.spares or 0
    if not (spares or args.autoscale or args.prefork):
        return None
    from csmom_tpu_torch.serve.fleet import FleetConfig

    return FleetConfig(spares=spares, autoscale=bool(args.autoscale),
                       prefork=bool(args.prefork), min_workers=n_workers,
                       max_workers=n_workers + 2)


def _arm_elastic(args, wsup, publisher=None):
    """Pool mode: attach a ``FleetController`` to a running supervisor
    (fabric mode passes the config to ``build_fabric``).  Returns the
    controller or None."""
    cfg = _elastic_config(args, wsup.config.n_workers)
    if cfg is None:
        return None
    from csmom_tpu_torch.obs import fleet as obs_fleet
    from csmom_tpu_torch.serve.fleet import FleetController

    ctl = FleetController(wsup, cfg, publisher=publisher,
                          aggregator=obs_fleet.current_aggregator())
    ctl.start()
    _print_elastic(ctl)
    return ctl


def _print_elastic(ctl) -> None:
    cfg = ctl.config
    print(f"  elastic: {len(ctl.spares)} hot spare(s) parked out of the ring"
          + (", prefork warm path" if cfg.prefork else "")
          + (", autoscaler armed" if cfg.autoscale else ""))
    for s in ctl.spares:
        print(f"    {s.worker_id} pid {s.proc.pid} ready in "
              f"{s.t_ready_s - s.t_spawned_s:.2f}s")


def _land_fleet(run_id: str, art: dict, out_dir: str, wsup, rsup,
                window: tuple) -> int:
    """Build, validate and land ``GPU_FLEET_<run>.json`` from the armed
    aggregator and the serve artifact its demand book reconciles with.
    Called after the pool or fabric stopped, so every surviving
    emitter's fin frame is in the books (a SIGKILLed one's stream was
    closed as severed).  Returns 1 when the fleet books are broken,
    else 0; disarms the observatory either way."""
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.obs import fleet as obs_fleet
    from csmom_tpu_torch.serve.loadgen import write_artifact

    agg = obs_fleet.current_aggregator()
    if agg is None:
        return 0
    try:
        # fin-close this process's own emitter, then reason-close any
        # straggler book before the snapshot freezes
        obs_fleet.disarm_emitter("loadgen finished")
        agg.close_all("run-end")
        fleet_art = obs_fleet.build_artifact(
            agg, run_id,
            requests={k: art["requests"][k]
                      for k in ("admitted", "served", "rejected", "expired")},
            worker_events=obs_fleet.absolute_events(
                wsup.summary()["events"], wsup.t0_mono_s),
            router_events=(obs_fleet.absolute_events(
                rsup.summary()["events"], rsup.t0_mono_s)
                if rsup is not None else None),
            # the autoscaler may have grown the fleet past its configured
            # size: nominal capacity counts the slots that existed
            n_workers=max(wsup.config.n_workers, len(wsup.handles)),
            n_routers=(rsup.config.n_workers if rsup is not None else None),
            window=window,
            channels=(art.get("extra") or {}).get("client_channels"),
            fresh_compiles=art["compile"]["in_window_fresh_compiles"],
            platform=art["extra"].get("platform"),
            workload=art["extra"].get("workload"),
            elastic=(wsup.fleet.summary() if wsup.fleet is not None
                     else None))
    finally:
        obs_fleet.disarm("run-end")
    path = write_artifact(out_dir, fleet_art, prefix="GPU_FLEET")
    books = fleet_art["series"]["books"]
    cap = fleet_art["capacity"]
    print(f"\nfleet books: {books['procs_opened']} stream(s) opened = "
          f"{books['procs_closed']} reason-closed; {books['frames']} "
          f"frames, {books['seq_gaps']} seq gap(s), "
          f"{books['frames_dropped_by_emitters']} dropped")
    print(f"fleet capacity: kill-window loss "
          f"{cap['kill_window_loss_frac']} over "
          f"{len(cap['kill_windows'])} window(s), steady-state "
          f"{cap['steady_state_loss_frac']}; ready walls "
          f"{fleet_art['lifecycle']['ready_walls_s']} s")
    el = fleet_art.get("elastic")
    if el:
        sp = el["spares"]
        print(f"elastic: {sp['promoted']} promotion(s) "
              f"{[p['wall_s'] for p in el['promotions']]} s wall, "
              f"{sp['spawned']} spare(s) spawned "
              f"({sp['died_parked']} died parked, {sp['backfills']} "
              f"backfill(s)), {len(el['decisions'])} reasoned "
              "autoscaler decision(s)")
    print(f"fleet artifact: {path} (render with "
          f"`python -m csmom_tpu_torch.cli fleet {run_id}`)")
    schema = inv.validate_file(path)
    if schema:
        print("FLEET INVALID:", file=sys.stderr)
        for v in schema:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


def _cmd_loadgen_pool(args, schedule: str, run_id: str,
                      schedule_kind: str = "custom",
                      preset: dict | None = None) -> int:
    """Pool-mode loadgen: drive the router, land GPU_SERVE_POOL_<run>.json."""
    import shutil
    import tempfile

    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        run_pool_loadgen,
        write_artifact,
    )

    from csmom_tpu_torch.utils.deadline import mono_now_s

    run_dir = tempfile.mkdtemp(prefix="csmom-pool-")
    fleet_agg = trace_book = None
    try:
        # the observatory arms before the spawns: workers join it through
        # the environment they inherit
        fleet_agg = _arm_fleet(args, run_id, _transport(args, run_dir),
                               run_dir)
        started = _start_pool(args, run_dir)
        if isinstance(started, int):
            _disarm_fleet(fleet_agg, "pool failed to start")
            return started
        sup, router = started
        try:
            _print_pool_ready(sup, router)
            # pool mode has no routes publisher: a promotion is routable
            # the moment the handle swaps (the router reads ready_workers)
            _arm_elastic(args, sup)
            # a named schedule's preset applies where the pool loadgen
            # implements it (the class mix); cache reuse and version bumps
            # are single-process shapes, dropped loudly so the artifact's
            # schedule_kind never overclaims
            preset = dict(preset or {})
            class_mix = preset.pop("class_mix", None)
            preset.pop("use_class_deadlines", None)  # pool deadlines are
            # per-request floats through the router, not class budgets
            if args.reuse_fraction is not None:
                preset["reuse_fraction"] = args.reuse_fraction
            if preset:
                print(f"note: named-schedule preset keys {sorted(preset)} "
                      "apply to the single-process loadgen only; this pool "
                      "run uses the schedule + class mix")
            load = LoadConfig(
                schedule=schedule,
                schedule_kind=schedule_kind,
                seed=args.seed,
                class_mix=class_mix,
                deadline_s=(None if args.deadline_ms == 0
                            else 0.5 if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
                run_id=run_id,
            )
            kill_after = args.kill_worker_after or 0.0
            concurrent = (_kill_w0_after(sup, kill_after) if kill_after > 0
                          else None)
            trace_book = _arm_trace(args)
            print(f"offering (pool): schedule {schedule} (seed {load.seed}, "
                  f"deadline {load.deadline_s}s"
                  + (", trace armed" if trace_book is not None else "")
                  + (f", worker kill @{kill_after:g}s" if kill_after else "")
                  + ") ...")
            t_load0 = mono_now_s()
            art = run_pool_loadgen(router, sup, load, concurrent=concurrent)
        except BaseException:
            _disarm_fleet(fleet_agg, "pool run failed")
            _disarm_trace(trace_book)
            raise
        finally:
            # a Ctrl-C or a loadgen failure must not leak live workers
            sup.stop()
            router.channels.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out_dir = args.out or os.getcwd()
    path = write_artifact(out_dir, art, prefix="GPU_SERVE_POOL")

    req = art["requests"]
    lat = art["latency_ms"]["total"]
    print(f"\nthroughput: {art['value']} req/s achieved vs "
          f"{art['offered']['offered_rps']} req/s offered over "
          f"{art['wall_s']}s wall"
          + (" (offered-load-limited)" if art["offered_limited"] else ""))
    print(f"requests: admitted {req['admitted']} -> served {req['served']}, "
          f"rejected {req['rejected']} (infra {req['rejected_infra']}), "
          f"expired {req['expired']}")
    print(f"availability: {art['availability']}  hedge rate: "
          f"{art['hedge']['rate']} ({req['hedged']} hedged, "
          f"{req['hedge_wins']} wins, {req['duplicates_suppressed']} "
          f"suppressed), retries {req['retries']}, worker connection "
          f"failures {req['worker_conn_failures']}")
    print(f"latency total ms: p50 {lat['p50']}  p95 {lat['p95']}  "
          f"p99 {lat['p99']}")
    print(f"fleet: kills {art['pool']['kills']}, restarts "
          f"{art['pool']['restarts']}, rolls "
          f"{art['pool']['rolls_completed']}, ready at the end "
          f"{art['pool']['ready_workers_end']}")
    print(f"in-window fresh compiles: "
          f"{art['compile']['in_window_fresh_compiles']!r}")
    print(f"artifact: {path}")

    rc = 0
    if trace_book is not None:
        rc = _land_trace(trace_book, run_id, art, out_dir)
    if fleet_agg is not None:
        rc = max(rc, _land_fleet(run_id, art, out_dir, sup, None,
                                 (t_load0, t_load0 + art["wall_s"])))
    return max(rc, _fleet_artifact_rc(args, path, art))


# ---------------------------------------------------------------- fabric ---

def _mk_fabric(args, run_dir: str):
    """Start the three tiers: the worker supervisor, the routes
    publisher, the router-replica supervisor and the fabric client."""
    from csmom_tpu_torch.serve.fabric import build_fabric
    from csmom_tpu_torch.serve.supervisor import PoolConfig

    # the workers' and the routers' run dirs sit one level below run_dir
    wcfg = _worker_config(args, os.path.join(run_dir, "workers"))
    # replicas hold no compute: they run the stub's cache version, which
    # build_fabric replaces with the live workers'
    rcfg = PoolConfig(n_workers=args.routers, profile=wcfg.profile,
                      engine="stub", transport=wcfg.transport)
    return build_fabric(
        wcfg, rcfg, run_dir,
        deadline_ms=wcfg.deadline_ms,
        hedge_fraction=args.hedge_fraction,
        trace=args.trace,
        client_deadline_s=(None if wcfg.deadline_ms == 0
                           else wcfg.deadline_ms / 1e3),
        fleet_config=_elastic_config(args, wcfg.n_workers))


def _cmd_loadgen_fabric(args, schedule: str, run_id: str,
                        schedule_kind: str = "custom",
                        preset: dict | None = None) -> int:
    """Fabric-mode loadgen: drive the three tiers, SIGKILL one router and
    one worker mid-burst when asked, land GPU_SERVE_FABRIC_<run>.json."""
    import shutil
    import tempfile

    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.fabric import (
        FabricClient,
        kill_mid_burst,
        stop_fabric,
    )
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        run_fabric_loadgen,
        write_artifact,
    )

    if args.routers < 2:
        print(f"--routers {args.routers}: the fabric needs at least 2 router "
              "replicas (one router is the pool: use --pool)",
              file=sys.stderr)
        return 2
    from csmom_tpu_torch.utils.deadline import mono_now_s

    rc = _check_cache_honesty(args)
    if rc:
        return rc
    run_dir = tempfile.mkdtemp(prefix="csmom-fabric-")
    fleet_agg = trace_book = None
    try:
        # the observatory arms before the spawns: router replicas and
        # workers join it through the environment they inherit
        fleet_agg = _arm_fleet(args, run_id, _transport(args, run_dir),
                               run_dir)
        try:
            wsup, publisher, rsup, client = _mk_fabric(args, run_dir)
        except RuntimeError as e:
            print(f"fabric failed to start: {e}", file=sys.stderr)
            _disarm_fleet(fleet_agg, "fabric failed to start")
            return 1
        try:
            print(f"fabric ready: {len(rsup.ready_workers())} router "
                  f"replicas over {wsup.config.transport}, "
                  f"{len(wsup.ready_workers())}/{wsup.config.n_workers} "
                  f"workers (engine {wsup.config.engine}, profile "
                  f"{wsup.config.profile})")
            for h in rsup.handles + wsup.handles:
                rep = h.ready_report or {}
                print(f"  {h.worker_id} g{h.generation} [{h.state}] "
                      f"{h.socket_path}"
                      + (f" platform {rep['platform']} fresh_compiles "
                         f"{rep.get('fresh_compiles')!r}"
                         if "platform" in rep else ""))
            if wsup.fleet is not None:
                _print_elastic(wsup.fleet)
            # a demonstrated three-tier ready: one probe per endpoint
            # through client -> replica -> worker, on a throwaway client
            # (the measured client's books are the artifact's ledger)
            probe_client = FabricClient(rsup.ready_workers, client.config)
            try:
                failed = _pool_self_probe(
                    probe_client, spec=bucket_spec(wsup.config.profile))
            finally:
                probe_client.close()
            print(f"  self-probe: "
                  f"{'all endpoints served' if not failed else 'FAILED'}")
            if failed:
                for p in failed:
                    print(f"    {p.kind}: state={p.state} error={p.error}",
                          file=sys.stderr)
                _disarm_fleet(fleet_agg, "self-probe failed")
                return 1
            trace_book = _arm_trace(args)

            preset = dict(preset or {})
            class_mix = preset.pop("class_mix", None)
            preset_reuse = preset.pop("reuse_fraction", 0.0)
            bumps = preset.pop("version_bumps", 0)
            preset.pop("use_class_deadlines", None)
            if preset:
                print(f"note: named-schedule preset keys {sorted(preset)} "
                      "apply to the single-process loadgen only")
            # an explicit --reuse-fraction wins, else the named schedule's
            # preset: the pool-level cache needs repeats to route
            reuse = (args.reuse_fraction if args.reuse_fraction is not None
                     else preset_reuse)
            load = LoadConfig(
                schedule=schedule,
                schedule_kind=schedule_kind,
                seed=args.seed,
                class_mix=class_mix,
                reuse_fraction=reuse,
                version_bumps=bumps,
                deadline_s=(None if args.deadline_ms == 0
                            else 0.5 if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
                run_id=run_id,
            )
            kill_router_after = args.kill_router_after or 0.0
            kill_worker_after = args.kill_worker_after or 0.0
            concurrent = None
            if kill_router_after > 0 or kill_worker_after > 0:
                def concurrent():
                    # one router replica and one worker die mid-burst; the
                    # client fails over, the routes view rebalances and
                    # both supervisors respawn; the artifact is built only
                    # after both tiers settled
                    if not kill_mid_burst(
                            [(kill_router_after, rsup, "router"),
                             (kill_worker_after, wsup, "worker")],
                            settle_timeout_s=wsup.config.ready_timeout_s,
                            announce=lambda tier, victim, at_s: print(
                                f"  [chaos] SIGKILL {tier} {victim} "
                                f"({at_s:g}s into the run)", flush=True)):
                        raise RuntimeError(
                            "a killed tier never demonstrated ready again: "
                            "refusing to build books from an unsettled "
                            "fleet (a crash loop? the supervisor logs are "
                            f"under {run_dir})")

            print(f"offering (fabric): schedule {schedule} (seed "
                  f"{load.seed}, deadline {load.deadline_s}s, reuse "
                  f"{load.reuse_fraction}"
                  + (", trace armed" if trace_book is not None else "")
                  + (f", router kill @{kill_router_after:g}s"
                     if kill_router_after else "")
                  + (f", worker kill @{kill_worker_after:g}s"
                     if kill_worker_after else "")
                  + ") ...")
            t_load0 = mono_now_s()
            art = run_fabric_loadgen(client, rsup, wsup, load,
                                     concurrent=concurrent)
        except BaseException:
            _disarm_fleet(fleet_agg, "fabric run failed")
            _disarm_trace(trace_book)
            raise
        finally:
            # every exit path stops both process tiers and the publisher
            stop_fabric(publisher, rsup, wsup)
            client.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out_dir = args.out or os.getcwd()
    path = write_artifact(out_dir, art, prefix="GPU_SERVE_FABRIC")

    req = art["requests"]
    lat = art["latency_ms"]["total"]
    cache = art["cache"]
    print(f"\nthroughput: {art['value']} req/s achieved vs "
          f"{art['offered']['offered_rps']} req/s offered over "
          f"{art['wall_s']}s wall"
          + (" (offered-load-limited)" if art["offered_limited"] else ""))
    print(f"requests: admitted {req['admitted']} -> served {req['served']}, "
          f"rejected {req['rejected']} (infra {req['rejected_infra']}), "
          f"expired {req['expired']}; failovers {req['failovers']}, "
          f"router connection failures {req['router_conn_failures']}")
    print(f"availability: {art['availability']}")
    print(f"pool cache: hit rate {cache['pool_hit_rate']} "
          f"({cache['served_cache_hits']}/{cache['served']} served); "
          f"worker books: stale_hits {cache['workers']['stale_hits']}")
    print(f"hedge: served hedged {art['hedge']['served_hedged']} "
          f"(rate {art['hedge']['rate']}), router tier hedged "
          f"{art['hedge']['router_tier']['hedged']}")
    print(f"latency total ms: p50 {lat['p50']}  p95 {lat['p95']}  "
          f"p99 {lat['p99']}")
    print(f"routers: kills {art['routers']['kills']}, restarts "
          f"{art['routers']['restarts']}; workers: kills "
          f"{art['workers']['kills']}, restarts {art['workers']['restarts']}")
    print(f"in-window fresh compiles: "
          f"{art['compile']['in_window_fresh_compiles']!r}")
    print(f"artifact: {path}")

    rc = 0
    if trace_book is not None:
        rc = _land_trace(trace_book, run_id, art, out_dir)
    if fleet_agg is not None:
        rc = max(rc, _land_fleet(run_id, art, out_dir, wsup, rsup,
                                 (t_load0, t_load0 + art["wall_s"])))
    return max(rc, _fleet_artifact_rc(args, path, art))


def cmd_serve(args) -> int:
    """Run the signal service: in-process (default) or the multi-process
    pool (``--workers N``); warm every bucket shape, self-probe every
    endpoint, serve."""
    import time

    import numpy as np

    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.utils.deadline import mono_now_s

    rc = _mesh_flags_rc(args)
    if rc:
        return rc
    if args.workers > 0:
        return _cmd_serve_pool(args)
    rc = _check_cache_honesty(args)
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
    """Open-loop load generation against an in-process service, the pool
    (``--pool``) or the fabric (``--fabric``); lands GPU_SERVE_<run>.json,
    GPU_SERVE_POOL_<run>.json or GPU_SERVE_FABRIC_<run>.json."""
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        parse_schedule,
        resolve_schedule,
        run_loadgen,
        write_artifact,
    )

    rc = _mesh_flags_rc(args)
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
    if args.fabric:
        return _cmd_loadgen_fabric(args, schedule, run_id, schedule_kind,
                                   preset)
    if args.pool:
        return _cmd_loadgen_pool(args, schedule, run_id, schedule_kind,
                                 preset)
    if args.reuse_fraction is not None:
        preset["reuse_fraction"] = args.reuse_fraction
    rc = _check_cache_honesty(args)
    if rc:
        return rc
    svc = _mk_service(args)
    svc.start()
    _print_ready(svc)
    # the mesh branches key off the resolved engine, not the flag: a stub
    # run never prints mesh claims or lands in the SERVE_MESH family
    mesh_engine = svc.engine.name == "torch-mesh"
    if mesh_engine:
        mesh = svc.warm_report.get("mesh") or {}
        print(f"  mesh: {mesh.get('devices')} devices, placements "
              + ", ".join(f"{k}:{v['axis']}"
                          for k, v in (mesh.get("endpoints") or {}).items()))
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
    trace_book = _arm_trace(args)
    print(f"offering: schedule {schedule_kind} = {schedule} (seed "
          f"{load.seed}, deadline "
          f"{'class budgets' if load.use_class_deadlines else load.deadline_s}"
          + (", trace armed" if trace_book is not None else "") + ") ...")
    try:
        art = run_loadgen(svc, load)
    except BaseException:
        _disarm_trace(trace_book)
        raise
    out_dir = args.out or os.getcwd()
    path = write_artifact(out_dir, art, prefix=("GPU_SERVE_MESH" if mesh_engine
                                                else "GPU_SERVE"))

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

    rc = 0
    if trace_book is not None:
        rc = _land_trace(trace_book, run_id, art, out_dir)
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
    return rc


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
    sp.add_argument("--workers", type=int, default=0,
                    help="run the MULTI-PROCESS pool with N supervised "
                         "worker processes behind a hedging router "
                         "(0 = the in-process single service; default 0; "
                         "loadgen --pool: default 2)")
    sp.add_argument("--hedge-fraction", dest="hedge_fraction", type=float,
                    default=0.35,
                    help="pool mode: hedge a request after this fraction "
                         "of its remaining deadline (default 0.35)")
    sp.add_argument("--mesh", action="store_true",
                    help="the torch-mesh engine: each micro-batch split "
                         "over the mesh (batch rows, or assets for the "
                         "per-asset signals: csmom_tpu_torch/mesh partition "
                         "rules) on the visible cards; GPU_SERVE_MESH_* "
                         "artifacts")
    sp.add_argument("--shards", type=int, metavar="N",
                    help="with --mesh, in-process: N shards, the first N "
                         "visible cards (--device cuda) or N logical CPU "
                         "shards (--device cpu); default: every visible "
                         "card, one shard with --device cpu")
    sp.add_argument("--devices-per-worker", dest="devices_per_worker",
                    type=int, default=0,
                    help="with --mesh, pool mode: pin slot k to the slice "
                         "k*N:N of the visible cards (N logical CPU shards "
                         "with --device cpu); a replacement re-pins the "
                         "same slice; 0 = no pinning")


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
                         "(in-process and fabric runs; default: the named "
                         "schedule's preset, else 0)")
    lg.add_argument("--allow-fresh-compiles", dest="allow_fresh_compiles",
                    action="store_true",
                    help="land the artifact even when a kernel was built "
                         "or loaded inside the serving window (default: "
                         "exit 1)")
    lg.add_argument("--pool", action="store_true",
                    help="drive the multi-process pool (--workers N, "
                         "default 2) instead of the in-process service; "
                         "lands GPU_SERVE_POOL_<run>.json (kind serve_pool)")
    lg.add_argument("--kill-worker-after", dest="kill_worker_after",
                    type=float, default=0.0, metavar="SEC",
                    help="pool and fabric modes: SIGKILL worker w0 SEC "
                         "seconds into the run and wait for its warm "
                         "replacement (0 = no kill)")
    lg.add_argument("--fabric", action="store_true",
                    help="drive the three-tier fabric: supervised "
                         "router-replica processes (--routers N) in front "
                         "of the worker pool, client-side failover; lands "
                         "GPU_SERVE_FABRIC_<run>.json (kind serve_fabric)")
    lg.add_argument("--routers", type=int, default=2,
                    help="fabric mode: router replica count (at least 2; "
                         "default 2)")
    lg.add_argument("--transport", choices=["unix", "tcp"],
                    help="pool and fabric modes: the sockets of every hop "
                         "(default: unix, or tcp when a socket path under "
                         "the temporary run directory would be too long)")
    lg.add_argument("--kill-router-after", dest="kill_router_after",
                    type=float, default=0.0, metavar="SEC",
                    help="fabric mode: SIGKILL router replica r0 SEC seconds "
                         "into the run and wait for its replacement "
                         "(combines with --kill-worker-after; 0 = no kill)")
    lg.add_argument("--fleet", action="store_true",
                    help="pool and fabric modes: arm the fleet observatory "
                         "(obs.fleet): every process streams metrics "
                         "snapshot deltas to a per-run aggregator; lands "
                         "GPU_FLEET_<run-id>.json (time series, demand "
                         "book, kill-window capacity account) next to the "
                         "serve artifact; render with `fleet <run-id>`")
    lg.add_argument("--spares", type=int, default=0, metavar="N",
                    help="pool and fabric modes: park N hot spare workers "
                         "(spawned, demonstrated ready, held out of the "
                         "hash ring) and promote one into a dead worker's "
                         "slot instead of re-warming it; the pool backfills "
                         "off the hot path (0 = off)")
    lg.add_argument("--autoscale", action="store_true",
                    help="pool and fabric modes: arm the demand-driven "
                         "control loop (hysteresis-banded scale up/down "
                         "between the configured worker count and two "
                         "more, and the bulk class's quota tuned to its "
                         "demand); every decision lands reasoned in the "
                         "fleet artifact's elastic block (needs --fleet "
                         "for its demand input)")
    lg.add_argument("--prefork", action="store_true",
                    help="pool and fabric modes: fork spares from a prefork "
                         "parent that has torch and the serve stack "
                         "imported and the kernel libraries read into the "
                         "page cache (it never initializes CUDA)")
    lg.add_argument("--trace", action="store_true",
                    help="arm per-request tracing (obs.trace) once the tier "
                         "is ready and land GPU_TRACE_<run-id>.json beside "
                         "the serve artifact (telescoping per-stage walls, "
                         "closed trace books, orphan halves, padding "
                         "goodput); in fabric mode each router replica arms "
                         "its own book; render with `trace <run-id>`")
    lg.set_defaults(fn=cmd_loadgen)
