"""Pool worker: one process owning one ``SignalService``, behind a socket.

Counterpart of ``csmom_tpu.serve.worker``::

    python -m csmom_tpu_torch.serve.worker --socket ADDR \\
        --engine {torch,torch-mesh,stub} --device {cuda,cuda:N,cpu} ...

runs the in-process micro-batching service
(:mod:`csmom_tpu_torch.serve.service`) behind the pool's wire protocol
(:mod:`csmom_tpu_torch.serve.proto`): the router holds a persistent
multiplexed channel here (many score frames in flight on it, each
handled on its own thread), the supervisor dials one-shot for probes
and lifecycle ops.  The process is the isolation unit: a crash, a GIL
stall or a restart takes down one worker's queue, and the router's
hedged retries route around it.  Several workers may share one card;
each has its own CUDA context, launch stream and admission queue.

Startup order (the order is the contract):

1. **Version gate.**  With ``--expect-cache-version``, the worker
   computes :func:`csmom_tpu_torch.serve.health.aot_cache_version` and
   on a mismatch refuses: a pointed message on stderr and exit
   ``RC_VERSION_SKEW``, before torch is imported.
2. **Device gate.**  The torch engine on ``--device cuda`` (the default)
   without a card exits ``RC_NO_DEVICE`` naming ``--device cpu``.
3. **Kernel check.**  With ``--require-warm-cache`` (the default for the
   torch engine on cuda), every engine kernel's library must exist in
   the build directory; otherwise exit ``RC_COLD_CACHE`` with the
   build pointer.
4. **Liveness before readiness.**  The socket binds and answers
   ``ping`` at once; ``ready`` reports ``ok: false, reason: warming``
   until the service has warmed every bucket shape and served one
   self-probe per endpoint with no kernel library built or loaded since
   the warm snapshot.

The ready report's ``platform`` is the engine's device (``gpu``,
``cpu``) or ``stub``.  The ``stats`` reply carries the process's kernel
launch counts and its library builds and loads, so a caller can hold
"K1 once a ``backtest`` micro-batch" across the process boundary.  A
stub worker never imports torch.

The fleet's elastic tier retunes a class's admission quota through the
``tune_quota`` op, and with ``CSMOM_FLEET`` set the worker streams its
metrics to the run's fleet observatory from bind to drain
(:mod:`csmom_tpu_torch.obs.fleet`).  A worker forked by the prefork
parent (:mod:`csmom_tpu_torch.serve.fleet`) runs this same ``main``.

Chaos: the service's ``serve.admit`` / ``serve.coalesce`` /
``serve.dispatch`` checkpoints fire inside this process (the plan
arrives by environment from the supervisor), so a ``kill`` at
``serve.dispatch`` is a real worker death mid-batch.
``CSMOM_SERVE_WORKER_FAULT=exit:<rc>`` makes the process exit at
startup (a deterministic crash-looper for the backoff tests).
``--device-slice <start>:<count>`` pins a mesh worker: the slice is
exported as ``CSMOM_MESH_DEVICE_SLICE`` before the engine is built, so
the engine meshes exactly those devices (the visible cards for
``--device cuda``, ``count`` logical shards of a single ``--device``),
and its count keys the cache version and the readiness check.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading

import numpy as np

from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["RC_COLD_CACHE", "RC_NO_DEVICE", "RC_VERSION_SKEW",
           "WorkerServer", "main"]

RC_COLD_CACHE = 3      # an engine kernel's library is not built
RC_VERSION_SKEW = 4    # --expect-cache-version did not match ours
RC_NO_DEVICE = 5       # --device cuda and no card

# startup chaos knob (crash-loop tests): "exit:<rc>" exits rc
FAULT_ENV = "CSMOM_SERVE_WORKER_FAULT"

# grace beyond a request's own deadline before the worker gives up
# waiting for a terminal state (the service guarantees terminality; this
# bounds the reply even if that guarantee breaks)
_TERMINAL_GRACE_S = 5.0
_NO_DEADLINE_WAIT_S = 30.0


class WorkerServer:
    """The socket front of one in-process :class:`SignalService`."""

    def __init__(self, socket_path: str, config, worker_id: str = "w0",
                 device_slice: str | None = None):
        from csmom_tpu_torch.serve.service import SignalService

        self.socket_path = socket_path
        self.worker_id = worker_id
        self.device_slice = device_slice
        self.service = SignalService(config)
        self._ready_lock = threading.Lock()
        self._ready_report = {"ok": False, "reason": "warming",
                              "worker_id": worker_id,
                              "device_slice": device_slice}
        self._draining = False
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self.cache_version: str | None = None

    def platform(self) -> str:
        """``"stub"``, or the engine's device: ``"gpu"`` or ``"cpu"``."""
        engine = self.service.engine
        if engine.name == "stub":
            return "stub"
        return "gpu" if engine.device.type == "cuda" else "cpu"

    # ----------------------------------------------------------- lifecycle

    def bind(self) -> None:
        """Bind, listen and start answering (liveness is up from here;
        readiness stays false until :meth:`warm_and_probe` succeeds)."""
        self._listener = proto.listen(self.socket_path)
        self._listener.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop,
                             name=f"csmom-worker-{self.worker_id}-accept",
                             daemon=True)
        t.start()

    def warm_and_probe(self, walls: dict | None = None) -> dict:
        """Warm every bucket shape, then demonstrate readiness: one
        self-probe request per endpoint through the full pipeline; ready
        iff all served with no library built or loaded since the warm
        snapshot.  ``walls`` carries the caller's earlier lifecycle
        stamps; this adds ``warm_s``."""
        t_warm0 = mono_now_s()
        self.service.start()
        spec = self.service.spec
        A = spec.asset_buckets[0]
        rng = np.random.default_rng(0)
        probes = {}
        for kind in serve_endpoints():
            v = 100.0 * np.exp(np.cumsum(
                rng.normal(0, 0.03, (A, spec.months)), axis=1))
            req = self.service.submit(kind, v.astype(np.float32),
                                      np.ones((A, spec.months), bool),
                                      deadline_s=10.0)
            req.wait(15.0)
            probes[kind] = req.state
        fresh = self.service.fresh_compiles()
        ok = (all(s == "served" for s in probes.values())
              and (not isinstance(fresh, int) or fresh == 0))
        report = {
            "ok": ok,
            "worker_id": self.worker_id,
            "pid": os.getpid(),
            "platform": self.platform(),
            "engine": self.service.engine.name,
            "profile": spec.name,
            "cache_version": self.cache_version,
            # the pinning contract's evidence: the slice this worker's
            # engine built its mesh over (a replacement re-pins its
            # predecessor's)
            "device_slice": self.device_slice,
            "warm": self.service.warm_report,
            "probes": probes,
            "fresh_compiles": fresh,
            # spawn → bind → warm → ready decomposed at the source: the
            # supervisor's ready event copies this block
            "walls": dict(walls or {},
                          warm_s=round(mono_now_s() - t_warm0, 3)),
            "reason": None if ok else (
                f"self-probe states {probes}, fresh_compiles={fresh!r}"),
        }
        with self._ready_lock:
            self._ready_report = report
        return report

    def run_until_stopped(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(0.2)
        self._shutdown()

    def _shutdown(self) -> None:
        # drain before the lights go out: the SIGTERM path reaches here
        # without a "stop" op, and queued requests must still terminate
        # (idempotent when the stop op already drained)
        try:
            self.service.stop(drain=True, timeout_s=10.0)
        except Exception:
            pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        proto.unlink_address(self.socket_path)

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: shutting down
            # one persistent connection per peer channel: the serve loop
            # demuxes many in-flight requests off it, scoring each on
            # its own thread; a one-shot probe exits via clean EOF
            t = threading.Thread(
                target=proto.serve_connection,
                args=(conn, self._handle),
                kwargs={"on_stop": self.stop},
                daemon=True)
            t.start()

    def _handle(self, obj: dict, arrays: dict) -> tuple:
        op = obj.get("op")
        if op == "ping":
            return {"ok": True, "worker_id": self.worker_id,
                    "pid": os.getpid()}, None
        if op == "ready":
            with self._ready_lock:
                report = dict(self._ready_report)
            if self._draining:
                report["ok"] = False
                report["reason"] = "draining"
            return report, None
        if op == "stats":
            return self._stats(), None
        if op == "tune_quota":
            # the fleet autoscaler's quota seam (serve/fleet.py): retune a
            # class's admission bucket within the declared policy shape
            applied = self.service.queue.retune_quota(
                str(obj.get("slo_class", "")),
                float(obj.get("quota_rps") or 0.0),
                (float(obj["quota_burst"])
                 if obj.get("quota_burst") else None))
            return {"state": "ok" if applied else "rejected",
                    "ok": applied, "worker_id": self.worker_id,
                    "applied": applied}, None
        if op == "score":
            return self._score(obj, arrays)
        if op in ("drain", "stop"):
            self._draining = True
            self.service.stop(drain=True)
            out = self._stats()
            out["drained"] = True
            return out, None
        return {"ok": False, "error": f"unknown op {op!r}"}, None

    def _stats(self) -> dict:
        out = {
            "ok": True,
            "worker_id": self.worker_id,
            "pid": os.getpid(),
            "accounting": self.service.accounting(),
            "classes": self.service.class_stats(),
            "cache": self.service.cache_stats(),
            "batches": self.service.batch_stats(),
            "fresh_compiles": self.service.fresh_compiles(),
            "invariant_violations": self.service.invariant_violations(),
            "kernel_launches": None,
            "libraries_built_or_loaded": None,
        }
        if self.service.engine.name != "stub":
            # this process's own counts: launches live in the process
            # that made them, so this reply is the only way to read them
            from csmom_tpu_torch.ops import build, kernels

            out["kernel_launches"] = {n: getattr(kernels, n).launches
                                      for n in build.KERNELS}
            out["libraries_built_or_loaded"] = build.libraries_built_or_loaded()
        return out

    def _score(self, obj: dict, arrays: dict) -> tuple:
        if self._draining:
            return {"state": "rejected", "error": "worker draining",
                    "worker_id": self.worker_id}, None
        if "values" not in arrays or "mask" not in arrays:
            return {"state": "rejected",
                    "error": "score frame missing values/mask arrays",
                    "worker_id": self.worker_id}, None
        rel = obj.get("deadline_rel_s")
        pv = obj.get("panel_version")
        # a wire-carried trace context means the router is tracing this
        # request: rebuild the server half here so the reply can carry a
        # stitchable stage chain
        trace_ctx = None
        wire_trace = obj.get("trace")
        if isinstance(wire_trace, dict):
            from csmom_tpu_torch.obs.trace import TraceContext

            trace_ctx = TraceContext.from_wire(wire_trace)
        req = self.service.submit(
            str(obj.get("kind")), arrays["values"], arrays["mask"],
            priority=str(obj.get("priority", "interactive")),
            deadline_s=float(rel) if rel is not None else None,
            panel_version=int(pv) if pv is not None else None,
            trace_ctx=trace_ctx,
        )
        wait_s = (float(rel) + _TERMINAL_GRACE_S if rel is not None
                  else _NO_DEADLINE_WAIT_S)
        if not req.wait(wait_s):
            # the service contract says this is unreachable; answering
            # anyway bounds the router's exposure to a broken worker
            return {"state": "rejected",
                    "error": "request never reached a terminal state "
                             f"within {wait_s:.1f}s (worker defect)",
                    "worker_id": self.worker_id}, None
        reply = {
            "state": req.state,
            "error": req.error,
            "worker_id": self.worker_id,
            "queue_wait_s": req.queue_wait_s,
            "service_s": req.service_s,
            "cache_hit": bool(req.cache_hit),
            # stamped through so the router's books can reconcile which
            # panel version every response was computed from
            "panel_version": req.panel_version,
        }
        if trace_ctx is not None:
            reply["trace_half"] = trace_ctx.half_record()
        out_arrays = None
        if req.state == "served":
            if isinstance(req.result, dict):
                reply["result_obj"] = {k: float(v)
                                       for k, v in req.result.items()}
            else:
                out_arrays = {"result": np.asarray(req.result)}
        return reply, out_arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="csmom_tpu_torch.serve.worker",
        description="pool worker: SignalService behind a socket")
    ap.add_argument("--socket", required=True,
                    help="serve address: a unix socket path (bare or "
                         "unix:/path) or tcp:host:port")
    ap.add_argument("--worker-id", dest="worker_id", default="w0")
    ap.add_argument("--profile", default="serve")
    ap.add_argument("--engine", default="torch",
                    choices=["torch", "jax", "torch-mesh", "jax-mesh", "stub"],
                    help="torch: the card engine; torch-mesh: its sharded "
                         "form ('jax' and 'jax-mesh', the reference's names, "
                         "mean the same); stub: numpy, no device")
    ap.add_argument("--device", default="cuda",
                    help="the torch engines' device: cuda (the visible "
                         "cards; without one the worker exits naming "
                         "--device cpu), a single card cuda:N, or cpu")
    ap.add_argument("--device-slice", dest="device_slice",
                    help="pin this mesh worker to the slice '<start>:<count>' "
                         "(exported as CSMOM_MESH_DEVICE_SLICE before the "
                         "engine is built): of the visible cards with "
                         "--device cuda, else count logical shards of the "
                         "single --device")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                    default=10.0)
    ap.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=500.0)
    ap.add_argument("--expect-cache-version", dest="expect_cache_version",
                    help="refuse ready unless our computed cache version "
                         "matches (the rolling-deploy skew gate)")
    ap.add_argument("--require-warm-cache", dest="require_warm_cache",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="exit nonzero when an engine kernel's library is "
                         "not built, instead of building it at warm "
                         "(default: on for the torch engine on cuda)")
    ap.add_argument("--cache-subdir", dest="cache_subdir", default="bench",
                    help="the warm-up report's subdirectory whose coverage "
                         "the kernel check reports (default 'bench')")
    args = ap.parse_args(argv)
    t_main0 = mono_now_s()
    tag = f"[worker {args.worker_id}]"

    fault = os.environ.get(FAULT_ENV, "")
    if fault.startswith("exit:"):
        print(f"{tag} chaos {FAULT_ENV}={fault}: exiting at startup",
              file=sys.stderr, flush=True)
        return int(fault.split(":", 1)[1] or 1)
    from csmom_tpu_torch.serve.engine import ENGINE_ALIASES

    engine = ENGINE_ALIASES.get(args.engine, args.engine)
    pinned = None
    if args.device_slice:
        from csmom_tpu_torch.mesh.pinning import DEVICE_SLICE_ENV, parse_device_slice

        try:
            _, pinned = parse_device_slice(args.device_slice)
        except ValueError as e:
            print(f"{tag} --device-slice: {e}", file=sys.stderr, flush=True)
            return 2
        # exported before any engine is built: the mesh variants read the
        # pinned slice from the environment
        os.environ[DEVICE_SLICE_ENV] = args.device_slice
    mesh_devices = health.mesh_devices_of(engine, args.device, pinned)
    my_version = health.aot_cache_version(args.profile, engine=engine,
                                          mesh_devices=mesh_devices)
    if (args.expect_cache_version
            and args.expect_cache_version != my_version):
        print(
            f"{tag} REFUSING READY: cache version skew — supervisor expects "
            f"{args.expect_cache_version}, this worker's code computes "
            f"{my_version} (bucket grid / endpoint set / engine params / "
            "torch release / kernel sources or flags differ).  Serving "
            "would build inside the window; redeploy matching code and "
            f"build first ({health.BUILD_POINTER})",
            file=sys.stderr, flush=True,
        )
        return RC_VERSION_SKEW

    on_card = engine != "stub" and args.device.startswith("cuda")
    if on_card:
        import torch

        if not torch.cuda.is_available():
            print(f"{tag} no CUDA device is available; pass --device cpu to "
                  "run the torch engine on the CPU (the plain PyTorch "
                  "versions of every kernel)", file=sys.stderr, flush=True)
            return RC_NO_DEVICE
    require_warm = (on_card if args.require_warm_cache is None
                    else args.require_warm_cache)
    if engine != "stub" and require_warm:
        ready, reason = health.cache_readiness(
            args.profile, args.cache_subdir, mesh_devices=mesh_devices)
        if not ready:
            print(f"{tag} NOT READY: {reason}", file=sys.stderr, flush=True)
            return RC_COLD_CACHE

    from csmom_tpu_torch.serve.service import ServeConfig

    cfg = ServeConfig(
        profile=args.profile, engine=engine,
        device=args.device if engine != "stub" else None,
        capacity=args.capacity, max_wait_s=args.max_wait_ms / 1e3,
        default_deadline_s=(None if args.deadline_ms in (None, 0)
                            else args.deadline_ms / 1e3),
    )
    server = WorkerServer(args.socket, cfg, worker_id=args.worker_id,
                          device_slice=args.device_slice)
    server.cache_version = my_version

    def _term(signum, frame):  # graceful drain on SIGTERM
        server.stop()

    signal.signal(signal.SIGTERM, _term)

    server.bind()
    t_bind = mono_now_s()
    # join the run's fleet observatory when armed (CSMOM_FLEET inherited
    # from the supervisor or the prefork parent): sampling off the
    # request path; a disarmed environment leaves the process as it was
    from csmom_tpu_torch.obs import fleet as obs_fleet

    obs_fleet.arm_emitter_from_env("worker", args.worker_id)
    report = server.warm_and_probe(
        walls={"main_to_bind_s": round(t_bind - t_main0, 3)})
    print(f"{tag} pid {os.getpid()} "
          f"{'READY' if report['ok'] else 'NOT READY'} in "
          f"{mono_now_s() - t_bind:.2f}s: probes {report['probes']}, "
          f"fresh_compiles {report['fresh_compiles']!r}",
          file=sys.stderr, flush=True)
    server.run_until_stopped()
    obs_fleet.disarm_emitter("worker stopped (drained)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
