"""Serve scoring engines: the card engine, its mesh form and a numpy stub.

Counterpart of ``csmom_tpu.serve.engine``.  The per-endpoint scorers are
registered engines (:mod:`csmom_tpu_torch.registry`); this module turns
a registered :class:`~csmom_tpu_torch.registry.core.ServeSurface` into
the live backends.  :func:`serve_entry_fn` is the process-shared scorer
of one endpoint, keyed on the surface object, so a name registered
again gets a new scorer.

:class:`TorchEngine` takes the place of the reference's ``JaxEngine``:
each endpoint's batch scorer runs the whole padded micro-batch on the
engine's device in one call, with no loop over requests, so the
``backtest`` endpoint launches K1 once a micro-batch, whatever its size.
``warm()`` scores every (endpoint, bucket) shape once, which builds and
loads every kernel the shapes launch and fills the caching allocator,
then notes the kernel-build count; ``fresh_compiles()`` is that count's
change since, 0 when every dispatch stayed on the warmed grid.  Eager
torch builds nothing per shape, so this counts less than the
reference's ``backend_compiles`` did: kernel libraries built or loaded,
not computations (ROADMAP.md, known differences).

:class:`MeshTorchEngine` (``"torch-mesh"``; the reference's ``"jax-mesh"``
means the same) takes the place of ``MeshJaxEngine``: every endpoint
dispatches its sharded scorer
(:func:`csmom_tpu_torch.mesh.variants.sharded_serve_entry_fn`), the
batch rows split across shards, or the assets for the per-asset
signals, so a ``backtest`` micro-batch of bucket B on d devices
launches K1 once per batch shard (``shards_for(B, d)`` times).  Its
devices are an explicit list (a device may repeat: logical shards of
one device), else the worker's pinned slice, else the visible cards;
:mod:`csmom_tpu_torch.mesh.variants` says how a single ``device`` and a
pinned slice combine.  Its warm-up scores every (endpoint, bucket)
shape and the scaling probe's single-device scorer before it notes the
kernel-build count.

:class:`StubEngine` scores with the registered numpy stubs: the
queue/batcher/chaos plumbing is engine-agnostic, so plumbing tests drive
it without torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from csmom_tpu_torch.registry import serve_endpoints, serve_surface
from csmom_tpu_torch.serve.buckets import BucketSpec

__all__ = ["KERNELS", "MeshTorchEngine", "StubEngine", "TorchEngine",
           "make_engine", "serve_entry_fn", "unpack_result"]

# the kernels the builtin endpoints launch (ops/build.py names): the
# backtest endpoint's K1; the CLI's cold-cache gate checks their builds
KERNELS = ("decile_partial_sums",)


def _surface_or_raise(kind: str):
    try:
        return serve_surface(kind)
    except KeyError:
        raise ValueError(
            f"unknown endpoint {kind!r}: registered endpoints are "
            f"{serve_endpoints()}") from None


@lru_cache(maxsize=64)
def scorer_for(surface, lookback: int, skip: int, n_bins: int, mode: str):
    """The batch scorer of one registered surface, process-shared and
    keyed on the surface object."""
    return surface.batch_fn(dict(lookback=lookback, skip=skip, n_bins=n_bins,
                                 mode=mode))


def serve_entry_fn(kind: str, lookback: int, skip: int, n_bins: int,
                   mode: str):
    """The batch scorer of one registered endpoint (process-shared):
    ``fn(values f[B, A, M], mask bool[B, A, M])`` on the tensors'
    device, one call a micro-batch.  Per-asset endpoints return
    ``f[B, A]`` (NaN where invalid or padded), summary endpoints
    (``backtest``) ``f[B, len(summary_fields)]``."""
    return scorer_for(_surface_or_raise(kind), lookback, skip, n_bins, mode)


def unpack_result(kind: str, out: np.ndarray, row: int, n_assets: int):
    """One request's result from a batch output, per the registered
    output spec: a read-only per-asset vector, or the summary dict."""
    surface = _surface_or_raise(kind)
    if surface.output == "summary":
        return {f: float(out[row, i])
                for i, f in enumerate(surface.summary_fields)}
    res = np.array(out[row, :n_assets])
    # ONE object may reach the cache, the leader, and every coalesced
    # follower: freeze it so no caller can mutate what another (or a
    # later cache hit) will read
    res.setflags(write=False)
    return res


class TorchEngine:
    """The card scoring backend (one scorer call per micro-batch).

    ``device`` resolves through :func:`csmom_tpu_torch.device.resolve_device`:
    cuda by default, raising without a card; ``"cpu"`` runs every
    kernel's plain version.
    """

    name = "torch"

    def __init__(self, lookback: int = 12, skip: int = 1, n_bins: int = 10,
                 mode: str = "rank", device=None):
        from csmom_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.lookback = lookback
        self.skip = skip
        self.n_bins = n_bins
        self.mode = mode
        self._builds0 = None

    def _fn(self, kind: str):
        # resolved per call: a name registered again serves its new scorer
        return serve_entry_fn(kind, self.lookback, self.skip, self.n_bins,
                              self.mode)

    def warm(self, spec: BucketSpec) -> dict:
        """Score every (endpoint, bucket) shape once, then note the
        kernel-build count: everything after it is in-window."""
        from csmom_tpu_torch.obs import span
        from csmom_tpu_torch.ops import build

        kinds = serve_endpoints()
        n = 0
        with span("serve.warmup", phase="warmup", spec=spec.name):
            for kind in kinds:
                for B, A, M in spec.shapes():
                    self.score(kind, np.zeros((B, A, M), np.dtype(spec.dtype)),
                               np.zeros((B, A, M), bool))
                    n += 1
        self._builds0 = build.libraries_built_or_loaded()
        return {"n_shapes_warmed": n, "endpoints": list(kinds),
                "device": str(self.device)}

    def score(self, kind: str, values: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        """The batch's scores as numpy: each host array goes to the
        device in one copy, the registered scorer runs there, and the
        result comes back (the copy back waits for the device)."""
        import torch

        return _score_on(self._fn(kind), self.device, values, mask)

    def fresh_compiles(self):
        """Kernel libraries built or loaded since warm() (0 = every
        dispatch used what the warm-up built)."""
        from csmom_tpu_torch.ops import build

        if self._builds0 is None:
            return ("not measurable: engine was never warmed "
                    "(call warm() before serving)")
        return build.libraries_built_or_loaded() - self._builds0


def _own(a: np.ndarray) -> np.ndarray:
    """A C-contiguous, writeable array ``torch.from_numpy`` can share."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def _score_on(fn, device, values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``fn`` on one host batch: one copy of each array to ``device``,
    the scorer, the result back (the copy back waits for the device)."""
    import torch

    v = torch.from_numpy(_own(values)).to(device)
    m = torch.from_numpy(_own(mask)).to(device)
    return fn(v, m).cpu().numpy()


class MeshTorchEngine(TorchEngine):
    """The card engine on a mesh (see the module docstring): one
    sharded dispatch a micro-batch, warm before serving, kernel builds
    counted since the warm-up, results equal to :class:`TorchEngine`'s
    (bit for bit where the scorers' sums do not depend on the batch's
    width; ROADMAP.md, known differences).

    ``devices``: an explicit list, a device may repeat; None resolves
    ``device`` and the pinned slice
    (:func:`csmom_tpu_torch.mesh.variants.sharded_serve_entry_fn`).  The
    batch goes to the first device in one copy and the result comes
    back from there.
    """

    name = "torch-mesh"

    def __init__(self, lookback: int = 12, skip: int = 1, n_bins: int = 10,
                 mode: str = "rank", device=None, devices=None):
        from csmom_tpu_torch.device import resolve_device
        from csmom_tpu_torch.mesh.variants import _devices

        if devices is None:
            resolve_device(device)  # cuda without a card raises, naming cpu
        self.devices = _devices(devices, device)
        super().__init__(lookback=lookback, skip=skip, n_bins=n_bins,
                         mode=mode, device=self.devices[0])

    def _fn(self, kind: str):
        # resolved per call, like TorchEngine._fn: the entry is a cheap
        # wrapper over the surface-keyed scorer cache, so an endpoint
        # registered again serves its new scorer here too
        from csmom_tpu_torch.mesh.variants import sharded_serve_entry_fn

        return sharded_serve_entry_fn(kind, self.lookback, self.skip,
                                      self.n_bins, self.mode,
                                      devices=self.devices)

    def dispatch_shards(self, kind: str, batch_bucket: int,
                        asset_bucket: int) -> tuple:
        """``(devices, shards)`` of one bucket dispatch: the trace's
        per-dispatch mesh attributes (a bucket axis that divides only 4
        ways on 8 devices rode a partial split)."""
        entry = self._fn(kind)
        return entry.n_devices, entry.shards_for_shape(batch_bucket,
                                                       asset_bucket)

    def mesh_info(self, spec=None) -> dict:
        """The device count and each endpoint's axis and shard count per
        bucket: the artifact's ``mesh`` block."""
        from csmom_tpu_torch.serve.buckets import bucket_spec

        spec = spec or bucket_spec("serve")
        info: dict = {"endpoints": {}}
        for kind in serve_endpoints():
            entry = self._fn(kind)
            info["devices"] = entry.n_devices
            info["endpoints"][kind] = {
                "axis": entry.axis,
                "shards": {f"b{B}@{A}": entry.shards_for_shape(B, A)
                           for B, A, _ in spec.shapes()},
            }
        return info

    def warm(self, spec) -> dict:
        # the scaling probe's single-device scorer first, at the largest
        # bucket, so its kernels are built before the snapshot too
        B, A = spec.batch_buckets[-1], spec.asset_buckets[-1]
        _score_on(self._single(), self.device,
                  np.zeros((B, A, spec.months), np.dtype(spec.dtype)),
                  np.zeros((B, A, spec.months), bool))
        report = super().warm(spec)
        report["mesh"] = self.mesh_info(spec)
        return report

    def _single(self):
        return serve_entry_fn(self._probe_kind(), self.lookback, self.skip,
                              self.n_bins, self.mode)

    @staticmethod
    def _probe_kind() -> str:
        return serve_endpoints()[0]

    def scaling_probe(self, spec, reps: int = 5) -> dict:
        """Single-device against sharded dispatch wall at the largest
        bucket, each the best of ``reps`` host-to-host calls: the
        ``mesh_scaling_efficiency`` row.  Both scorers were warmed, so
        nothing is built here.  Logical shards of one device share it,
        so the number is what this host delivers, not a projection."""
        from csmom_tpu_torch.utils.deadline import mono_now_s

        kind = self._probe_kind()
        B, A = spec.batch_buckets[-1], spec.asset_buckets[-1]
        rng = np.random.default_rng(0)
        v = (100.0 * np.exp(np.cumsum(
            rng.normal(0, 0.03, (B, A, spec.months)), axis=2))
        ).astype(np.dtype(spec.dtype))
        m = np.ones((B, A, spec.months), bool)
        sharded = self._fn(kind)

        def best(fn):
            walls = []
            for _ in range(reps):
                t0 = mono_now_s()
                _score_on(fn, self.device, v, m)
                walls.append(mono_now_s() - t0)
            return min(walls)

        t_single, t_sharded = best(self._single()), best(sharded)
        # efficiency charges the shards the probe shape split into
        shards = sharded.shards_for_shape(B, A)
        speedup = t_single / t_sharded if t_sharded > 0 else float("inf")
        return {
            "probe_endpoint": kind,
            "probe_shape": [B, A, spec.months],
            "single_device_dispatch_ms": round(1e3 * t_single, 3),
            "sharded_dispatch_ms": round(1e3 * t_sharded, 3),
            "devices": sharded.n_devices,
            "shards": shards,
            "speedup": round(speedup, 4),
            "scaling_efficiency": (round(speedup / shards, 4)
                                   if shards else None),
        }


class StubEngine:
    """Deterministic numpy scorer, the plumbing-test engine.

    Shapes and NaN semantics mirror the card engine through the
    registered stub factories; the numbers are a simplified model, which
    is fine: every consumer of the stub tests the queue/batcher/chaos
    path, not signal values.
    """

    name = "stub"

    def __init__(self, lookback: int = 12, skip: int = 1, n_bins: int = 10,
                 mode: str = "rank"):
        self.lookback = lookback
        self.skip = skip
        self.n_bins = n_bins
        self.mode = mode
        self._fns: dict = {}  # per-engine-instance scorer cache

    def warm(self, spec: BucketSpec) -> dict:
        return {"n_shapes_warmed": 0,
                "endpoints": list(serve_endpoints()),
                "note": "stub engine: nothing to build"}

    def score(self, kind: str, values: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        # each stub scorer is built once per engine instance, not per
        # dispatch: the factory closure is pure in (kind, params)
        fn = self._fns.get(kind)
        if fn is None:
            surface = _surface_or_raise(kind)
            fn = self._fns[kind] = surface.stub_fn(
                dict(lookback=self.lookback, skip=self.skip,
                     n_bins=self.n_bins, mode=self.mode))
        return fn(values, mask)

    def fresh_compiles(self) -> int:
        return 0  # nothing is ever built: trivially warm


# the reference's engine names, and the port's engine each one means
ENGINE_ALIASES = {"jax": "torch", "jax-mesh": "torch-mesh"}


def make_engine(name: str, device=None, devices=None, **kwargs):
    """The engine called ``name``: ``"torch"`` (the card engine) on
    ``device``, ``"torch-mesh"`` on ``devices`` (else ``device`` and the
    pinned slice), or ``"stub"``; the reference's names ``"jax"`` and
    ``"jax-mesh"`` mean the same engines."""
    name = ENGINE_ALIASES.get(name, name)
    if name == "torch":
        return TorchEngine(device=device, **kwargs)
    if name == "torch-mesh":
        return MeshTorchEngine(device=device, devices=devices, **kwargs)
    if name == "stub":
        return StubEngine(**kwargs)
    raise ValueError(
        f"unknown engine {name!r}: use 'torch' (or 'jax'), 'torch-mesh' (or "
        "'jax-mesh'), or 'stub'")
