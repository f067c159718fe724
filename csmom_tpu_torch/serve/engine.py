"""Serve scoring engines: the card engine and a numpy stub.

Counterpart of ``csmom_tpu.serve.engine``.  The per-endpoint scorers are
registered engines (:mod:`csmom_tpu_torch.registry`); this module turns
a registered :class:`~csmom_tpu_torch.registry.core.ServeSurface` into
the two live backends.

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

:class:`StubEngine` scores with the registered numpy stubs: the
queue/batcher/chaos plumbing is engine-agnostic, so plumbing tests drive
it without torch.
"""

from __future__ import annotations

import numpy as np

from csmom_tpu_torch.registry import serve_endpoints, serve_surface
from csmom_tpu_torch.serve.buckets import BucketSpec

__all__ = ["KERNELS", "StubEngine", "TorchEngine", "make_engine",
           "unpack_result"]

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
        # scorers keyed by the SURFACE object, not the endpoint name: a
        # name registered again with a new surface gets a new scorer
        self._fns: dict = {}
        self._builds0 = None

    def _fn(self, kind: str):
        surface = _surface_or_raise(kind)
        fn = self._fns.get(surface)
        if fn is None:
            fn = self._fns[surface] = surface.batch_fn(
                dict(lookback=self.lookback, skip=self.skip,
                     n_bins=self.n_bins, mode=self.mode))
        return fn

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

        fn = self._fn(kind)
        v = torch.from_numpy(_own(values)).to(self.device)
        m = torch.from_numpy(_own(mask)).to(self.device)
        return fn(v, m).cpu().numpy()

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


def make_engine(name: str, device=None, **kwargs):
    """The engine called ``name``: ``"torch"`` (the card engine; ``"jax"``,
    the reference's name in its configs, means the same) on ``device``,
    or ``"stub"``."""
    if name in ("torch", "jax"):
        return TorchEngine(device=device, **kwargs)
    if name == "stub":
        return StubEngine(**kwargs)
    if name == "jax-mesh":
        raise NotImplementedError(
            "engine 'jax-mesh' is the mesh serving engine, which the port "
            "does not have yet (ROADMAP.md, Queue 1 item 7b)")
    raise ValueError(
        f"unknown engine {name!r}: use 'torch' (or 'jax'), or 'stub'")
