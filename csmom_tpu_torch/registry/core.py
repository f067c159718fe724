"""The engine registry: register an endpoint once, serve it everywhere.

Counterpart of ``csmom_tpu.registry.core``: the same
:class:`ServeSurface`, :class:`EngineSpec`, :class:`EngineRegistry`,
:data:`REGISTRY` and :func:`register_engine`.  An engine registered once
(name, scorer factory, output shape, synthetic panel family) is warmed
by the serve engine, served by the service, offered by the load
generator and named in its artifact's per-endpoint books, with no other
file edited.

What differs from the reference:

- ``ServeSurface.batch_fn(params)`` returns a scorer of the whole
  micro-batch, ``fn(values f[B, A, M], mask bool[B, A, M])`` on the
  tensors' device, where the reference's returns one request's scorer
  for ``jax.vmap`` (torch has no ``vmap`` through the hand-written
  kernels; see :mod:`csmom_tpu_torch.registry.builtin`);
- ``serve`` is the only kind: ``compile`` and ``lint`` (warm-up
  manifests, lint rules) are not ported yet (ROADMAP.md, Queue 1 item 8)
  and raise, and ``strategy`` raises too, because the port's strategies
  register with :func:`csmom_tpu_torch.strategy.base.register_strategy`;
- :meth:`EngineSpec.donated` raises: torch has no buffer donation
  (ROADMAP.md, known difference 12); :meth:`EngineSpec.sharded` raises
  until the multi-GPU layer exists (Queue 1 item 7).

Stdlib-only, so the artifact validator can read endpoint names without
importing torch.  The builtin registrations live in
:mod:`csmom_tpu_torch.registry.builtin`, loaded on the first query.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

__all__ = [
    "EngineRegistry",
    "EngineSpec",
    "REGISTRY",
    "ServeSurface",
    "register_engine",
]

KINDS = ("serve",)
# the reference's other kinds, and where each is (or will be) served
_OTHER_KINDS = {
    "compile": "compile engines (warm-up manifests) are not ported yet "
               "(ROADMAP.md, Queue 1 item 8)",
    "lint": "lint engines (lint rules) are not ported yet (ROADMAP.md, "
            "Queue 1 item 8)",
    "strategy": "strategies register with "
                "csmom_tpu_torch.strategy.base.register_strategy",
}


@dataclasses.dataclass(frozen=True)
class ServeSurface:
    """What a servable engine contributes to the serving tier.

    ``batch_fn(params)`` returns the micro-batch scorer
    ``fn(values f[B, A, M], mask bool[B, A, M]) -> f[B, A] | f[B, F]``
    (torch tensors, computed on their device, with no loop over B).
    ``stub_fn(params)`` returns the numpy mirror over the same batch, a
    simplified model for plumbing tests, not a parity claim.

    ``params`` is the service's engine-identity dict
    (``lookback``/``skip``/``n_bins``/``mode``); a factory uses what it
    needs and ignores the rest.
    """

    batch_fn: Callable
    stub_fn: Callable
    output: str = "per_asset"       # "per_asset" (f[B, A]) | "summary"
    summary_fields: tuple = ()      # names of the summary lanes (f[B, len])
    panel_family: str = "price"     # loadgen synthetic family: price|volume

    def __post_init__(self):
        if self.output not in ("per_asset", "summary"):
            raise ValueError(
                f"output must be 'per_asset' or 'summary', got "
                f"{self.output!r}")
        if self.output == "summary" and not self.summary_fields:
            raise ValueError("a summary endpoint must name its fields")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One registered serve engine (a request-path endpoint).

    ``kind`` is ``"serve"`` and ``serve``, the :class:`ServeSurface`, is
    required.  ``workload=False`` keeps the engine out of the load
    generator's default mix.
    """

    name: str
    kind: str
    description: str = ""
    dtype: str | None = None        # canonical compute dtype, when fixed
    axes: str | None = None         # axis semantics, e.g. "f[B,A,M] panels"
    serve: ServeSurface | None = None
    workload: bool = True           # serve engines default into loadgen

    def __post_init__(self):
        if self.kind in _OTHER_KINDS:
            raise NotImplementedError(
                f"engine {self.name!r}: {_OTHER_KINDS[self.kind]}")
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got "
                             f"{self.kind!r}")
        if self.serve is None:
            raise ValueError(f"serve engine {self.name!r} needs a "
                             "ServeSurface")

    def donated(self, **params):
        """The reference's donated-buffer variant: torch has no buffer
        donation, so this raises."""
        raise NotImplementedError(
            f"engine {self.name!r}: buffer donation has no torch meaning "
            "(ROADMAP.md, known difference 12); call the scorer itself")

    def sharded(self, *args, **kwargs):
        """The reference's mesh variant: not ported yet."""
        raise NotImplementedError(
            f"engine {self.name!r}: sharded variants need the multi-GPU "
            "layer, which the port does not have yet (ROADMAP.md, Queue 1 "
            "item 7)")


class EngineRegistry:
    """Ordered, thread-safe name -> :class:`EngineSpec` table.

    ``kind`` arguments are kept for the reference's call signatures; the
    only kind is ``"serve"``.
    """

    def __init__(self):
        self._specs: dict[str, EngineSpec] = {}
        self._lock = threading.Lock()

    def register(self, spec: EngineSpec, replace: bool = False) -> EngineSpec:
        with self._lock:
            if not replace and spec.name in self._specs \
                    and self._specs[spec.name] != spec:
                raise ValueError(
                    f"{spec.kind} engine {spec.name!r} is already "
                    "registered; pass replace=True to overwrite "
                    "deliberately")
            self._specs[spec.name] = spec
        return spec

    def unregister(self, name: str, kind: str | None = None) -> None:
        with self._lock:
            if kind is None or kind in KINDS:
                self._specs.pop(name, None)

    def get(self, name: str, kind: str | None = None) -> EngineSpec:
        with self._lock:
            spec = self._specs.get(name)
        if spec is None or (kind is not None and kind != spec.kind):
            raise KeyError(
                f"unknown {kind or 'serve'} engine {name!r}; registered: "
                f"{self.names()}")
        return spec

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._specs

    def specs(self, kind: str | None = None) -> tuple:
        """Registered specs in registration order (optionally one kind),
        from a snapshot taken under the lock."""
        with self._lock:
            snap = list(self._specs.values())
        return tuple(s for s in snap if kind is None or s.kind == kind)

    def names(self, kind: str | None = None) -> tuple:
        return tuple(s.name for s in self.specs(kind))

    def serve_endpoints(self) -> tuple:
        """The serving tier's endpoint names, in registration order."""
        return self.names("serve")

    def serve_surface(self, name: str) -> ServeSurface:
        return self.get(name, kind="serve").serve

    def workload_kinds(self) -> tuple:
        """The loadgen endpoint mix: every servable engine that opted
        into the synthetic workload."""
        return tuple(s.name for s in self.specs("serve") if s.workload)


# the process-wide registry; builtins attach on the first query
REGISTRY = EngineRegistry()

_BUILTIN_LOCK = threading.Lock()
_BUILTIN_LOADED = False


def ensure_builtin() -> EngineRegistry:
    """Load the builtin registrations exactly once; returns REGISTRY."""
    global _BUILTIN_LOADED
    if not _BUILTIN_LOADED:
        with _BUILTIN_LOCK:
            if not _BUILTIN_LOADED:
                import csmom_tpu_torch.registry.builtin  # noqa: F401

                _BUILTIN_LOADED = True
    return REGISTRY


def register_engine(spec: EngineSpec | None = None, *, replace: bool = False,
                    **fields) -> EngineSpec:
    """Register one engine (a built ``EngineSpec`` or its fields); a serve
    engine registered here warms, serves and joins the loadgen mix."""
    if spec is None:
        spec = EngineSpec(**fields)
    ensure_builtin()
    return REGISTRY.register(spec, replace=replace)
