"""The warm-up manifest: every hot entry point at its canonical shapes.

Counterpart of ``csmom_tpu.compile.manifest``.  The reference's manifest
lists ``(jitted function, abstract argument shapes)`` pairs that its
warm-up lowers and compiles into XLA's executable cache.  Eager torch
compiles nothing per shape, so the port's warm-up runs each entry once
on seeded inputs of its shapes (:mod:`csmom_tpu_torch.compile.aot`), and
an entry also names the kernel libraries its real call launches on the
card, which the warm-up builds or loads first.

The reference's three properties hold:

- **no drift**: :meth:`ManifestEntry.validate` binds an entry's
  arguments against its function's signature
  (``inspect.signature(...).bind``), so a renamed or removed parameter
  raises ``TypeError`` instead of warming a stale call;
- **one source of shapes**: panel sizes come from
  :mod:`csmom_tpu_torch.compile.workloads` and month counts from the
  pack calendar (:func:`months_of`);
- **no per-module profile tables**: which engines feed which profile is
  declared on the engines' registrations
  (:mod:`csmom_tpu_torch.registry.builtin`), and :func:`build_manifest`
  is a registry query.

An array argument is a :class:`TensorSpec` leaf (:func:`sds`, in place of
``jax.ShapeDtypeStruct``); :meth:`ManifestEntry.materialize` turns the
leaves into seeded tensors: positive lognormal prices for floats,
``True`` for bools, 0 for integers unless the leaf carries its value.
Impl names are the port's (``plain`` for the reference's ``xla``,
``kernel`` for ``pallas``).  A donated entry (``grid.jk16.rank.plain.
donated@...``, ``event.threshold.donated@...``) consumes the tensors at
its ``donated`` positions, so the warm-up makes fresh inputs for each
of its calls.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Callable, Mapping

import numpy as np

from csmom_tpu_torch.compile import workloads as wl

__all__ = [
    "ManifestEntry",
    "TensorSpec",
    "build_manifest",
    "event_entries",
    "golden_event_entries",
    "grid_entries",
    "grid_net_entry",
    "histrank_entry",
    "monthly_entries",
    "months_of",
    "online_ridge_entry",
    "sds",
]

K1 = "decile_partial_sums"
K2 = "cohort_partial_sums"
K3 = "rank_labels"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An abstract array argument: shape, numpy dtype and, optionally,
    the values it must hold (e.g. a grid's lookbacks)."""

    shape: tuple
    dtype: np.dtype
    value: tuple | None = None

    def numpy(self, rng: np.random.Generator) -> np.ndarray:
        """A seeded host array of this spec (see the module docstring)."""
        if self.value is not None:
            return np.asarray(self.value, dtype=self.dtype).reshape(self.shape)
        if self.dtype == np.bool_:
            return np.ones(self.shape, dtype=bool)
        if np.issubdtype(self.dtype, np.integer):
            return np.zeros(self.shape, dtype=self.dtype)
        # a lognormal random walk along the last axis: positive prices
        # with momentum to rank
        steps = rng.normal(0.0, 0.05, size=self.shape)
        return (100.0 * np.exp(np.cumsum(steps, axis=-1))).astype(self.dtype)


def sds(shape, dtype, value=None) -> TensorSpec:
    """A :class:`TensorSpec` leaf (the manifest's abstract array)."""
    return TensorSpec(tuple(int(s) for s in shape), np.dtype(dtype),
                      None if value is None else tuple(value))


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    """One hot entry point at one canonical argument signature.

    ``args``/``kwargs`` hold :class:`TensorSpec` leaves for arrays and
    plain Python values for scalars and static arguments.  ``kernels``
    names the kernel libraries (``ops/build.py``) that the entry's call
    launches on the card; ``donated`` the argument positions a call
    consumes (:mod:`csmom_tpu_torch.utils.donation`).
    """

    name: str
    fn: Callable
    args: tuple
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    kernels: tuple = ()
    donated: tuple = ()

    def validate(self) -> None:
        """Bind the arguments against the function's signature; raises
        ``TypeError`` when the manifest and the code have drifted."""
        inspect.signature(self.fn).bind(*self.args, **dict(self.kwargs))

    def shape_summary(self) -> str:
        """Human/record-readable digest of the array arguments (the
        reference's format: ``float32[16,48], bool[16,48], k=v``)."""
        def one(v):
            if isinstance(v, TensorSpec):
                return f"{v.dtype.name}[{','.join(map(str, v.shape))}]"
            return repr(v)

        parts = [one(a) for a in self.args]
        parts += [f"{k}={one(v)}" for k, v in self.kwargs.items()]
        return ", ".join(parts)

    def numpy_inputs(self, rng: np.random.Generator):
        """``(args, kwargs)`` with every leaf a seeded host array, drawn
        in argument order from ``rng``."""
        args = tuple(a.numpy(rng) if isinstance(a, TensorSpec) else a for a in self.args)
        kwargs = {k: (v.numpy(rng) if isinstance(v, TensorSpec) else v)
                  for k, v in self.kwargs.items()}
        return args, kwargs

    def materialize(self, device, generator: np.random.Generator):
        """``(args, kwargs)`` with every leaf a seeded tensor on
        ``device``: :meth:`numpy_inputs` copied there."""
        import torch

        args, kwargs = self.numpy_inputs(generator)

        def t(v):
            return torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v

        return tuple(t(a) for a in args), {k: t(v) for k, v in kwargs.items()}


def _idx(dtype) -> np.dtype:
    """The index type beside a float type (int64 beside f64)."""
    return np.dtype(np.int64 if np.dtype(dtype) == np.float64 else np.int32)


# ---------------------------------------------------------------------------
# shape-binding helpers: given one panel size, produce bound entries.  The
# registry's builtin specs call these with their declared shapes.
# ---------------------------------------------------------------------------

def grid_entries(A: int, M: int, dtype, *, modes_impls, tag: str,
                 donated: bool = False) -> list:
    """Grid scalar entries (the benchmarks' hot path) at one panel size,
    one per ``(mode, impl)``, plus, when ``donated``, the whole grid with
    its panels donated (``jk_grid_backtest(..., donate_panels=True)``)."""
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.compile.entries import grid_scalar_fn

    p = sds((A, M), dtype)
    m = sds((A, M), bool)
    out = [
        ManifestEntry(
            name=f"grid.jk16.{mode}.{impl}@{tag}",
            fn=grid_scalar_fn(wl.GRID_JS, wl.GRID_KS, wl.GRID_SKIP, mode, impl),
            args=(p, m),
            kernels=((K2,) if impl == "kernel" else ())
                    + ((K3,) if mode == "rank" else ()),
        )
        for mode, impl in modes_impls
    ]
    if donated:
        idx = _idx(dtype)
        out.append(ManifestEntry(
            name=f"grid.jk16.rank.plain.donated@{tag}",
            fn=functools.partial(jk_grid_backtest, donate_panels=True),
            args=(p, m, sds((len(wl.GRID_JS),), idx, value=wl.GRID_JS),
                  sds((len(wl.GRID_KS),), idx, value=wl.GRID_KS), wl.GRID_SKIP),
            kwargs=dict(n_bins=10, mode="rank", max_hold=max(wl.GRID_KS),
                        freq=12, impl="plain"),
            kernels=(K3,),
            donated=(0, 1),
        ))
    return out


def monthly_entries(A: int, M: int, dtype, tag: str) -> list:
    """The three monthly engines (spread, sector-neutral, net of costs)
    at one panel size; the first two launch K1."""
    from csmom_tpu_torch.backtest.monthly import (
        monthly_spread_backtest,
        net_of_costs_arrays,
        sector_neutral_backtest,
    )

    p = sds((A, M), dtype)
    m = sds((A, M), bool)
    i32 = np.int32
    return [
        ManifestEntry(
            name=f"monthly.spread@{tag}",
            fn=monthly_spread_backtest,
            args=(p, m),
            kwargs=dict(lookback=12, skip=1, n_bins=10, mode="qcut"),
            kernels=(K1,),
        ),
        ManifestEntry(
            name=f"monthly.sector_neutral@{tag}",
            fn=sector_neutral_backtest,
            args=(p, m, sds((A,), i32)),
            kwargs=dict(n_sectors=5, lookback=12, skip=1, n_bins=10,
                        mode="qcut"),
            kernels=(K1,),
        ),
        ManifestEntry(
            name=f"monthly.net_of_costs@{tag}",
            fn=net_of_costs_arrays,
            args=(sds((A, M), i32), sds((10, M), i32), sds((M,), dtype),
                  sds((M,), bool), 0.0005),
            kwargs=dict(n_bins=10),
        ),
    ]


def grid_net_entry(A: int, M: int, dtype, tag: str) -> ManifestEntry:
    """``_grid_net_core`` (the CLI's ``--tc-bps`` netting pass) at the
    grid size; it launches K3 (its rank labels), not K1 or K2."""
    from csmom_tpu_torch.backtest.grid import _grid_net_core

    nJ, nK = len(wl.GRID_JS), len(wl.GRID_KS)
    return ManifestEntry(
        name=f"grid.net_core@{tag}",
        fn=_grid_net_core,
        args=(sds((A, M), dtype), sds((A, M), bool),
              sds((nJ,), _idx(dtype), value=wl.GRID_JS),
              sds((nJ, nK, M), dtype), sds((nJ, nK, M), bool), 1.0),
        kwargs=dict(Ks_c=wl.GRID_KS, skip=wl.GRID_SKIP, n_bins=10,
                    mode="rank", freq=12),
        kernels=(K3,),
    )


def event_entries(A: int, T: int, dtype, tag: str) -> list:
    """The event panel engines (threshold plain and donated, hysteresis)
    at one minute-panel size."""
    from csmom_tpu_torch.backtest.event import (
        event_backtest,
        event_backtest_donated,
        hysteresis_event_backtest,
    )

    p = sds((A, T), dtype)
    v = sds((A, T), bool)
    s = sds((A, T), dtype)
    a = sds((A,), dtype)
    vo = sds((A,), dtype)
    return [
        ManifestEntry(name=f"event.threshold@{tag}", fn=event_backtest,
                      args=(p, v, s, a, vo)),
        ManifestEntry(name=f"event.threshold.donated@{tag}",
                      fn=event_backtest_donated, args=(p, v, s, a, vo),
                      donated=(0, 1, 2)),
        ManifestEntry(
            name=f"event.hysteresis@{tag}", fn=hysteresis_event_backtest,
            args=(p, v, s, a, vo, 1e-4, 1e-5, 50, 1_000_000.0, 0.001),
        ),
    ]


def histrank_entry(A: int, M: int, dtype, tag: str) -> ManifestEntry:
    from csmom_tpu_torch.compile.entries import histrank_labels_fn

    return ManifestEntry(
        name=f"parallel.histrank@{tag}",
        fn=histrank_labels_fn(10),
        args=(sds((A, M), dtype), sds((A, M), bool)),
    )


def online_ridge_entry(R: int, A: int, F: int, dtype, tag: str) -> ManifestEntry:
    """The reference's time-sharded online-ridge scan on one device
    (:func:`~csmom_tpu_torch.compile.entries.online_ridge_rows_fn`)."""
    from csmom_tpu_torch.compile.entries import online_ridge_rows_fn

    return ManifestEntry(
        name=f"parallel.online_ridge@{tag}",
        fn=online_ridge_rows_fn(A, F, 1.0, 8, True),
        args=(sds((R, A, F), dtype), sds((R, A), dtype), sds((R, A), dtype)),
    )


# month counts of the grid panel sizes, from the pack calendar (cached
# per process; workloads.months_in_days is the single source)
_MONTH_CACHE: dict = {}


def months_of(T: int) -> int:
    if T not in _MONTH_CACHE:
        _MONTH_CACHE[T] = wl.months_in_days(T)
    return _MONTH_CACHE[T]


def build_manifest(profile: str, dtype=None) -> list:
    """Manifest entries for one warm-up profile: a registry query (the
    entries the registered compile engines declare for it).  ``dtype``
    overrides the profile's default float type."""
    from csmom_tpu_torch.registry import manifest_entries

    return manifest_entries(profile, dtype)


def __getattr__(name: str):
    if name == "PROFILES":
        # the profiles registered engines declared, not a literal
        from csmom_tpu_torch.registry import manifest_profiles

        return manifest_profiles()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def golden_event_entries(dtype, batch: int | None = None, device=None) -> list:
    """Event-engine entries at the golden event workload's shapes.

    The shapes come from building the golden inputs
    (:func:`csmom_tpu_torch.compile.workloads.golden_event_inputs` on
    ``device``), which runs the intraday pipeline and so warms it too;
    separate from :func:`build_manifest` because that takes seconds.
    ``batch`` adds the ``batch``-wide event entry
    (:func:`~csmom_tpu_torch.compile.entries.batched_event_fn`).
    """
    import torch

    from csmom_tpu_torch.compile.entries import batched_event_fn

    # a torch or a numpy float type: torch.float32 -> "float32"
    dt = np.dtype(str(dtype).removeprefix("torch."))
    price, *_ = wl.golden_event_inputs(getattr(torch, dt.name), device=device)
    A, T = price.shape
    entries = event_entries(A, T, dt, tag=f"golden{A}x{T}")
    if batch:
        entries.append(ManifestEntry(
            name=f"event.batched{batch}@golden{A}x{T}",
            fn=batched_event_fn(batch),
            args=(sds((A, T), dt), sds((A, T), bool), sds((batch, A, T), dt),
                  sds((A,), dt), sds((A,), dt)),
        ))
    return entries
