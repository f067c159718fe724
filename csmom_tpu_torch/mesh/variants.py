"""Sharded variants of the registry's engines, resolved by a rule table.

Counterpart of :mod:`csmom_tpu.mesh.variants`.  :func:`resolve_sharded`
maps ``kind:name`` to a factory by regex (the pattern
:mod:`~csmom_tpu_torch.mesh.rules` applies to array leaves);
:meth:`csmom_tpu_torch.registry.core.EngineSpec.sharded` resolves
through it, so a serve endpoint registered at runtime gets its sharded
surface with no edit here.  Each variant takes the placement its axes
admit and reuses the engines of :mod:`csmom_tpu_torch.parallel`:

- the serve endpoints (:func:`sharded_serve_entry_fn`): the micro-batch
  scorer ``fn(values f[B, A, M], mask) -> f[B, A] | f[B, k]`` with the
  batch axis split across shards (requests are independent), or the
  asset axis for the per-asset signals (``rules.serve_axis_for``).  The
  shard count is the largest divisor of the bucket axis that fits the
  devices (``pinning.shards_for``); one shard is the single-device
  scorer itself.  The shards never meet, so they run one after another
  on the caller's thread (``shard_map(..., collective_free=True)``);
- the J x K grid (:func:`sharded_grid_fn`): J cells over the
  collective-free ``grid`` axis, assets over ``assets``, through the
  cached :func:`~csmom_tpu_torch.parallel.collectives.grid_shard_fn`
  (the callable the ``bench-mesh`` warm-up profile runs);
- the netting pass (:func:`sharded_grid_net_fn`): J cells, no
  communication;
- the monthly engines, the event panel, histrank: assets;
- the online ridge: time;
- the stream reconciliation signals: assets, no communication.

A variant's devices are an explicit list (a device may repeat: logical
shards of one device), else the slice a worker was pinned to
(:mod:`~csmom_tpu_torch.mesh.pinning`), else every visible card.  The
serve variants also take ``device=``: a single device (``"cpu"``,
``"cuda:0"``) whose pinned slice ``"<start>:<count>"`` means ``count``
logical shards of it (one without a slice), where ``None`` or
``"cuda"`` means the visible cards.
"""

from __future__ import annotations

import re
from functools import lru_cache, partial

__all__ = [
    "ShardedServeEntry",
    "has_sharded",
    "resolve_sharded",
    "sharded_grid_fn",
    "sharded_grid_net_fn",
    "sharded_serve_entry_fn",
    "sharded_serve_jit_for",
    "sharded_stream_signals_fn",
]


def _single_device(device):
    """The one device ``device`` names (``"cpu"``, ``"cuda:0"``), or None
    when it names the visible cards (``None``, ``"cuda"``)."""
    import torch

    if device is None:
        return None
    d = torch.device(device)
    return None if d.type == "cuda" and d.index is None else d


def _devices(devices=None, device=None) -> tuple:
    """The devices a variant builds its mesh over: ``devices``; else, for
    a single ``device``, as many logical shards of it as the pinned
    slice counts (one without a slice); else the pinned slice of the
    visible cards, or every visible card."""
    import os

    import torch

    from csmom_tpu_torch.mesh.pinning import DEVICE_SLICE_ENV, parse_device_slice
    from csmom_tpu_torch.parallel.mesh import visible_devices

    if devices is not None:
        return tuple(torch.device(d) for d in devices)
    env = os.environ.get(DEVICE_SLICE_ENV)
    one = _single_device(device)
    if one is not None:
        return (one,) * (parse_device_slice(env)[1] if env else 1)
    all_devices = tuple(visible_devices())
    if env:
        start, count = parse_device_slice(env)
        if start + count > len(all_devices):
            raise ValueError(f"pinned device slice {env!r} exceeds the "
                             f"{len(all_devices)} visible devices")
        return all_devices[start:start + count]
    return all_devices


# --------------------------------------------------------------- serve ----

@lru_cache(maxsize=128)
def _sharded_serve_call(surface, lookback: int, skip: int, n_bins: int,
                        mode: str, axis: str, n_shards: int, devices: tuple):
    """One sharded micro-batch scorer, process-shared and keyed on the
    *surface* object (as the single-device scorer is), so an endpoint
    registered again gets a new one.  One shard: the single-device
    scorer itself."""
    from csmom_tpu_torch.mesh.rules import P, named_mesh
    from csmom_tpu_torch.mesh.shard import sharded_call
    from csmom_tpu_torch.serve.engine import scorer_for

    one = scorer_for(surface, lookback, skip, n_bins, mode)
    if axis == "batch":
        in_spec, out_spec = P("batch", None, None), P("batch", None)
    else:
        in_spec, out_spec = P(None, "assets", None), P(None, "assets")
    return sharded_call(one, named_mesh(axis, n_shards, devices),
                        (in_spec, in_spec), out_spec, collective_free=True)


class ShardedServeEntry:
    """The dispatchable sharded scorer of one (endpoint, params).

    Called like the single-device scorer, ``fn(values f[B, A, M], mask
    bool[B, A, M])``, on tensors (or arrays), which it first moves to
    its mesh's first device, where the result lands.  The shard count
    is chosen per bucket shape (the largest divisor of the split axis
    that fits the devices), so every (endpoint, bucket, device count)
    scorer is enumerable: the ``serve-mesh`` warm-up profile runs each.
    """

    def __init__(self, kind: str, surface, lookback: int, skip: int,
                 n_bins: int, mode: str, axis: str, devices: tuple):
        self.kind = kind
        self.surface = surface
        self.params = (lookback, skip, n_bins, mode)
        self.axis = axis
        self.devices = devices

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def shards_for_shape(self, B: int, A: int) -> int:
        from csmom_tpu_torch.mesh.pinning import shards_for

        return shards_for(B if self.axis == "batch" else A, self.n_devices)

    def call_for(self, B: int, A: int):
        """The scorer this entry dispatches at bucket ``(B, A)``."""
        return _sharded_serve_call(self.surface, *self.params, self.axis,
                                   self.shards_for_shape(B, A), self.devices)

    def __call__(self, values, mask):
        import torch

        home = self.devices[0]
        values = torch.as_tensor(values).to(home)
        mask = torch.as_tensor(mask).to(home)
        return self.call_for(values.shape[0], values.shape[1])(values, mask)


def sharded_serve_jit_for(kind: str, B: int, A: int, lookback: int = 12,
                          skip: int = 1, n_bins: int = 10, mode: str = "rank",
                          devices=None, device=None):
    """``(callable, shard count)`` of one bucket shape: the entry the
    ``serve-mesh`` warm-up profile runs, which moves its inputs to the
    mesh's first device and calls the scorer :class:`ShardedServeEntry`
    dispatches at that shape."""
    entry = sharded_serve_entry_fn(kind, lookback, skip, n_bins, mode,
                                   devices=devices, device=device)
    return entry, entry.shards_for_shape(B, A)


def sharded_serve_entry_fn(kind: str, lookback: int = 12, skip: int = 1,
                           n_bins: int = 10, mode: str = "rank", *,
                           devices=None, axis: str | None = None, device=None):
    """A serve endpoint's sharded micro-batch scorer
    (:class:`ShardedServeEntry`).

    ``axis`` defaults to the endpoint's placement rule
    (:func:`csmom_tpu_torch.mesh.rules.serve_axis_for`); the asset axis
    of a summary endpoint raises, since splitting the cross-section
    would change the reduction order.  ``devices``/``device`` resolve as
    the module docstring says.
    """
    from csmom_tpu_torch.mesh.rules import serve_axis_for
    from csmom_tpu_torch.serve.engine import _surface_or_raise

    surface = _surface_or_raise(kind)
    if axis is None:
        axis = serve_axis_for(kind)
    if axis == "assets" and surface.output == "summary":
        raise ValueError(
            f"endpoint {kind!r} reduces over the cross-section (summary "
            "output): asset-axis sharding would change the reduction "
            "order; use the batch axis")
    return ShardedServeEntry(kind, surface, lookback, skip, n_bins, mode,
                             axis, _devices(devices, device))


# ---------------------------------------------------------------- grid ----

def _grid_mesh(n_J: int, A: int, devices: tuple, grid_shards=None,
               asset_shards=None):
    """The (grid, assets) mesh of a J x K run: grid cells first (no
    communication), the rest to assets, both divisors so nothing pads."""
    from csmom_tpu_torch.mesh.pinning import shards_for
    from csmom_tpu_torch.mesh.rules import grid_asset_mesh

    g = grid_shards or shards_for(n_J, len(devices))
    a = asset_shards or shards_for(A, max(1, len(devices) // g))
    return grid_asset_mesh(g, a, devices)


def sharded_grid_fn(devices=None, *, impl: str = "kernel", grid_shards=None,
                    asset_shards=None):
    """The grid-cell x asset sharded J x K backtest: ``fn(prices f[A, M],
    mask, Js, Ks, **kw) -> GridResult``, the sharded twin of
    :func:`~csmom_tpu_torch.backtest.grid.jk_grid_backtest`."""
    devs = _devices(devices)

    def fn(prices, mask, Js, Ks, skip: int = 1, n_bins: int = 10,
           mode: str = "qcut", max_hold=None, freq: int = 12):
        from csmom_tpu_torch.parallel.collectives import sharded_jk_grid_backtest

        mesh = _grid_mesh(len(Js), prices.shape[0], devs, grid_shards,
                          asset_shards)
        return sharded_jk_grid_backtest(prices, mask, Js, Ks, mesh, skip=skip,
                                        n_bins=n_bins, mode=mode,
                                        max_hold=max_hold, freq=freq, impl=impl)

    return fn


def sharded_grid_net_fn(devices=None, *, grid_shards=None):
    """The grid-cell sharded ``--tc-bps`` netting pass.  Each J's books
    and costs are its own, so a J slice nets shard-locally with no
    communication; the summary statistics come from the gathered net
    planes, as the single-device pass computes them."""
    devs = _devices(devices)

    def fn(prices, mask, Js, spreads, spread_valid, half_spread, Ks_c: tuple,
           skip: int = 1, n_bins: int = 10, mode: str = "qcut", freq: int = 12):
        import torch

        from csmom_tpu_torch.backtest.grid import _grid_net_core_impl, _netted
        from csmom_tpu_torch.mesh.pinning import shards_for
        from csmom_tpu_torch.mesh.rules import P, named_mesh
        from csmom_tpu_torch.mesh.shard import sharded_call

        Js = torch.as_tensor(Js).to(torch.int64)
        mesh = named_mesh("grid", grid_shards or shards_for(len(Js), len(devs)),
                          devs)

        def local(p, m, Js_l, spreads_l, valid_l):
            return _grid_net_core_impl(p, m, Js_l, spreads_l, valid_l,
                                       half_spread, Ks_c, skip, n_bins, mode)

        plane = P("grid", None, None)
        net = sharded_call(local, mesh, (P(), P(), P("grid"), plane, plane),
                           plane, collective_free=True)(
            prices, mask, Js, spreads, spread_valid)
        valid = torch.as_tensor(spread_valid).to(net.device)
        return _netted(net, valid, Js.to(net.device), tuple(Ks_c),
                       torch.tensor(skip, device=net.device), n_bins, mode, freq)

    return fn


# ------------------------------------------------- asset and time axes ----

def _asset_mesh_2d(A: int, devices: tuple):
    """The 1 x N (grid, assets) mesh of the collectives engines, N the
    largest divisor of A that fits."""
    from csmom_tpu_torch.mesh.pinning import shards_for
    from csmom_tpu_torch.mesh.rules import grid_asset_mesh

    return grid_asset_mesh(1, shards_for(A, len(devices)), devices)


def _sharded_monthly_fn(devices=None):
    devs = _devices(devices)

    def fn(prices, mask, **kwargs):
        from csmom_tpu_torch.parallel.collectives import sharded_monthly_spread_backtest

        return sharded_monthly_spread_backtest(
            prices, mask, _asset_mesh_2d(prices.shape[0], devs), **kwargs)

    return fn


def _sharded_event_fn(devices=None):
    devs = _devices(devices)

    def fn(price, valid, score, adv, vol, **kwargs):
        from csmom_tpu_torch.parallel.event import sharded_event_backtest

        return sharded_event_backtest(price, valid, score, adv, vol,
                                      _asset_mesh_2d(price.shape[0], devs),
                                      **kwargs)

    return fn


def _sharded_histrank_fn(n_bins: int = 10, devices=None):
    devs = _devices(devices)

    def fn(x, valid):
        from csmom_tpu_torch.mesh.pinning import shards_for
        from csmom_tpu_torch.mesh.rules import P, named_mesh
        from csmom_tpu_torch.mesh.shard import sharded_call
        from csmom_tpu_torch.parallel.histrank import histogram_rank_labels

        n = shards_for(x.shape[0], len(devs))
        spec = P("assets", None)
        return sharded_call(
            lambda x_l, v_l: histogram_rank_labels(x_l, v_l, n_bins, "assets"),
            named_mesh("assets", n, devs), (spec, spec), spec)(x, valid)

    return fn


def _sharded_online_ridge_fn(devices=None):
    devs = _devices(devices)

    def fn(features, y, valid, **kwargs):
        from csmom_tpu_torch.mesh.rules import named_mesh
        from csmom_tpu_torch.parallel.online_ridge import (
            time_sharded_online_ridge_scores,
        )

        # rows pad inside the engine, so the time mesh takes every device
        return time_sharded_online_ridge_scores(
            features, y, valid, named_mesh("time", len(devs), devs), **kwargs)

    return fn


def sharded_stream_signals_fn(devices=None):
    """Asset-sharded twins of the stream reconciliation engines
    (``momentum`` and ``turn_avg`` over ``[A, bars]`` panels): per-asset
    signals, split with no communication, so each equals the
    single-device engine bit for bit."""
    devs = _devices(devices)

    def make(which):
        @lru_cache(maxsize=16)
        def call_for(n_shards, lookback, skip):
            from csmom_tpu_torch.mesh.rules import P, named_mesh
            from csmom_tpu_torch.mesh.shard import sharded_call
            from csmom_tpu_torch.signals.momentum import momentum
            from csmom_tpu_torch.signals.turnover import turnover_features

            if which == "momentum":
                def local(p, m):
                    return momentum(p, m, lookback=lookback, skip=skip)
            else:
                def local(p, m):
                    shares = p.new_ones((p.shape[0],))
                    return turnover_features(p, m, shares,
                                             lookback=lookback)["turn_avg"]
            spec = P("assets", None)
            return sharded_call(local, named_mesh("assets", n_shards, devs),
                                (spec, spec), (spec, spec), collective_free=True)

        def fn(panel, mask, lookback: int = 12, skip: int = 1):
            from csmom_tpu_torch.mesh.pinning import shards_for

            return call_for(shards_for(panel.shape[0], len(devs)), lookback,
                            skip)(panel, mask)

        return fn

    return {"momentum": make("momentum"), "turn_avg": make("turn_avg")}


# ------------------------------------------------------- the rule table ---

# kind:name -> factory(spec) -> the engine's sharded variant.  First match
# wins; no match: the registry's pointed NotImplementedError
_SHARDED_RULES = (
    (r"^compile:grid\.jk$", lambda spec: sharded_grid_fn),
    (r"^compile:grid\.net_core$", lambda spec: sharded_grid_net_fn),
    (r"^compile:monthly\.kernels$", lambda spec: _sharded_monthly_fn),
    (r"^compile:event\.panel$", lambda spec: _sharded_event_fn),
    (r"^compile:parallel\.histrank$", lambda spec: _sharded_histrank_fn),
    (r"^compile:parallel\.online_ridge$", lambda spec: _sharded_online_ridge_fn),
    (r"^compile:stream\.signals$", lambda spec: sharded_stream_signals_fn),
    # the bucket grid's and the mesh feeders' own sharded surface is what
    # they feed: the per-endpoint scorer resolver, the sharded grid
    (r"^compile:serve\.buckets$", lambda spec: sharded_serve_entry_fn),
    (r"^compile:mesh\.serve$", lambda spec: sharded_serve_entry_fn),
    (r"^compile:mesh\.grid$", lambda spec: sharded_grid_fn),
    # any servable engine, a runtime registration included: the batch
    # axis is safe for every per-request scorer
    (r"^serve:", lambda spec: partial(sharded_serve_entry_fn, spec.name)),
)


def has_sharded(spec) -> bool:
    """Whether a rule resolves a sharded variant for ``spec``, without
    building it."""
    key = f"{spec.kind}:{spec.name}"
    return any(re.search(r, key) for r, _ in _SHARDED_RULES)


def resolve_sharded(spec):
    """The sharded-variant factory of one registered engine, or None
    when no rule matches."""
    key = f"{spec.kind}:{spec.name}"
    for rule, factory in _SHARDED_RULES:
        if re.search(rule, key):
            return factory(spec)
    return None
