"""Sharded variants of the registry's engines, resolved by a rule table.

Counterpart of :mod:`csmom_tpu.mesh.variants`, its non-serve half.
:func:`resolve_sharded` maps ``kind:name`` to a factory by regex (the
pattern :mod:`~csmom_tpu_torch.mesh.rules` applies to array leaves);
:meth:`csmom_tpu_torch.registry.core.EngineSpec.sharded` resolves
through it.  Each variant takes the placement its axes admit and reuses
the engines of :mod:`csmom_tpu_torch.parallel`:

- the J x K grid (:func:`sharded_grid_fn`): J cells over the
  collective-free ``grid`` axis, assets over ``assets``, through the
  cached :func:`~csmom_tpu_torch.parallel.collectives.grid_shard_fn`
  (the callable the ``bench-mesh`` warm-up profile runs);
- the netting pass (:func:`sharded_grid_net_fn`): J cells, no
  communication;
- the monthly engines, the event panel, histrank: assets;
- the online ridge: time;
- the stream reconciliation signals: assets, no communication.

The serve endpoints' variants (batch or asset axis per endpoint) are
the mesh serving engine, ROADMAP.md Queue 1 item 7b; their rules raise
naming it.  A variant's devices are an explicit list, else the slice a
worker was pinned to (:mod:`~csmom_tpu_torch.mesh.pinning`), else every
visible card; a device may repeat (logical shards on one device).
"""

from __future__ import annotations

import re
from functools import lru_cache

__all__ = [
    "has_sharded",
    "resolve_sharded",
    "sharded_grid_fn",
    "sharded_grid_net_fn",
    "sharded_stream_signals_fn",
]

_SERVE_PENDING = ("the sharded serve endpoints are the mesh serving engine, "
                  "not ported yet (ROADMAP.md, Queue 1 item 7b)")


def _devices(devices=None) -> tuple:
    """The devices a variant builds its mesh over: ``devices``, the
    pinned slice of the visible cards, or every visible card."""
    import os

    from csmom_tpu_torch.mesh.pinning import DEVICE_SLICE_ENV, parse_device_slice
    from csmom_tpu_torch.parallel.mesh import visible_devices

    if devices is not None:
        return tuple(devices)
    all_devices = tuple(visible_devices())
    env = os.environ.get(DEVICE_SLICE_ENV)
    if env:
        start, count = parse_device_slice(env)
        if start + count > len(all_devices):
            raise ValueError(f"pinned device slice {env!r} exceeds the "
                             f"{len(all_devices)} visible devices")
        return all_devices[start:start + count]
    return all_devices


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

def _serve_pending(spec):
    raise NotImplementedError(f"{spec.kind} engine {spec.name!r}: {_SERVE_PENDING}")


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
    (r"^compile:mesh\.grid$", lambda spec: sharded_grid_fn),
    (r"^compile:(serve\.buckets|mesh\.serve)$", _serve_pending),
    (r"^serve:", _serve_pending),
)


def has_sharded(spec) -> bool:
    """Whether a rule resolves a sharded variant for ``spec``, without
    building it."""
    key = f"{spec.kind}:{spec.name}"
    rule = next((f for r, f in _SHARDED_RULES if re.search(r, key)), None)
    return rule is not None and rule is not _serve_pending


def resolve_sharded(spec):
    """The sharded-variant factory of one registered engine, or None
    when no rule matches; a serve rule raises, naming item 7b."""
    key = f"{spec.kind}:{spec.name}"
    for rule, factory in _SHARDED_RULES:
        if re.search(rule, key):
            return factory(spec)
    return None
