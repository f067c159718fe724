"""Builtin engine registrations: the five serve endpoints and the ten
compile (warm-up) engines.

Counterpart of ``csmom_tpu.registry.builtin``'s serve registrations, in
the same order and with the same ``output``, ``summary_fields`` and
``panel_family``: ``momentum``, ``turnover``, ``backtest``,
``low_volatility`` and ``zscore_combo``.  The numpy stubs are the
reference's, copied.

Its compile registrations follow, by the reference's names and with its
profiles and shapes: ``grid.jk``, ``grid.net_core``, ``monthly.kernels``,
``event.panel``, ``parallel.histrank``, ``parallel.online_ridge``,
``serve.buckets``, ``stream.signals``, ``mesh.serve`` (profiles
``serve-mesh`` and ``serve-mesh-smoke``) and ``mesh.grid`` (profile
``bench-mesh``).  Profile ``bench-gpu`` takes the place of ``bench-tpu``
(f32; every other profile is f64 unless its engine fixes a type), and
impls take the port's names.  ``grid.jk`` and ``event.panel`` declare
their donated variants (``donated_fn``), whose entries the ``smoke``,
``bench-cpu`` and ``bench-gpu`` profiles list where the reference's do.

Each ``batch_fn(params)`` returns a scorer of the whole micro-batch,
``fn(values f[B, A, M], mask bool[B, A, M])``, where the reference's
returns one request's scorer for ``jax.vmap``.  The scorers run on the
tensors' device with no loop over B, so the kernels they launch do not
launch more often for a larger batch:

- time-axis steps (returns, momentum, rolling windows) act on each
  asset row's months, ``[B*A, M]``, so no request reads another's
  months;
- cross-sectional steps (ranking, z-scores, K1's sums over assets) act
  on each (request, month) column; ``backtest`` runs
  :func:`~csmom_tpu_torch.backtest.monthly.monthly_spread_backtest`'s
  steps on the batch, launching K1 once on ``[A, B*M]``.

Padded rows and padded assets are all-masked and score as the reference
scores them (NaN, or the summary of an empty spread series).
"""

from __future__ import annotations

import numpy as np

from csmom_tpu_torch.registry.core import REGISTRY, EngineSpec, ServeSurface

# days constant the turnover stub shares with signals.turnover's ADV proxy
_TRADING_DAYS_PER_MONTH = 21.0


def _nanmean(a, axis: int):
    """All-NaN-slice-safe nanmean (np.nanmean warns on empty slices; a
    padded stub batch is full of them by design)."""
    ok = np.isfinite(a)
    c = ok.sum(axis=axis)
    s = np.where(ok, a, 0.0).sum(axis=axis)
    return np.where(c > 0, s / np.maximum(c, 1), np.nan)


def _xs_z_np(score, valid):
    """Cross-sectional z-score over the asset axis of f[B, A] (the stub
    mirror of ``strategy.base.xs_zscore`` at the last formation date)."""
    v = valid & np.isfinite(score)
    n = np.maximum(v.sum(axis=1, keepdims=True), 1)
    x = np.where(v, np.nan_to_num(score), 0.0)
    mu = x.sum(axis=1, keepdims=True) / n
    sd = np.sqrt(np.where(v, (x - mu) ** 2, 0.0).sum(axis=1,
                                                     keepdims=True) / n)
    z = np.where(sd > 0, (x - mu) / np.where(sd == 0, 1.0, sd), 0.0)
    return np.where(v, z, 0.0)


def _last(score, valid):
    """The last formation month's score, NaN where it is invalid."""
    import torch

    return torch.where(valid[..., -1], score[..., -1], torch.nan)


def _momentum_batch(params):
    from csmom_tpu_torch.signals.momentum import momentum

    lookback, skip = params["lookback"], params["skip"]

    def fn(values, mask):
        return _last(*momentum(values, mask, lookback=lookback, skip=skip))

    return fn


def _momentum_stub(params):
    lookback, skip = params["lookback"], params["skip"]

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        end = v[:, :, -1 - skip]
        start = v[:, :, -1 - skip - lookback]
        with np.errstate(divide="ignore", invalid="ignore"):
            return end / start - 1.0

    return fn


def _turnover_batch(params):
    import torch

    from csmom_tpu_torch.signals.turnover import turnover_features

    lookback = params["lookback"]

    def fn(values, mask):
        # no shares outstanding in a request: turnover of unit shares
        shares = torch.ones(values.shape[-2], dtype=values.dtype,
                            device=values.device)
        return _last(*turnover_features(values, mask, shares,
                                        lookback=lookback)["turn_avg"])

    return fn


def _turnover_stub(params):
    lookback = params["lookback"]

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        return (_nanmean(v[:, :, -lookback:], -1)
                / _TRADING_DAYS_PER_MONTH)

    return fn


def _backtest_batch(params):
    import torch

    from csmom_tpu_torch.analytics.stats import masked_mean, sharpe
    from csmom_tpu_torch.backtest.monthly import formation_labels, next_month_spread

    lookback, skip = params["lookback"], params["skip"]
    n_bins, mode = params["n_bins"], params["mode"]

    def fn(values, mask):
        # monthly_spread_backtest's steps, its statistics cut to the two
        # the endpoint returns; K1 once for the batch
        ret, ret_valid, labels = formation_labels(values, mask, lookback, skip,
                                                  n_bins, mode)
        spread, ok, _, _ = next_month_spread(ret, ret_valid, labels, n_bins)
        return torch.stack([masked_mean(spread, ok),
                            sharpe(spread, ok, freq_per_year=12)], dim=-1)

    return fn


def _backtest_stub(params):
    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        with np.errstate(divide="ignore", invalid="ignore"):
            ret = v[:, :, 1:] / v[:, :, :-1] - 1.0
        mean = _nanmean(_nanmean(ret, 1), -1)
        return np.stack([np.nan_to_num(mean), np.zeros_like(mean)], axis=-1)

    return fn


def _strategy_last_column(make_strategy_instance):
    """The strategy -> serve-endpoint adapter: score the batch through
    ``Strategy.signal`` (whose steps take ``[B, A, M]``) and serve the
    last formation column.  The strategy is built once per (endpoint,
    params)."""

    def batch(params):
        strat = make_strategy_instance(params)

        def fn(values, mask):
            return _last(*strat.signal(values, mask))

        return fn

    return batch


def _low_volatility_stub(params):
    window = 36  # the registered endpoint's canonical LowVolatility()

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        with np.errstate(divide="ignore", invalid="ignore"):
            ret = v[:, :, 1:] / v[:, :, :-1] - 1.0
        w = ret[:, :, -window:]
        ok = np.isfinite(w)
        n = ok.sum(-1)
        x = np.where(ok, w, 0.0)
        mean = x.sum(-1) / np.maximum(n, 1)
        var = (np.where(ok, (x - mean[..., None]) ** 2, 0.0).sum(-1)
               / np.maximum(n - 1, 1))
        return np.where(n >= 2, -np.sqrt(var), np.nan)

    return fn


def _zscore_combo_stub(params):
    mom_stub = _momentum_stub(params)

    def fn(values, mask):
        v = np.where(mask, values, np.nan)
        mom = mom_stub(values, mask)
        with np.errstate(divide="ignore", invalid="ignore"):
            rev = -(v[:, :, -1] / v[:, :, -2] - 1.0)
        valid = np.isfinite(mom) & np.isfinite(rev)
        z = 0.5 * _xs_z_np(mom, valid) + 0.5 * _xs_z_np(rev, valid)
        return np.where(valid, z, np.nan)

    return fn


def _mk_low_volatility(params):
    from csmom_tpu_torch.strategy.builtin import LowVolatility

    return LowVolatility()


def _mk_zscore_combo(params):
    from csmom_tpu_torch.strategy.builtin import ZScoreCombo

    # equal-weight momentum + short-term reversal, both z-scored per date
    return ZScoreCombo("momentum:0.5,reversal:0.5")


REGISTRY.register(EngineSpec(
    name="momentum", kind="serve",
    description="compounded (J, skip) price momentum at the last "
                "formation date (the reference's signal)",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(batch_fn=_momentum_batch, stub_fn=_momentum_stub,
                       panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="turnover", kind="serve",
    description="trailing-lookback average turnover proxy (monthly "
                "share volume / ADV denominator)",
    axes="values f[B,A,M] monthly volumes, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(batch_fn=_turnover_batch, stub_fn=_turnover_stub,
                       panel_family="volume"),
))

REGISTRY.register(EngineSpec(
    name="backtest", kind="serve",
    description="full monthly decile spread backtest per request panel "
                "-> (mean_spread, ann_sharpe)",
    axes="values f[B,A,M], mask bool[B,A,M] -> f[B,2]",
    serve=ServeSurface(batch_fn=_backtest_batch, stub_fn=_backtest_stub,
                       output="summary",
                       summary_fields=("mean_spread", "ann_sharpe"),
                       panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="low_volatility", kind="serve",
    description="Blitz-van Vliet volatility effect: negated trailing "
                "36m return volatility, through the strategy adapter",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(
        batch_fn=_strategy_last_column(_mk_low_volatility),
        stub_fn=_low_volatility_stub, panel_family="price"),
))

REGISTRY.register(EngineSpec(
    name="zscore_combo", kind="serve",
    description="equal-weight z-scored momentum + short-term reversal "
                "combo, through the strategy adapter",
    axes="values f[B,A,M] month-end prices, mask bool[B,A,M] -> f[B,A]",
    serve=ServeSurface(
        batch_fn=_strategy_last_column(_mk_zscore_combo),
        stub_fn=_zscore_combo_stub, panel_family="price"),
))


# ---------------------------------------------------------------------------
# compile engines: each declares its warm-up profiles and its entries
# there; REGISTRY.manifest_entries(profile) aggregates them
# ---------------------------------------------------------------------------

# the kernel libraries each serve endpoint's scorer launches on the card
# in the service's rank mode: the backtest's K1 and its rank labels' K3
_SERVE_KERNELS = {"backtest": ("decile_partial_sums", "rank_labels")}


def _dt(profile: str, dtype):
    """The profile's default float type (f32 for the card's bench
    profile, f64 otherwise), overridable."""
    if dtype is not None:
        return np.dtype(dtype)
    return np.dtype(np.float32 if profile == "bench-gpu" else np.float64)


def _manifest_mod():
    from csmom_tpu_torch.compile import manifest as m

    return m


def _grid_manifest(profile: str, dtype) -> list:
    from csmom_tpu_torch.compile import workloads as wl

    m = _manifest_mod()
    dt = _dt(profile, dtype)
    A_r, T_r = wl.REDUCED_GRID
    A_f, T_f = wl.NORTH_STAR_GRID
    if profile == "bench-cpu":
        M_r, M_f = m.months_of(T_r), m.months_of(T_f)
        entries = m.grid_entries(
            A_r, M_r, dt, tag=f"{A_r}x{M_r}", donated=True,
            modes_impls=[("rank", "plain"), ("qcut", "plain"),
                         ("rank", "matmul")])
        entries += m.grid_entries(
            A_f, M_f, dt, tag=f"{A_f}x{M_f}",
            modes_impls=[("rank", "plain"), ("rank", "matmul")])
        return entries
    if profile == "bench-gpu":
        M_f = m.months_of(T_f)
        return m.grid_entries(
            A_f, M_f, dt, tag=f"{A_f}x{M_f}", donated=True,
            modes_impls=[("rank", "plain"), ("qcut", "plain"),
                         ("rank", "matmul"), ("rank", "matmul_bf16"),
                         ("rank", "kernel")])
    # smoke: tiny shapes, the grid's code path
    return m.grid_entries(16, 48, dt, tag="16x48", donated=True,
                          modes_impls=[("rank", "plain")])


def _grid_net_manifest(profile: str, dtype) -> list:
    from csmom_tpu_torch.compile import workloads as wl

    m = _manifest_mod()
    dt = _dt(profile, dtype)
    if profile == "bench-cpu":
        A, T = wl.REDUCED_GRID
    elif profile == "bench-gpu":
        A, T = wl.NORTH_STAR_GRID
    else:  # smoke
        return [m.grid_net_entry(16, 48, dt, tag="16x48")]
    M = m.months_of(T)
    return [m.grid_net_entry(A, M, dt, tag=f"{A}x{M}")]


def _monthly_manifest(profile: str, dtype) -> list:
    m = _manifest_mod()
    dt = _dt(profile, dtype)
    if profile == "golden":
        A, M = 20, 60  # the 20-ticker demo universe, ~5y of months
    else:  # smoke
        A, M = 8, 24
    return m.monthly_entries(A, M, dt, tag=f"{A}x{M}")


def _event_manifest(profile: str, dtype) -> list:
    # the golden-shape event entries depend on the data and resolve via
    # manifest.golden_event_entries; the smoke profile pins tiny shapes
    return _manifest_mod().event_entries(4, 32, _dt(profile, dtype),
                                         tag="4x32")


def _histrank_manifest(profile: str, dtype) -> list:
    m = _manifest_mod()
    if profile == "golden":
        return [m.histrank_entry(4096, 120, np.float32, tag="4096x120")]
    return [m.histrank_entry(32, 6, np.float32, tag="32x6")]


def _online_ridge_manifest(profile: str, dtype) -> list:
    m = _manifest_mod()
    dt = _dt(profile, dtype)
    if profile == "golden":
        return [m.online_ridge_entry(64, 8, 4, dt, tag="64x8x4")]
    return [m.online_ridge_entry(12, 3, 2, dt, tag="12x3x2")]


def _grid_entry_factory(*args, **kwargs):
    from csmom_tpu_torch.compile.entries import grid_scalar_fn

    return grid_scalar_fn(*args, **kwargs)


def _batched_event_factory(*args, **kwargs):
    from csmom_tpu_torch.compile.entries import batched_event_fn

    return batched_event_fn(*args, **kwargs)


def _histrank_factory(*args, **kwargs):
    from csmom_tpu_torch.compile.entries import histrank_labels_fn

    return histrank_labels_fn(*args, **kwargs)


def _grid_donated_factory(**params):
    import functools

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest

    return functools.partial(jk_grid_backtest, donate_panels=True)


def _event_donated_factory(**params):
    from csmom_tpu_torch.backtest.event import event_backtest_donated

    return event_backtest_donated


REGISTRY.register(EngineSpec(
    name="grid.jk", kind="compile",
    description="the J x K grid backtest hot entry (the whole grid summed "
                "to one scalar; the benchmarks' grid legs + donated variant)",
    axes="prices f[A,M], mask bool[A,M] -> scalar",
    profiles=("bench-cpu", "bench-gpu", "smoke"),
    manifest_fn=_grid_manifest,
    entry_fn=_grid_entry_factory,
    donated_fn=_grid_donated_factory,
))

REGISTRY.register(EngineSpec(
    name="grid.net_core", kind="compile",
    description="the --tc-bps netting pass over a precomputed grid",
    axes="prices f[A,M] + per-cell label planes -> net grid",
    profiles=("bench-cpu", "bench-gpu", "smoke"),
    manifest_fn=_grid_net_manifest,
))

REGISTRY.register(EngineSpec(
    name="monthly.kernels", kind="compile",
    description="the three monthly engines (spread, sector-neutral, "
                "net-of-costs) at the golden panel",
    axes="prices f[A,M], mask bool[A,M]",
    profiles=("golden", "smoke"),
    manifest_fn=_monthly_manifest,
))

REGISTRY.register(EngineSpec(
    name="event.panel", kind="compile",
    description="the event panel engines (threshold plain + donated, "
                "hysteresis) and the batched event leg",
    axes="price/valid/score f[A,T] minute panels",
    profiles=("smoke",),
    manifest_fn=_event_manifest,
    entry_fn=_batched_event_factory,
    donated_fn=_event_donated_factory,
))

REGISTRY.register(EngineSpec(
    name="parallel.histrank", kind="compile",
    description="sort-free histogram-rank decile labels (single device)",
    axes="x f[A,M], valid bool[A,M] -> labels i32[A,M]",
    profiles=("golden", "smoke"),
    manifest_fn=_histrank_manifest,
    entry_fn=_histrank_factory,
))

REGISTRY.register(EngineSpec(
    name="parallel.online_ridge", kind="compile",
    description="the online-ridge scan on one device, row-major",
    axes="X f[R,A,F], y f[R,A], w f[R,A]",
    profiles=("golden", "smoke"),
    manifest_fn=_online_ridge_manifest,
))


def serve_profile_entries(profile: str, dtype=None) -> list:
    """Every servable engine's scorer at every (endpoint, batch, assets)
    bucket shape of the profile, with the service's signal parameters:
    what ``TorchEngine.warm`` scores."""
    from csmom_tpu_torch.compile.manifest import ManifestEntry, sds
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.service import ServeConfig

    spec = bucket_spec(profile)
    dt = np.dtype(dtype or spec.dtype)
    cfg = ServeConfig()  # the single source of the service's signal params
    params = dict(lookback=cfg.lookback, skip=cfg.skip, n_bins=cfg.n_bins,
                  mode=cfg.mode)
    out = []
    for kind in REGISTRY.serve_endpoints():
        fn = REGISTRY.serve_surface(kind).batch_fn(params)
        for B, A, M in spec.shapes():
            out.append(ManifestEntry(
                name=f"serve.{kind}.b{B}@{A}x{M}",
                fn=fn,
                args=(sds((B, A, M), dt), sds((B, A, M), bool)),
                kernels=_SERVE_KERNELS.get(kind, ()),
            ))
    return out


def serve_profile_entry_names(profile: str) -> set:
    """The entry names of :func:`serve_profile_entries`, from the bucket
    geometry and the serve endpoints alone (torch-free)."""
    from csmom_tpu_torch.serve.buckets import bucket_spec

    spec = bucket_spec(profile)
    return {f"serve.{kind}.b{B}@{A}x{M}"
            for kind in REGISTRY.serve_endpoints()
            for B, A, M in spec.shapes()}


def _stream_manifest(profile: str, dtype=None) -> list:
    """The replay's reconciliation engines (momentum and turnover) at the
    canonical replay panel shapes."""
    from csmom_tpu_torch.compile.manifest import ManifestEntry, sds
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.signals.momentum import momentum
    from csmom_tpu_torch.signals.turnover import turnover_features
    from csmom_tpu_torch.stream.replay import (
        REPLAY_BARS,
        REPLAY_SMOKE_BARS,
        ReplayConfig,
    )

    smoke = profile == "stream-smoke"
    spec = bucket_spec("serve-smoke" if smoke else "serve")
    bars = REPLAY_SMOKE_BARS if smoke else REPLAY_BARS
    cfg = ReplayConfig()  # the single source of the replay signal params
    dt = np.dtype(dtype or cfg.dtype)
    out = []
    for A in spec.asset_buckets:
        p = sds((A, bars), dt)
        m = sds((A, bars), bool)
        out.append(ManifestEntry(
            name=f"stream.momentum@{A}x{bars}",
            fn=momentum, args=(p, m),
            kwargs=dict(lookback=cfg.lookback, skip=cfg.skip),
        ))
        out.append(ManifestEntry(
            name=f"stream.turn_avg@{A}x{bars}",
            fn=turnover_features,
            args=(p, m, sds((A,), dt)),
            kwargs=dict(lookback=cfg.turn_lookback),
        ))
    return out


REGISTRY.register(EngineSpec(
    name="serve.buckets", kind="compile",
    description="the serving tier's closed shape world: every "
                "(endpoint, batch, assets) bucket shape, generated from "
                "the registry's serve endpoints at call time",
    axes="values f[B,A,M], mask bool[B,A,M] per endpoint",
    profiles=("serve", "serve-smoke"),
    manifest_fn=serve_profile_entries,
    manifest_names_fn=serve_profile_entry_names,
))

REGISTRY.register(EngineSpec(
    name="stream.signals", kind="compile",
    description="the replay's reconciliation engines (momentum and "
                "turnover at the canonical replay shapes)",
    axes="prices/volumes f[A,bars], mask bool[A,bars]",
    profiles=("stream", "stream-smoke"),
    manifest_fn=_stream_manifest,
))


def mesh_serve_profile_entries(profile: str, dtype=None) -> list:
    """The sharded serve bucket grid: every (endpoint, batch, assets)
    shape's mesh entry on the devices the mesh engine resolves (the
    pinned slice or the visible cards; without a card, the CPU's
    logical shards the pinned slice counts, one without a slice),
    named ``mesh.serve.{kind}.b{B}@{A}x{M}.d{n}`` with ``n`` the
    shape's shard count, then the scaling probe's single-device scorer
    at the largest bucket, which :class:`~csmom_tpu_torch.serve.engine.
    MeshTorchEngine` warms too."""
    import torch

    from csmom_tpu_torch.compile.manifest import ManifestEntry, sds
    from csmom_tpu_torch.mesh.variants import sharded_serve_jit_for
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.engine import serve_entry_fn
    from csmom_tpu_torch.serve.service import ServeConfig

    spec = bucket_spec("serve-smoke" if profile.endswith("-smoke") else "serve")
    dt = np.dtype(dtype or spec.dtype)
    cfg = ServeConfig()  # the single source of the service's signal params
    params = (cfg.lookback, cfg.skip, cfg.n_bins, cfg.mode)
    device = None if torch.cuda.is_available() else "cpu"
    out = []
    for kind in REGISTRY.serve_endpoints():
        for B, A, M in spec.shapes():
            fn, n = sharded_serve_jit_for(kind, B, A, *params, device=device)
            out.append(ManifestEntry(
                name=f"mesh.serve.{kind}.b{B}@{A}x{M}.d{n}",
                fn=fn,
                args=(sds((B, A, M), dt), sds((B, A, M), bool)),
                kernels=_SERVE_KERNELS.get(kind, ()),
            ))
    probe = REGISTRY.serve_endpoints()[0]
    B, A, M = spec.batch_buckets[-1], spec.asset_buckets[-1], spec.months
    out.append(ManifestEntry(
        name=f"mesh.serve.single-probe.{probe}.b{B}@{A}x{M}",
        fn=serve_entry_fn(probe, *params),
        args=(sds((B, A, M), dt), sds((B, A, M), bool)),
        kernels=_SERVE_KERNELS.get(probe, ()),
    ))
    return out


def _mesh_grid_manifest(profile: str, dtype=None) -> list:
    """The grid-cell x asset sharded J x K entries (the reduced and the
    north-star panels) on the visible cards, one logical CPU shard
    without one: the cached callable the sharded grid runs
    (:func:`~csmom_tpu_torch.parallel.collectives.grid_shard_fn`), K2 and K3
    once per shard."""
    import torch

    from csmom_tpu_torch.compile import workloads as wl
    from csmom_tpu_torch.compile.manifest import ManifestEntry, months_of, sds
    from csmom_tpu_torch.mesh.pinning import shards_for
    from csmom_tpu_torch.mesh.rules import grid_asset_mesh
    from csmom_tpu_torch.parallel.collectives import grid_shard_fn

    dt = _dt(profile, dtype)
    idx = np.dtype(np.int64)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = ([torch.device("cuda", i) for i in range(n)] if n
               else [torch.device("cpu")])
    nJ = len(wl.GRID_JS)
    g = shards_for(nJ, len(devices))
    out = []
    for A, T in (wl.REDUCED_GRID, wl.NORTH_STAR_GRID):
        a = shards_for(A, max(1, len(devices) // g))
        fn = grid_shard_fn(grid_asset_mesh(g, a, devices), wl.GRID_SKIP, 10,
                           "rank", max(wl.GRID_KS), "kernel")
        M = months_of(T)
        out.append(ManifestEntry(
            name=f"mesh.grid.jk16.rank.kernel@{A}x{M}.g{g}a{a}",
            fn=fn,
            args=(sds((A, M), dt), sds((A, M), bool),
                  sds((nJ,), idx, value=wl.GRID_JS),
                  sds((len(wl.GRID_KS),), idx, value=wl.GRID_KS)),
            kernels=("cohort_partial_sums", "rank_labels"),
        ))
    return out


REGISTRY.register(EngineSpec(
    name="mesh.serve", kind="compile",
    description="the sharded serve bucket grid: batch- or asset-axis "
                "sharded micro-batch scorers per endpoint on the mesh "
                "engine's devices (csmom_tpu_torch/mesh partition rules)",
    axes="values f[B,A,M], mask bool[B,A,M] per endpoint, batch or "
         "asset axis sharded",
    profiles=("serve-mesh", "serve-mesh-smoke"),
    manifest_fn=mesh_serve_profile_entries,
))

REGISTRY.register(EngineSpec(
    name="mesh.grid", kind="compile",
    description="the grid-cell x asset sharded J x K backtest entries "
                "(reduced and north-star panels) on the visible cards",
    axes="prices f[A,M], mask bool[A,M], Js/Ks grid-sharded",
    profiles=("bench-mesh",),
    manifest_fn=_mesh_grid_manifest,
))
