"""The port's ``csmom`` CLI: ``python -m csmom_tpu_torch.cli``.

Counterpart of the research commands of :mod:`csmom_tpu.cli.main`:
``run``, ``replicate``, ``grid``, ``sweep``, ``doublesort``,
``intraday``, ``horizons``, ``residual``, ``strategies``, ``pack-info``,
``fetch`` and ``warmup``, of the serving tier's ``serve`` and ``loadgen``
(:mod:`csmom_tpu_torch.cli.serve`), of ``fleet``
(:mod:`csmom_tpu_torch.cli.fleet`), ``trace``
(:mod:`csmom_tpu_torch.cli.trace`), ``replay``
(:mod:`csmom_tpu_torch.cli.replay`), ``registry``
(:mod:`csmom_tpu_torch.cli.registry`), ``lint``
(:mod:`csmom_tpu_torch.cli.lint`), ``rehearse``
(:mod:`csmom_tpu_torch.cli.rehearse`) and ``timeline``
(:mod:`csmom_tpu_torch.cli.timeline`).  Each prints what
``csmom`` prints for the same arguments, line for line (``intraday --threshold-sweep`` names its one
engine run a threshold where the reference names one vmapped call); the
subcommand table in ``--help`` is generated from the parser itself.

The flags that differ are the device's and the kernels':

- ``--device {cuda,cpu}`` (default cuda) takes the place of
  ``--platform``; without a card a command that computes exits 2 and
  names ``--device cpu``, and nothing moves to the CPU by itself;
- ``--backend {torch,pandas}``: ``tpu`` (the reference's name, as in its
  config files) means the card engine ``torch``;
- ``grid --impl {kernel,plain,matmul,matmul_bf16}``, the reference's
  ``pallas`` and ``xla`` accepted as ``kernel`` and ``plain``;
- ``grid --shards N`` runs the sharded grid on a mesh of the visible
  cards (``--device cuda``; N above their count exits 2) or of N logical
  CPU shards (``--device cpu``, where the reference forces N host
  devices); ``--mode rank_hist`` implies it;
- ``warmup`` warms by running each manifest entry on the device (its
  profile ``bench-gpu`` takes the place of ``bench-tpu``, which it
  accepts), and has no ``--platform``; the mesh profiles
  (``serve-mesh``, ``bench-mesh``) run on the visible cards, or on one
  CPU shard without a card;
- ``rehearse --device {cuda,cpu}`` (default cuda) is the device of its
  warm-up scenario only: the stub scenarios touch no device and run
  without a card.

``--config file.toml`` loads a :class:`~csmom_tpu_torch.config.RunConfig`;
flags given on the command line override the file.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

from csmom_tpu_torch.config import RunConfig, load_config

log = logging.getLogger("csmom_tpu_torch.cli")

PROG = "python -m csmom_tpu_torch.cli"

# the reference's --impl names of the same cohort sums
_IMPL_ALIASES = {"pallas": "kernel", "xla": "plain"}

def _parse_tickers(s: str) -> tuple:
    """One comma-list parser for every --tickers flag (fetch included)."""
    return tuple(t.strip().upper() for t in s.split(",") if t.strip())


def _load_cfg(args) -> RunConfig:
    cfg = load_config(args.config) if args.config else RunConfig()
    if getattr(args, "backend", None):
        cfg = dataclasses.replace(cfg, backend=args.backend)
    if cfg.backend == "tpu":  # the reference's name of the card engine
        cfg = dataclasses.replace(cfg, backend="torch")
    if getattr(args, "out", None):
        cfg = dataclasses.replace(cfg, results_dir=args.out)
    if getattr(args, "data_dir", None):
        cfg = dataclasses.replace(
            cfg, universe=dataclasses.replace(cfg.universe, data_dir=args.data_dir)
        )
    if getattr(args, "tickers", None) and args.command != "fetch":
        cfg = dataclasses.replace(
            cfg,
            universe=dataclasses.replace(cfg.universe,
                                         tickers=_parse_tickers(args.tickers)),
            explicit_universe=True,
        )
    mom = cfg.momentum
    explicit = set(cfg.explicit_momentum)  # config-file keys (load_config)
    for field in ("lookback", "skip", "n_bins", "mode"):
        v = getattr(args, field, None)
        if v is not None:
            mom = dataclasses.replace(mom, **{field: v})
            explicit.add(field)
    return dataclasses.replace(cfg, momentum=mom,
                               explicit_momentum=tuple(sorted(explicit)))


def _price_panel(cfg: RunConfig, device):
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.panel.pack import is_packed

    tickers = list(cfg.universe.tickers)
    if not cfg.explicit_universe and is_packed(cfg.universe.data_dir):
        # a packed --data-dir with no chosen universe means the whole pack
        tickers = None
    return monthly_price_panel(cfg.universe.data_dir, tickers, device=device)


def _tensor(x, device, dtype=None):
    import numpy as np
    import torch

    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _host(x):
    import numpy as np

    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _can_plot(what: str) -> bool:
    """Whether matplotlib is installed; when it is not, the command's
    tables are printed and ``what`` is not written (a warning says so)."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        log.warning("matplotlib is not installed: %s not written", what)
        return False
    return True


def _index_dtype(x):
    """The bootstrap's draw width: int64 indices for float64 data (what the
    reference draws with 64-bit types on), int32 otherwise (off)."""
    import torch

    return torch.int64 if x.dtype == torch.float64 else torch.int32


def _load_sector_map(path: str, tickers):
    """``ticker,sector`` CSV -> (ids i32[A], n_sectors) aligned to the panel.

    Sector names factorize in sorted order; panel tickers absent from the
    file get id -1 (excluded from sector-neutral ranking) with a warning
    naming them.
    """
    import numpy as np
    import pandas as pd

    df = pd.read_csv(path)
    df.columns = [c.strip().lower() for c in df.columns]
    if not {"ticker", "sector"} <= set(df.columns):
        raise SystemExit(
            f"--sector-map {path}: need columns ticker,sector "
            f"(got {list(df.columns)})"
        )
    mapping = dict(zip(df["ticker"].astype(str).str.strip().str.upper(),
                       df["sector"].astype(str).str.strip()))
    names = sorted(set(mapping.values()))
    code = {s: i for i, s in enumerate(names)}
    ids = np.full(len(tickers), -1, np.int32)
    missing = []
    for i, t in enumerate(tickers):
        s = mapping.get(str(t).upper())
        if s is None:
            missing.append(str(t))
        else:
            ids[i] = code[s]
    if missing:
        log.warning("sector map has no entry for %s — excluded from ranking",
                    ",".join(missing))
    if (ids >= 0).sum() == 0:
        raise SystemExit(
            f"--sector-map {path}: no entry matches any panel ticker — "
            "check the ticker naming convention"
        )
    return ids, len(names)


def _parse_strategy(args, cfg):
    """``--strategy name [--strategy-arg k=v ...]`` -> Strategy | None.

    A ``lookback``/``skip`` the user set (flag or config file) overrides a
    strategy field of the same name; built-in defaults leave each
    strategy's own defaults alone.  The resolved instance is printed.
    """
    name = getattr(args, "strategy", None)
    if not name:
        return None
    import ast

    from csmom_tpu_torch.strategy import available_strategies, make_strategy

    params = {}
    for kv in getattr(args, "strategy_arg", None) or []:
        k, _, v = kv.partition("=")
        try:
            params[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            params[k] = v
    cls = available_strategies().get(name)
    if cls is not None:
        field_names = {f.name for f in dataclasses.fields(cls)}
        for fld in set(cfg.explicit_momentum) & {"lookback", "skip"}:
            if fld in field_names and fld not in params:
                params[fld] = getattr(cfg.momentum, fld)
    strat = make_strategy(name, **params)
    print(f"strategy: {strat}")
    return strat


def _parse_widths(spec, flag):
    try:
        widths = [int(s) for s in spec.split(",") if s.strip()]
    except ValueError:
        print(f"{flag} {spec!r}: widths must be plain integers, "
              f"e.g. {flag} 0,1,2", file=sys.stderr)
        return None
    if not widths:
        print(f"{flag}: empty width list", file=sys.stderr)
        return None
    return widths


def cmd_replicate(args) -> int:
    """Monthly momentum replication on either backend; ``--strategy`` swaps
    the ranked signal without touching the engine."""
    import numpy as np
    import torch

    cfg = _load_cfg(args)
    dev = args.device
    prices, volume = _price_panel(cfg, dev)

    from csmom_tpu_torch.backends.dispatch import run_monthly

    strategy = _parse_strategy(args, cfg)
    panels = {}
    if strategy is not None:
        from csmom_tpu_torch.strategy import consumed_panels

        # offer the volume panels, forward only what the signal reads
        offered = {"volumes": volume.values, "volumes_mask": volume.mask}
        allowed = consumed_panels(strategy)
        panels = {k: v for k, v in offered.items() if k in allowed}
    sector_kw = {}
    if getattr(args, "sector_map", None):
        if cfg.backend != "torch":
            print("--sector-map needs the card engine (drop "
                  "--backend pandas); any --strategy plugin works",
                  file=sys.stderr)
            return 2
        ids, n_sectors = _load_sector_map(args.sector_map, prices.tickers)
        sector_kw = {"sector_ids": ids, "n_sectors": n_sectors}
        print(f"sector-neutral ranking: {n_sectors} sectors"
              + (f" (signal: {args.strategy})" if strategy is not None else ""))
    # --band/--band-sweep/--band-select are validated before the plain run
    band_sweep = band_select = None
    want_band = getattr(args, "band", None) is not None
    if (want_band or getattr(args, "band_sweep", None)
            or getattr(args, "band_select", None)):
        from csmom_tpu_torch.backtest.banded import validate_band

        if getattr(args, "band_sweep", None):
            band_sweep = _parse_widths(args.band_sweep, "--band-sweep")
            if band_sweep is None:
                return 2
        if getattr(args, "band_select", None):
            band_select = _parse_widths(args.band_select, "--band-select")
            if band_select is None:
                return 2
            if len(band_select) < 2:
                print("--band-select: need at least two widths to select "
                      "among", file=sys.stderr)
                return 2
        for flag, widths in (
            ("--band", [args.band] if want_band else []),
            ("--band-sweep", band_sweep or []),
            ("--band-select", band_select or []),
        ):
            try:
                for b in widths:
                    validate_band(b, cfg.momentum.n_bins)
            except ValueError as e:
                print(f"{flag}: invalid widths — {e} (stay-zones must not "
                      "overlap)", file=sys.stderr)
                return 2
    if getattr(args, "vol_target", None) is not None and args.vol_target <= 0:
        print(f"--vol-target {args.vol_target:g}: the annualized vol "
              "target must be positive (percent, e.g. 12)", file=sys.stderr)
        return 2
    rep = run_monthly(
        prices,
        lookback=cfg.momentum.lookback,
        skip=cfg.momentum.skip,
        n_bins=cfg.momentum.n_bins,
        mode=cfg.momentum.mode,
        backend=cfg.backend,
        strategy=strategy,
        device=dev,
        **sector_kw,
        **panels,
    )
    from csmom_tpu_torch.panel.pack import is_packed

    src = ("packed panel" if is_packed(cfg.universe.data_dir)
           else "all readable caches included — the reference's own loader "
                "drops dialect-B files")
    print(f"Universe: {prices.n_assets} tickers x {prices.n_times} dates "
          f"({prices.tickers[0]}..{prices.tickers[-1]}; {src})")
    print(f"Mean monthly spread: {rep.mean_spread:.6f}")
    print(f"Annualized Sharpe:   {rep.ann_sharpe:.4f}")
    print(f"t-stat (NW):         {rep.tstat_nw:.3f}")
    print(f"t-stat (iid):        {rep.tstat:.3f}")
    plot_overlays = {}  # extra cum-growth lines (banded / vol-managed)
    spread_t = _tensor(rep.spread, dev)

    if getattr(args, "tc_bps", None) is not None:
        from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe
        from csmom_tpu_torch.backtest.monthly import net_of_costs_arrays

        # one unit-cost netting prices every level (the cost is linear in
        # the half-spread): the requested net level and the break-even
        valid = np.isfinite(rep.spread)
        vj = _tensor(valid, dev)
        spread0 = torch.nan_to_num(spread_t)
        net1, _, _ = net_of_costs_arrays(
            _tensor(rep.labels, dev), _tensor(rep.decile_counts, dev), spread0,
            vj, half_spread=1.0, n_bins=cfg.momentum.n_bins,
        )
        cost1 = spread0 - net1                 # per-month unit turnover cost
        hs = args.tc_bps / 1e4
        net = spread0 - hs * cost1
        net_mean = masked_mean(net, vj)
        net_sharpe = sharpe(net, vj, freq_per_year=12)
        net_t = nw_t_stat(net, vj)
        print(f"net of {args.tc_bps:g} bps half-spread turnover costs: "
              f"mean {float(net_mean):+.6f}, Sharpe {float(net_sharpe):.4f}, "
              f"NW t {float(net_t):+.3f}")
        cost1 = _host(cost1)
        mean_turn = float(cost1[valid].mean()) if valid.any() else float("nan")
        if mean_turn > 0:
            be = float(rep.mean_spread) / mean_turn * 1e4
            print(f"break-even half-spread: {be:+.1f} bps "
                  f"(mean monthly turnover {mean_turn:.3f})")

    if want_band or band_sweep is not None or band_select is not None:
        # the banded surfaces reuse the plain run's labels, whatever made
        # them (momentum, a strategy, sector ranks, either backend)
        from csmom_tpu_torch.backtest.banded import banded_from_labels
        from csmom_tpu_torch.signals.momentum import monthly_returns

        v, m = prices.tensors(device=dev)
        mret, mret_valid = monthly_returns(v, m)
        lab = _tensor(rep.labels, dev)

    if want_band:
        bres = banded_from_labels(lab, mret, mret_valid,
                                  n_bins=cfg.momentum.n_bins, band=args.band)
        plot_overlays[f"band {args.band}"] = _host(bres.spread)
        bt = _host(bres.turnover)
        bv = _host(bres.spread_valid)
        pvalid = np.isfinite(rep.spread)
        if getattr(args, "tc_bps", None) is not None:
            # the --tc-bps block's cost1 is the plain unit-turnover series
            plain_turn = mean_turn if mean_turn > 0 else None
        else:
            from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost

            w_plain = long_short_weights(lab, _tensor(rep.decile_counts, dev),
                                         cfg.momentum.n_bins, dtype=mret.dtype)
            pt = _host(turnover_cost(w_plain, half_spread=1.0))
            plain_turn = float(pt[pvalid].mean()) if pvalid.any() else None
        print(f"\nhysteresis band {args.band} (enter at extreme decile, "
              f"stay within {args.band}):")
        print(f"  gross mean {float(bres.mean_spread):+.6f}, Sharpe "
              f"{float(bres.ann_sharpe):.4f}, NW t {float(bres.tstat_nw):+.3f}")
        if getattr(args, "bootstrap", None):
            from csmom_tpu_torch import random
            from csmom_tpu_torch.analytics.bootstrap import block_bootstrap

            bbs = block_bootstrap(
                bres.spread, bres.spread_valid, random.PRNGKey(0),
                n_samples=args.bootstrap,
                block_len=getattr(args, "block_len", None) or 6,
                index_dtype=_index_dtype(bres.spread),
            )
            blo, bhi = _host(bbs.mean_ci)
            print(f"  95% CI mean: [{blo:.6f}, {bhi:.6f}] "
                  f"({args.bootstrap} block-bootstrap resamples)")
        b_turn = float(bt[bv].mean()) if bv.any() else float("nan")
        msg = f"  mean monthly turnover {b_turn:.3f}"
        if plain_turn is not None and plain_turn > 0:
            msg += (f" vs plain {plain_turn:.3f} "
                    f"({(1 - b_turn / plain_turn) * 100:.0f}% less trading)")
        print(msg)
        if getattr(args, "tc_bps", None) is not None:
            hs = args.tc_bps / 1e4
            bnet = np.where(bv, _host(bres.spread) - hs * bt, np.nan)
            bmean = float(np.nanmean(bnet)) if bv.any() else float("nan")
            print(f"  net of {args.tc_bps:g} bps: mean {bmean:+.6f}")
            if b_turn > 0:
                print(f"  break-even half-spread: "
                      f"{float(bres.mean_spread) / b_turn * 1e4:+.1f} bps")

    if band_sweep is not None:
        hs_bps = getattr(args, "tc_bps", None)
        hdr = f"{'band':>4}  {'gross/mo':>9}  {'turnover':>8}  {'b/e bps':>8}"
        if hs_bps is not None:
            hdr += f"  {'net@' + format(hs_bps, 'g') + 'bps':>12}"
        print("\nhysteresis band sweep (formation ranked once):")
        print(hdr)
        for b in band_sweep:
            r = banded_from_labels(lab, mret, mret_valid,
                                   n_bins=cfg.momentum.n_bins, band=b)
            rv = _host(r.spread_valid)
            turn = _host(r.turnover)
            mt = float(turn[rv].mean()) if rv.any() else float("nan")
            be = (float(r.mean_spread) / mt * 1e4 if mt > 0
                  else float("nan"))
            row = (f"{b:>4}  {float(r.mean_spread):>+9.6f}  {mt:>8.3f}  "
                   f"{be:>+8.1f}")
            if hs_bps is not None:
                net = np.where(rv, _host(r.spread) - hs_bps / 1e4 * turn, np.nan)
                nm = float(np.nanmean(net)) if rv.any() else float("nan")
                row += f"  {nm:>+12.6f}"
            print(row)

    if band_select is not None:
        from csmom_tpu_torch.backtest.walkforward import walk_forward_select

        hs = (getattr(args, "tc_bps", None) or 0.0) / 1e4
        series, valids = [], []
        for b in band_select:
            r = banded_from_labels(lab, mret, mret_valid,
                                   n_bins=cfg.momentum.n_bins, band=b)
            rv = _host(r.spread_valid)
            net = _host(r.spread) - hs * _host(r.turnover)
            series.append(np.where(rv, net, 0.0))
            valids.append(rv)
        wf = walk_forward_select(_tensor(np.stack(series), dev),
                                 _tensor(np.stack(valids), dev), min_months=24)
        basis = (f"net of {args.tc_bps:g} bps" if hs else "gross")
        ov = _host(wf.oos_valid)
        choice = _host(wf.choice)
        print(f"\nwalk-forward band selection over {band_select} "
              f"({basis}; expanding Sharpe, 24-month warmup):")
        print(f"  OOS months {int(ov.sum())}, mean "
              f"{float(wf.mean_spread):+.6f}, Sharpe "
              f"{float(wf.ann_sharpe):.4f}, NW t {float(wf.tstat_nw):+.3f}")
        picks = ", ".join(
            f"band {b} x{int(((choice == i) & ov).sum())}"
            for i, b in enumerate(band_select)
            if ((choice == i) & ov).any()
        )
        print(f"  selections: {picks or 'none'}")

    if getattr(args, "vol_target", None) is not None:
        from csmom_tpu_torch.analytics.stats import nw_t_stat, sharpe, vol_managed

        tgt = args.vol_target / 100.0
        _VM_WINDOW, _VM_CAP = 6, 2.0
        sp_arr = np.asarray(rep.spread, dtype=float)
        sv = np.isfinite(sp_arr)
        managed, mok, scale = vol_managed(
            _tensor(np.nan_to_num(sp_arr), dev), _tensor(sv, dev),
            window=_VM_WINDOW, target_ann_vol=tgt, max_leverage=_VM_CAP,
        )
        mok_np = _host(mok)
        if not mok_np.any():
            print(f"vol target {args.vol_target:g}%: no months with a full "
                  "6-month prior vol window — series too short",
                  file=sys.stderr)
        else:
            m_ = _host(managed)
            mmean = float(np.nanmean(m_[mok_np]))
            mz = _tensor(np.nan_to_num(m_), dev)
            msharpe = float(sharpe(mz, mok, freq_per_year=12))
            mt = float(nw_t_stat(mz, mok))
            raw_vol = float(np.std(sp_arr[sv], ddof=1) * np.sqrt(12))
            man_vol = float(np.std(m_[mok_np], ddof=1) * np.sqrt(12))
            sc = _host(scale)[mok_np]
            print(f"\nvol-managed overlay (BSC 2015, target "
                  f"{args.vol_target:g}% ann, {_VM_WINDOW}m trailing, "
                  f"{_VM_CAP:g}x cap):")
            print(f"  mean {mmean:+.6f}, Sharpe {msharpe:.4f}, NW t {mt:+.3f}"
                  f"  ({int(mok_np.sum())} of {int(sv.sum())} live months)")
            print(f"  realized ann vol: raw {raw_vol * 100:.1f}% -> managed "
                  f"{man_vol * 100:.1f}%; scale range "
                  f"[{sc.min():.2f}, {sc.max():.2f}]")
            plot_overlays[f"vol-managed {args.vol_target:g}%"] = np.where(
                mok_np, m_, np.nan
            )

    if getattr(args, "tables", False):
        from csmom_tpu_torch.analytics.tables import decile_table

        print("\nPer-decile performance (R1 = losers):")
        print(decile_table(rep.decile_means, rep.decile_counts,
                           rep.spread).round(4).to_string())

    if getattr(args, "tearsheet", False):
        import pandas as pd

        from csmom_tpu_torch.analytics.stats import rolling_sharpe
        from csmom_tpu_torch.analytics.tearsheet import (
            annual_returns,
            format_tearsheet,
            tearsheet,
        )

        valid = torch.isfinite(spread_t)
        spread0 = torch.nan_to_num(spread_t)
        print()
        print(format_tearsheet(
            tearsheet(spread0, valid, freq_per_year=12),
            label=f"monthly spread ({cfg.backend})",
        ))
        years = pd.DatetimeIndex(rep.times).year.values.astype(np.int32)
        uniq, ann, any_valid = annual_returns(spread0, valid, years)
        live = _host(any_valid)
        print("\nPer-year compounded spread:")
        for yy, aa in zip(_host(uniq)[live], _host(ann)[live]):
            print(f"  {int(yy)}  {aa * 100:+.2f}%")

        W = 36
        rs, rs_ok = rolling_sharpe(spread0, valid, W, freq_per_year=12)
        rs, rs_ok = _host(rs), _host(rs_ok)
        if rs_ok.any():  # one full-sample Sharpe hides regimes
            print(f"Rolling {W}m Sharpe: last {rs[rs_ok][-1]:+.2f}, "
                  f"min {np.nanmin(rs[rs_ok]):+.2f}, "
                  f"max {np.nanmax(rs[rs_ok]):+.2f} "
                  f"({int(rs_ok.sum())} windows)")

    if getattr(args, "bootstrap", None):
        from csmom_tpu_torch import random
        from csmom_tpu_torch.analytics.bootstrap import block_bootstrap

        bs = block_bootstrap(
            spread_t, torch.isfinite(spread_t), random.PRNGKey(0),
            n_samples=args.bootstrap, block_len=args.block_len or 6,
            index_dtype=_index_dtype(spread_t),
        )
        mlo, mhi = _host(bs.mean_ci)
        slo, shi = _host(bs.sharpe_ci)
        print(f"95% CI mean:         [{mlo:.6f}, {mhi:.6f}]  "
              f"({args.bootstrap} block-bootstrap resamples)")
        print(f"95% CI Sharpe:       [{slo:.4f}, {shi:.4f}]")

    if _can_plot("monthly_mom_cum.png"):
        from csmom_tpu_torch.analytics.plots import save_monthly_cum_plot

        out = save_monthly_cum_plot(
            prices.times, rep.spread, cfg.results_dir,
            overlays=plot_overlays or None,
        )
        log.info("wrote %s", out)
    return 0


def _grid_axes(args, cfg):
    Js = [int(j) for j in args.js.split(",")] if args.js else list(cfg.grid.Js)
    Ks = [int(k) for k in args.ks.split(",")] if args.ks else list(cfg.grid.Ks)
    return Js, Ks


def cmd_grid(args) -> int:
    """Full J x K grid in one call; prints the mean/Sharpe tables."""
    cfg = _load_cfg(args)
    Js, Ks = _grid_axes(args, cfg)
    # flag problems fail before the backtest runs
    tc_levels = None
    if getattr(args, "tc_sweep", None):
        if getattr(args, "tc_bps", None) is None:
            print("--tc-sweep needs --tc-bps (it re-prices the unit-cost "
                  "run that --tc-bps triggers); add e.g. --tc-bps 5",
                  file=sys.stderr)
            return 2
        try:
            tc_levels = [float(s) for s in args.tc_sweep.split(",") if s.strip()]
        except ValueError:
            print(f"--tc-sweep {args.tc_sweep!r}: levels must be plain "
                  "numbers in bps, e.g. --tc-sweep 0,5,25", file=sys.stderr)
            return 2
    n_shards = getattr(args, "shards", None) or 0
    mode = getattr(args, "mode", None) or cfg.momentum.mode
    if n_shards > 1 and mode == "hist":
        # sharded 'hist' would gather and rerun the whole-panel histogram
        # on every shard; its labels are rank's, so take the rank path
        print("--mode hist under --shards: labels are identical to rank; "
              "using the distributed rank path (rank_hist is the "
              "comm-efficient large-A form)", file=sys.stderr)
        mode = "rank"
    sharded = n_shards > 1 or mode == "rank_hist"
    if sharded:
        # the distributed grid over an asset-sharded mesh; rank_hist has
        # no single-device form
        n_shards = max(n_shards, 2)
        if args.device == "cuda":
            import torch

            n_dev = torch.cuda.device_count()
            if n_shards > n_dev:
                print(f"--shards {n_shards} exceeds the {n_dev} visible "
                      f"device(s); pass --device cpu to run {n_shards} "
                      "logical CPU shards", file=sys.stderr)
                return 2
    prices, _ = _price_panel(cfg, args.device)

    v, m = prices.tensors(device=args.device)
    impl = getattr(args, "impl", None) or "kernel"
    impl = _IMPL_ALIASES.get(impl, impl)

    if sharded:
        import torch

        from csmom_tpu_torch.parallel.collectives import sharded_jk_grid_backtest
        from csmom_tpu_torch.parallel.mesh import auto_mesh, pad_assets

        pv, mv = v, m
        if v.shape[0] % n_shards:  # dead lanes: masked-out NaN rows
            pv, mv, _ = pad_assets(v.cpu().numpy(), m.cpu().numpy(), n_shards)
            pv, mv = torch.as_tensor(pv, device=v.device), torch.as_tensor(mv, device=v.device)
        res = sharded_jk_grid_backtest(
            pv, mv, Js, Ks, auto_mesh(n_shards, device=args.device),
            skip=cfg.momentum.skip, n_bins=cfg.momentum.n_bins, mode=mode, impl=impl)
    else:
        from csmom_tpu_torch.backtest.grid import jk_grid_backtest

        res = jk_grid_backtest(v, m, Js, Ks, skip=cfg.momentum.skip,
                               n_bins=cfg.momentum.n_bins, mode=mode, impl=impl)

    from csmom_tpu_torch.analytics.tables import jk_grid_table

    if getattr(args, "tc_bps", None) is not None and mode == "rank_hist":
        print("--tc-bps" + ("/--tc-sweep" if tc_levels else "") + ": cost "
              "netting recomputes labels single-device and has no rank_hist "
              "form; rerun with --mode rank", file=sys.stderr)
    elif getattr(args, "tc_bps", None) is not None:
        import pandas as pd

        from csmom_tpu_torch.backtest.grid import (
            grid_break_even_bps,
            grid_net_from_unit,
            grid_net_of_costs,
        )

        # one book computation prices every cost level (linear model)
        unit = grid_net_of_costs(v, m, res, half_spread=1.0)
        net = grid_net_from_unit(res, unit, half_spread=args.tc_bps / 1e4)

        def _net_table(field):
            return pd.DataFrame(_host(field),
                                index=pd.Index(Js, name="J"),
                                columns=pd.Index(Ks, name="K"))

        print(f"\nNET of {args.tc_bps:g} bps half-spread turnover costs "
              "(exact overlapping-book turnover):")
        for name, field in (("mean monthly spread", net.mean_spread),
                            ("Newey-West t-stat (lag=K)", net.tstat_nw),
                            ("annualized Sharpe", net.ann_sharpe)):
            print(f"\n{name}, net:")
            print(_net_table(field).round(4).to_string())

        be, mean_turn = grid_break_even_bps(v, m, res, unit=unit)
        print("\nbreak-even half-spread (bps) — cost level where the cell's "
              "mean spread nets to zero:")
        print(_net_table(be).round(1).to_string())
        print("\nmean monthly turnover (L1 weight change):")
        print(_net_table(mean_turn).round(3).to_string())

        if tc_levels:
            print("\ncost sweep — net mean monthly spread by half-spread "
                  "level (all re-priced from the single unit-cost run):")
            rows = {}
            for bps in tc_levels:
                n_l = grid_net_from_unit(res, unit, half_spread=bps / 1e4)
                rows[f"{bps:g}bps"] = _host(n_l.mean_spread).ravel()
            idx = pd.MultiIndex.from_product([Js, Ks], names=["J", "K"])
            print(pd.DataFrame(rows, index=idx).round(4).to_string())

    mean_df, tstat_df, sharpe_df = jk_grid_table(res.spreads, res.spread_valid, Js, Ks)
    for name, df in (("mean monthly spread", mean_df),
                     ("Newey-West t-stat (lag=K)", tstat_df),
                     ("annualized Sharpe", sharpe_df)):
        print(f"\n{name}:")
        print(df.round(4).to_string())

    if getattr(args, "tearsheet", False):
        import pandas as pd

        _print_cell_tearsheets(
            res.spreads, res.spread_valid,
            pd.Index(Js, name="J"), pd.Index(Ks, name="K"),
        )

    n_boot = args.bootstrap if getattr(args, "bootstrap", None) is not None else 200
    if n_boot > 0:  # default inference: per-cell block-bootstrap mean CIs
        from csmom_tpu_torch.analytics.tables import jk_grid_ci_table

        lo_df, hi_df = jk_grid_ci_table(
            res.spreads, res.spread_valid, Js, Ks,
            n_samples=n_boot, block_len=getattr(args, "block_len", None) or 6,
            index_dtype=_index_dtype(res.spreads),
        )
        for name, df in (("95% CI mean spread, lower", lo_df),
                         ("95% CI mean spread, upper", hi_df)):
            print(f"\n{name} ({n_boot} block-bootstrap resamples):")
            print(df.round(4).to_string())
    return 0


def _build_turnover(args, cfg, prices, volume, device):
    """The turnover panel of the volume-conditioned commands (doublesort,
    horizons --by-volume): shares outstanding when fetched, the trailing
    average volume otherwise.  Returns ``(turn, turn_valid, turn_lb)``."""
    import numpy as np

    from csmom_tpu_torch.panel.fetch import get_shares_info
    from csmom_tpu_torch.signals.turnover import (
        shares_outstanding_vector,
        turnover_features,
    )

    fetch = getattr(args, "fetch_shares", False)
    shares_info = get_shares_info(list(prices.tickers)) if fetch else {}
    pv = np.asarray(prices.values)
    # each asset's last finite price, so the market_cap/price fallback
    # works for names that stopped trading
    finite = np.isfinite(pv)
    last_idx = pv.shape[1] - 1 - np.argmax(finite[:, ::-1], axis=1)
    last_price = np.where(
        finite.any(axis=1), pv[np.arange(pv.shape[0]), last_idx], np.nan
    )
    shares = np.asarray(shares_outstanding_vector(prices.tickers, shares_info,
                                                  last_price))
    known = np.isfinite(shares)
    if not known.any():
        # offline runs have no shares metadata; trailing share volume is
        # the standard proxy (it sorts like turnover within a cross-section)
        print("note: no shares-outstanding metadata (run with --fetch-shares "
              "for true turnover); sorting on trailing average volume instead")
        shares = np.ones(len(prices.tickers))
    elif not known.all():
        missing = [t for t, k in zip(prices.tickers, known) if not k]
        print(f"note: no shares metadata for {len(missing)} ticker(s) "
              f"({', '.join(missing[:5])}{'...' if len(missing) > 5 else ''}) — "
              "they are excluded from the volume terciles")
    turn_lb = (getattr(args, "turnover_lookback", None)
               or cfg.momentum.turnover_lookback)
    turn, turn_valid = turnover_features(
        _tensor(volume.values, device), _tensor(volume.mask, device), shares,
        lookback=turn_lb,
    )["turn_avg"]
    return turn, turn_valid, turn_lb


def cmd_doublesort(args) -> int:
    """Momentum spread within volume terciles (Lee-Swaminathan Table II)."""
    cfg = _load_cfg(args)
    prices, volume = _price_panel(cfg, args.device)

    from csmom_tpu_torch.analytics.tables import double_sort_table
    from csmom_tpu_torch.backtest.double_sort import volume_double_sort

    turn, turn_valid, turn_lb = _build_turnover(args, cfg, prices, volume,
                                                args.device)
    v, m = prices.tensors(device=args.device)
    res = volume_double_sort(
        v, m, turn, turn_valid,
        lookback=cfg.momentum.lookback, skip=cfg.momentum.skip,
        n_bins=cfg.momentum.n_bins, mode=cfg.momentum.mode,
    )
    print("Momentum spread by volume tercile "
          f"(J={cfg.momentum.lookback}, skip={cfg.momentum.skip}, "
          f"turnover avg over {turn_lb} months):")
    hs_bps = getattr(args, "tc_bps", None)
    print(double_sort_table(res, half_spread_bps=hs_bps).round(4).to_string())
    if hs_bps is not None:
        print(f"(net_mean at {hs_bps:g} bps half-spread; be_bps = the cost "
              "level that consumes each tercile's gross mean)")
    return 0


def cmd_sweep(args) -> int:
    """Walk-forward (J, K) selection: out-of-sample series from the grid.

    ``--tc-bps`` selects cells on net past performance and reports a net
    out-of-sample series.
    """
    import numpy as np

    cfg = _load_cfg(args)
    Js, Ks = _grid_axes(args, cfg)
    prices, _ = _price_panel(cfg, args.device)
    v, m = prices.tensors(device=args.device)

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select

    grid = jk_grid_backtest(v, m, Js, Ks, skip=cfg.momentum.skip,
                            n_bins=cfg.momentum.n_bins, mode=cfg.momentum.mode)
    label = "gross"
    if getattr(args, "tc_bps", None) is not None:
        from csmom_tpu_torch.backtest.grid import grid_net_of_costs

        grid = grid_net_of_costs(v, m, grid, half_spread=args.tc_bps / 1e4)
        label = f"net of {args.tc_bps:g} bps"
    wf = walk_forward_select(
        grid.spreads, grid.spread_valid,
        min_months=args.min_months or cfg.grid.walk_forward_min_months,
    )
    top, _n_live = _most_picked(wf.choice, Js, Ks)
    print(f"Selection basis:   {label}")
    print(f"OOS months:        {int(np.asarray(_host(wf.oos_valid)).sum())}")
    print(f"OOS mean spread:   {float(wf.mean_spread):.6f}")
    print(f"OOS ann. Sharpe:   {float(wf.ann_sharpe):.4f}")
    if top:
        print("Most-selected cells:", ", ".join(f"J={j}/K={k} x{n}" for (j, k), n in top))
    return 0


def cmd_horizons(args) -> int:
    """Event-time momentum profile by months since formation.

    The paper's long-horizon persistence-then-reversal view (LeSw00
    Tables VI-VIII)."""
    cfg = _load_cfg(args)
    prices, volume = _price_panel(cfg, args.device)

    v, m = prices.tensors(device=args.device)
    max_h = getattr(args, "max_h", None) or 36
    group = getattr(args, "group", None) or 6

    if getattr(args, "by_volume", False):
        from csmom_tpu_torch.analytics.tables import volume_horizon_table
        from csmom_tpu_torch.backtest.horizon import volume_horizon_profile

        turn, turn_valid, turn_lb = _build_turnover(args, cfg, prices, volume,
                                                    args.device)
        vhp = volume_horizon_profile(
            v, m, turn, turn_valid,
            lookback=cfg.momentum.lookback, skip=cfg.momentum.skip,
            n_bins=cfg.momentum.n_bins, mode=cfg.momentum.mode, max_h=max_h,
        )
        print(f"J={cfg.momentum.lookback} momentum life cycle by volume "
              f"tercile (turnover avg {turn_lb}m), horizons 1..{max_h}:")
        print(volume_horizon_table(vhp, group=group).round(4).to_string())
        if getattr(args, "out", None) and _can_plot("horizon_profile_by_volume.png"):
            from csmom_tpu_torch.analytics.plots import save_horizon_plot

            log.info("wrote %s", save_horizon_plot(
                vhp, cfg.results_dir, fname="horizon_profile_by_volume.png"
            ))
        return 0

    from csmom_tpu_torch.analytics.tables import horizon_table
    from csmom_tpu_torch.backtest.horizon import horizon_profile

    hp = horizon_profile(
        v, m, lookback=cfg.momentum.lookback, skip=cfg.momentum.skip,
        n_bins=cfg.momentum.n_bins, mode=cfg.momentum.mode, max_h=max_h,
    )
    print(f"J={cfg.momentum.lookback} event-time profile, horizons 1..{max_h}:")
    print(horizon_table(hp, group=group).round(4).to_string())
    if getattr(args, "out", None) and _can_plot("horizon_profile.png"):
        from csmom_tpu_torch.analytics.plots import save_horizon_plot

        log.info("wrote %s", save_horizon_plot(hp, cfg.results_dir))
    return 0


def cmd_fetch(args) -> int:
    """Populate or refresh the CSV cache for a universe.

    Cache-first: tickers with a readable cache are left alone unless
    --force-refresh; missing ones go to the network (needs yfinance; the
    error names the fix).  Writes versioned caches that always round-trip.
    """
    cfg = _load_cfg(args)

    from csmom_tpu_torch.panel.fetch import fetch_daily, fetch_intraday

    tickers = (
        list(_parse_tickers(args.tickers))
        if getattr(args, "tickers", None) else list(cfg.universe.tickers)
    )
    data_dir = cfg.universe.data_dir
    kind = getattr(args, "kind", None) or "both"
    force = bool(getattr(args, "force_refresh", False))
    rc = 0
    daily_df = None
    if kind in ("daily", "both"):
        df = daily_df = fetch_daily(
            tickers,
            start=getattr(args, "start", None) or cfg.universe.start,
            end=getattr(args, "end", None) or cfg.universe.end,
            data_dir=data_dir, force_refresh=force,
        )
        got = df.groupby("ticker").size() if len(df) else {}
        print(f"daily: {len(got)}/{len(tickers)} tickers cached in {data_dir}")
        if len(got) < len(tickers):  # a partial fetch is a failure: a
            rc = 1                   # scripted fetch && replicate must stop
    if kind in ("intraday", "both"):
        df = fetch_intraday(
            tickers,
            period=getattr(args, "period", None) or "7d",
            interval=getattr(args, "interval", None) or "1m",
            data_dir=data_dir, force_refresh=force,
        )
        got = df.groupby("ticker").size() if len(df) else {}
        print(f"intraday: {len(got)}/{len(tickers)} tickers cached in {data_dir}")
        if len(got) < len(tickers):
            rc = 1
    pack_to = getattr(args, "pack", None)
    if pack_to:
        # a pack missing tickers would silently shrink the universe, so a
        # partial fetch does not pack
        if rc != 0:
            print("not packing: fetch was incomplete (see above) — fix the "
                  "universe or drop the failing tickers, then re-run",
                  file=sys.stderr)
            return rc
        import json

        import numpy as np

        from csmom_tpu_torch.panel.pack import pack_csv_cache

        try:
            # reuse the frame fetch_daily already parsed
            out = pack_csv_cache(
                data_dir, tickers, pack_to, df=daily_df,
                dtype=np.float32 if getattr(args, "pack_f32", False) else None,
            )
        except ValueError as e:
            print(f"pack failed: {e}", file=sys.stderr)
            return 1
        with open(os.path.join(out, "meta.json")) as f:
            n_packed = len(json.load(f)["tickers"])
        print(f"packed {n_packed} tickers -> {out}")
        if n_packed < len(tickers):
            print(f"pack is INCOMPLETE: {len(tickers) - n_packed} of "
                  f"{len(tickers)} requested tickers had no readable daily "
                  "cache", file=sys.stderr)
            return 1
    return rc


def cmd_packinfo(args) -> int:
    """Describe a packed panel directory: fields, universe, calendar,
    coverage, on-disk size."""
    import numpy as np

    from csmom_tpu_torch.panel.pack import is_packed, load_packed

    path = args.pack_dir
    if not is_packed(path):
        print(f"{path}: not a packed panel (no meta.json)", file=sys.stderr)
        return 2
    b = load_packed(path)  # memmapped: the coverage scan pages through lazily
    panels = b.panels if hasattr(b, "panels") else {b.name: b}
    first = next(iter(panels.values()))
    a, t = first.shape
    size_mb = sum(
        os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
    ) / 1e6
    t0 = np.datetime_as_string(first.times[0], unit="D")
    t1 = np.datetime_as_string(first.times[-1], unit="D")
    print(f"packed panel: {path} ({size_mb:.1f} MB on disk)")
    print(f"universe: {a} tickers ({first.tickers[0]}..{first.tickers[-1]})")
    print(f"calendar: {t} dates, {t0} .. {t1}")
    for name, p in sorted(panels.items()):
        cov = float(np.asarray(p.mask).mean())
        print(f"field {name}: dtype {np.asarray(p.values).dtype}, "
              f"coverage {cov:.1%}")
    return 0


def _most_picked(choice, row_labels, col_labels, top_n=3):
    """A walk-forward choice path (flat cell index, -1 = none) -> the top-N
    most-selected ``((row, col), count)`` cells and the live month count."""
    from collections import Counter

    choice = _host(choice)
    live = choice >= 0
    picked = [
        (row_labels[c // len(col_labels)], col_labels[c % len(col_labels)])
        for c in choice[live]
    ]
    return Counter(picked).most_common(top_n), int(live.sum())


def _print_cell_tearsheets(spreads, spread_valid, index, columns):
    """Per-cell risk tables of a grid-shaped result (grid, residual): one
    batched tearsheet, one table per field."""
    import pandas as pd
    import torch

    from csmom_tpu_torch.analytics.tearsheet import tearsheet

    ts = tearsheet(torch.nan_to_num(spreads), spread_valid, freq_per_year=12)
    for name, field in (("max drawdown", ts.max_drawdown),
                        ("Calmar", ts.calmar),
                        ("hit rate", ts.hit_rate)):
        df = pd.DataFrame(_host(field), index=index, columns=columns)
        print(f"\n{name}:")
        print(df.round(4).to_string())


def cmd_residual(args) -> int:
    """Residual-momentum (lookback x est_window) hyperparameter grid in one
    call; prints mean / NW-t / Sharpe tables per cell."""
    import pandas as pd

    cfg = _load_cfg(args)
    Js = ([int(j) for j in args.js.split(",")] if getattr(args, "js", None)
          else [3, 6, 12])
    Ws = ([int(w) for w in args.est_windows.split(",")]
          if getattr(args, "est_windows", None) else [12, 24, 36])
    bad = [(j, w) for j in Js for w in Ws if w < max(j, 3)]
    if bad:
        print("structurally invalid cells (est_window < max(lookback, 3)) "
              "will be all-NaN: "
              + ", ".join(f"J={j}/W={w}" for j, w in bad), file=sys.stderr)
    prices, _ = _price_panel(cfg, args.device)
    v, m = prices.tensors(device=args.device)

    from csmom_tpu_torch.signals.residual import residual_sweep_backtest

    res = residual_sweep_backtest(v, m, Js, Ws, skip=cfg.momentum.skip,
                                  n_bins=cfg.momentum.n_bins,
                                  mode=cfg.momentum.mode)

    def table(field):
        return pd.DataFrame(_host(field), index=pd.Index(Js, name="J"),
                            columns=pd.Index(Ws, name="est_window"))

    for name, field in (("mean monthly spread", res.mean_spread),
                        ("Newey-West t-stat", res.tstat_nw),
                        ("annualized Sharpe", res.ann_sharpe)):
        print(f"\n{name}:")
        print(table(field).round(4).to_string())

    if getattr(args, "tearsheet", False):
        _print_cell_tearsheets(
            res.spreads, res.spread_valid,
            pd.Index(Js, name="J"), pd.Index(Ws, name="est_window"),
        )

    if getattr(args, "sweep", False):
        from csmom_tpu_torch.backtest.walkforward import walk_forward_select

        wf = walk_forward_select(
            res.spreads, res.spread_valid,
            min_months=getattr(args, "min_months", None)
            or cfg.grid.walk_forward_min_months,
        )
        print(f"\nwalk-forward (expanding in-sample Sharpe selection): "
              f"OOS mean {float(wf.mean_spread):+.6f}, "
              f"Sharpe {float(wf.ann_sharpe):.4f}, "
              f"NW t {float(wf.tstat_nw):+.3f}")
        top, n_live = _most_picked(wf.choice, Js, Ws)
        if top:
            (j, w), n = top[0]
            print(f"most-picked cell: J={j}, est_window={w} "
                  f"({n}/{n_live} months)")
    return 0


def cmd_strategies(args) -> int:
    """List registered strategy plugins (name, parameters, description)."""
    from csmom_tpu_torch.strategy import available_strategies

    def _param(f):
        if f.default is not dataclasses.MISSING:
            return f"{f.name}={f.default!r}"
        if f.default_factory is not dataclasses.MISSING:
            try:
                return f"{f.name}={f.default_factory()!r}"
            except Exception:
                return f.name  # a raising factory must not end the listing
        return f.name

    for name, cls in sorted(available_strategies().items()):
        params = ", ".join(_param(f) for f in dataclasses.fields(cls))
        lines = (cls.__doc__ or "").strip().splitlines()
        print(f"{name}({params})")
        if lines:
            print(f"    {lines[0]}")
    print(f"\nuse: {PROG} replicate --strategy NAME "
          "[--strategy-arg key=value ...]")
    return 0


def cmd_intraday(args) -> int:
    """Intraday pipeline + event backtest: features,
    score-model CV (--model ridge|online_ridge|elastic_net|lasso|mlp),
    per-minute fills;
    writes trades.csv + intraday_cum_pnl.png."""
    import numpy as np
    import torch

    cfg = _load_cfg(args)
    dev = args.device
    from csmom_tpu_torch.api import intraday_pipeline
    from csmom_tpu_torch.panel.ingest import load_daily, load_intraday
    from csmom_tpu_torch.panel.pack import is_packed

    if is_packed(cfg.universe.data_dir):
        print("error: --data-dir is a packed panel, which holds daily "
              "panels only; the intraday pipeline needs the minute CSV "
              "caches — point --data-dir at the CSV cache directory",
              file=sys.stderr)
        return 2
    tickers = list(cfg.universe.tickers)
    minute_df = load_intraday(cfg.universe.data_dir, tickers)
    daily_tickers = tickers
    if getattr(args, "parity", False):
        # the reference's EFFECTIVE daily universe: its loader loses
        # dialect-B caches, so those tickers take the default ADV/vol
        from csmom_tpu_torch.panel.ingest import reference_readable_daily

        daily_tickers = reference_readable_daily(cfg.universe.data_dir, tickers)
        lost = sorted(set(tickers) - set(daily_tickers))
        print(f"parity mode: daily risk-map universe drops {len(lost)} "
              f"caches the reference's loader cannot read (dialect-B "
              f"headers or fetch-cache marker lines): "
              f"{','.join(lost) or 'none'}")
    daily_df = load_daily(cfg.universe.data_dir, daily_tickers)
    lat = getattr(args, "latency_bars", None) or 0
    if lat < 0:
        print("--latency-bars must be >= 0", file=sys.stderr)
        return 2
    model = getattr(args, "model", None) or "ridge"
    if getattr(args, "alpha", None) is not None:
        alpha = args.alpha
    elif model in ("ridge", "online_ridge"):
        # one penalty scale for the leaky and the causal model
        alpha = cfg.intraday.alpha
    else:
        # the l1 and weight-decay scales differ: the API's per-model defaults
        alpha = None
    extra = {}
    if getattr(args, "l1_ratio", None) is not None:
        extra["l1_ratio"] = args.l1_ratio
    res, fit, compact, dense_score, dense_price, dense_valid = intraday_pipeline(
        minute_df, daily_df,
        window_minutes=cfg.intraday.window_minutes,
        n_splits=cfg.intraday.n_splits,
        alpha=alpha,
        size_shares=cfg.intraday.size_shares,
        threshold=cfg.intraday.threshold,
        cash0=cfg.intraday.cash0,
        model=model,
        latency_bars=lat,
        device=dev,
        **extra,
    )
    print(f"CV MSEs:     {[f'{m:.3g}' for m in _host(fit.cv_mse)]}")
    print(f"Trades:      {int(res.n_trades)} "
          f"({int(res.n_buys)} buys / {int(res.n_sells)} sells)")
    print(f"Total PnL:   ${float(res.total_pnl):,.2f}")

    from csmom_tpu_torch.backtest.event import cost_attribution

    bar = _host(res.bar_mask)
    tca = cost_attribution(res, dense_price,
                           size_shares=cfg.intraday.size_shares,
                           latency_bars=lat, valid=dense_valid)
    delay_leg = (f"delay drift ${float(tca.delay_cost):,.2f}, "
                 if lat else "")
    print(f"Costs:       ${float(tca.total_cost):,.2f} "
          f"({float(tca.cost_bps):.2f} bps of ${float(tca.gross_notional):,.0f}"
          f" traded; {delay_leg}spread ${float(tca.spread_cost):,.2f}, "
          f"impact ${float(tca.impact_cost):,.2f}) — "
          f"gross PnL ${float(tca.gross_pnl):,.2f}")

    if (getattr(args, "threshold_hi", None) is not None
            and getattr(args, "threshold_lo", None) is None):
        print("--threshold-hi sets the hysteresis ENTRY threshold and does "
              "nothing alone: add --threshold-lo (the exit threshold) to "
              "run the Schmitt-trigger engine", file=sys.stderr)
        return 2
    score0 = torch.nan_to_num(dense_score)
    if (getattr(args, "threshold_sweep", None)
            or getattr(args, "threshold_lo", None) is not None):
        from csmom_tpu_torch.api import daily_risk_maps

        adv, vol = daily_risk_maps(daily_df, compact.tickers)
        adv = _tensor(adv, dense_price.device, dense_price.dtype)
        vol = _tensor(vol, dense_price.device, dense_price.dtype)

    if getattr(args, "threshold_sweep", None):
        from csmom_tpu_torch.backtest.event import threshold_sweep

        ths = [float(t) for t in args.threshold_sweep.split(",")]
        pnl, ntr, bps = threshold_sweep(
            dense_price, dense_valid, score0, adv, vol, np.asarray(ths),
            size_shares=cfg.intraday.size_shares,
            cash0=cfg.intraday.cash0, latency_bars=lat,
        )
        print("\nthreshold sensitivity (one engine run a threshold):")
        print(f"{'threshold':>12} {'trades':>8} {'PnL':>16} {'cost bps':>9}")
        for t, p, n, b in zip(ths, _host(pnl), _host(ntr), _host(bps)):
            print(f"{t:>12g} {int(n):>8d} {float(p):>16,.2f} {float(b):>9.2f}")

    if getattr(args, "threshold_lo", None) is not None:
        from csmom_tpu_torch.backtest.event import hysteresis_event_backtest

        hi = (args.threshold_hi if getattr(args, "threshold_hi", None)
              is not None else cfg.intraday.threshold)
        if args.threshold_lo > hi:
            print(f"--threshold-lo {args.threshold_lo:g} must not exceed "
                  f"the entry threshold {hi:g} (--threshold-hi)",
                  file=sys.stderr)
            return 2
        hres = hysteresis_event_backtest(
            dense_price, dense_valid, score0, adv, vol,
            threshold_hi=hi, threshold_lo=args.threshold_lo,
            size_shares=cfg.intraday.size_shares, cash0=cfg.intraday.cash0,
            latency_bars=lat,
        )
        print(f"\nhysteresis trigger (enter |score|>{hi:g}, exit "
              f"|score|<{args.threshold_lo:g}, bounded 1-unit book):")
        print(f"  trades {int(hres.n_trades)} (plain engine: "
              f"{int(res.n_trades)}), total PnL ${float(hres.total_pnl):,.2f}")
        from csmom_tpu_torch.analytics.plots import save_trades_csv
        from csmom_tpu_torch.backtest.event import trades_dataframe

        h_trades = trades_dataframe(hres, compact.tickers, compact.times, score0,
                                    size_shares=cfg.intraday.size_shares)
        h_csv = save_trades_csv(h_trades, cfg.results_dir,
                                fname="trades_hysteresis.csv")
        print(f"  trade log: {h_csv} (flips are single ±2-unit rows)")

    if getattr(args, "tearsheet", False):
        import pandas as pd

        from csmom_tpu_torch.analytics.tearsheet import format_tearsheet, tearsheet

        # minute PnL -> calendar-day returns on starting capital: the
        # standard daily tearsheet for an intraday strategy
        days = pd.DatetimeIndex(np.asarray(compact.times)[bar]).normalize()
        daily = pd.Series(_host(res.pnl)[bar], index=days).groupby(level=0).sum()
        rets = _tensor((daily / cfg.intraday.cash0).to_numpy(copy=True), dev)
        print()
        print(format_tearsheet(
            tearsheet(rets, torch.isfinite(rets), freq_per_year=252),
            label=f"daily PnL / ${cfg.intraday.cash0:,.0f} start",
        ))

    from csmom_tpu_torch.analytics.plots import save_trades_csv
    from csmom_tpu_torch.backtest.event import trades_dataframe

    trades = trades_dataframe(res, compact.tickers, compact.times, dense_score,
                              size_shares=cfg.intraday.size_shares)
    out_csv = save_trades_csv(trades, cfg.results_dir)
    if _can_plot("intraday_cum_pnl.png"):
        from csmom_tpu_torch.analytics.plots import save_intraday_pnl_plot

        out_png = save_intraday_pnl_plot(
            np.asarray(compact.times)[bar], _host(res.pnl)[bar], cfg.results_dir)
        log.info("wrote %s and %s", out_csv, out_png)
    else:
        log.info("wrote %s", out_csv)
    return 0


def cmd_run(args) -> int:
    """Full demo: replicate + intraday, like the reference's ``main()``."""
    rc = cmd_replicate(args)
    if rc:
        return rc
    return cmd_intraday(args)


def cmd_warmup(args) -> int:
    """Warm the hot-path shape manifest: build and run every entry once.

    For each entry of the profiles' manifests (csmom_tpu_torch.compile
    .manifest) it builds or loads the kernel libraries the entry launches
    and calls the entry twice on seeded inputs at its shapes, then writes
    a per-shape report (build wall, first- and warm-call walls, peak
    device memory, whether any library had to be built or healed) under
    the build directory's warmup/ (build/csmom_tpu_torch/ unless
    CSMOM_JIT_CACHE names another).  A later process finds every kernel
    built; this one has the CUDA context, the libraries and the
    allocator warm.  With telemetry armed (CSMOM_TELEMETRY) it writes
    GPU_TELEMETRY_<run>.json to CSMOM_TELEMETRY_DIR or the working
    directory.
    """
    from csmom_tpu_torch.registry.core import canonical_profile

    profiles = [p.strip() for p in (args.profiles or "").split(",") if p.strip()]
    if not profiles:
        profiles = (["bench-cpu", "golden"] if args.device == "cpu"
                    else ["bench-gpu", "golden"])
    profiles = [canonical_profile(p) for p in profiles]  # bench-tpu: bench-gpu

    from csmom_tpu_torch.compile.manifest import PROFILES, build_manifest

    unknown = [p for p in profiles if p not in PROFILES]
    if unknown:
        print(f"unknown profile(s) {unknown}: choose from {list(PROFILES)}",
              file=sys.stderr)
        return 2

    if args.list:
        # enumerate and validate without running (a drifted manifest
        # raises TypeError here, naming the stale entry)
        for profile in profiles:
            for e in build_manifest(profile):
                e.validate()
                print(f"{profile:10s} {e.name:44s} {e.shape_summary()}")
        return 0

    from csmom_tpu_torch import obs
    from csmom_tpu_torch.compile.aot import warmup

    # spans arm only through the env contract (CSMOM_TELEMETRY)
    tel_col = obs.arm_policy("warmup-cli")
    with obs.span("warmup.cli", root=True, profiles=",".join(profiles)):
        report = warmup(
            profiles=tuple(profiles),
            subdir=args.cache_subdir,
            include_golden_event=not args.no_golden_event,
            device=args.device,
        )
    if tel_col is not None:
        from csmom_tpu_torch.obs import metrics as obs_metrics
        from csmom_tpu_torch.obs import timeline as obs_tl

        # armed only through the env contract, so the run id is the
        # operator's: an existing sidecar of that name is kept
        sidecar = obs_tl.finish_and_write(
            os.environ.get("CSMOM_TELEMETRY_DIR") or os.getcwd(),
            fallback_metrics=obs_metrics.snapshot(), overwrite=False)
        print(f"telemetry: {sidecar}")
    for r in report["entries"]:
        status = ("HIT" if r.get("cache_hit")
                  else ("ERROR " + r["error"] if "error" in r else "built"))
        print(f"{r.get('name', '?'):44s} build {r.get('build_s', 0.0):7.2f}s "
              f"first {r.get('first_call_s', 0.0):8.4f}s "
              f"warm {r.get('warm_call_s', 0.0):8.4f}s  {status}")
    print(f"\n{report['n_entries']} entries, {report['n_cache_hits']} served "
          f"from cache, {report['n_errors']} errors in {report['wall_s']}s "
          f"(platform {report['platform']})")
    print(f"cache: {report['cache_dir']}")
    print(f"inputs: {report['input_builders']}")
    print(f"golden event: {report['golden_event']}")
    # an input builder or the golden-event leg that failed is an error too
    failed = [k for k in ("input_builders", "golden_event")
              if report[k].startswith("failed")]
    if (report["n_errors"] or failed) and args.strict:
        return 1
    return 0


def _add_warmup(sub) -> None:
    sp = sub.add_parser("warmup", help=cmd_warmup.__doc__.splitlines()[0])
    sp.set_defaults(fn=cmd_warmup)
    sp.add_argument("--profiles",
                    help="comma-separated warmup profiles (bench-cpu, "
                         "bench-gpu, bench-mesh, golden, smoke, serve, "
                         "serve-smoke, stream, stream-smoke; bench-tpu means "
                         "bench-gpu; "
                         "default: bench-gpu,golden, or bench-cpu,golden "
                         "with --device cpu)")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to warm (default cuda; without a card it "
                         "exits 2: pass --device cpu to warm the plain "
                         "PyTorch versions of every kernel)")
    sp.add_argument("--cache-subdir", dest="cache_subdir", default="bench",
                    help="report namespace under the build directory's "
                         "warmup/ (default 'bench')")
    sp.add_argument("--list", action="store_true",
                    help="print the manifest (validated against the live "
                         "signatures) without running it")
    sp.add_argument("--no-golden-event", dest="no_golden_event",
                    action="store_true",
                    help="skip warming the event engines at the golden "
                         "event workload's shapes (skips the intraday "
                         "pipeline build)")
    sp.add_argument("--strict", action="store_true",
                    help="exit 1 when any manifest entry, the grid's input "
                         "build or the golden-event leg fails")


def _add_common(p, tickers: bool = True):
    p.add_argument("--config", help="TOML RunConfig file")
    p.add_argument("--data-dir", help="CSV cache directory, or a packed "
                                      "panel directory (fetch --pack)")
    if tickers:
        p.add_argument("--tickers",
                       help="comma-separated symbols (default: config "
                            "universe; with a packed --data-dir, default = "
                            "every packed ticker)")
    p.add_argument("--out", help="results directory")
    p.add_argument("--backend", choices=["torch", "tpu", "pandas"],
                   help="monthly engine: torch (the card engine; 'tpu' is "
                        "the reference's name for it) or pandas")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the panels and engines run (default cuda; "
                        "without a card a computing command exits 2 — pass "
                        "--device cpu to run the plain PyTorch versions of "
                        "the kernels on the CPU)")
    p.add_argument("--lookback", type=int, help="formation months J")
    p.add_argument("--skip", type=int, help="skip months")
    p.add_argument("--n-bins", dest="n_bins", type=int)
    p.add_argument("--mode", choices=["qcut", "rank", "hist", "rank_hist"],
                   help="decile assignment: qcut (pandas parity), rank "
                        "(fast ordinal, one batched sort), hist (sort-free "
                        "radix-histogram form of rank — same labels), "
                        "rank_hist (distributed radix-histogram rank — grid "
                        "command only, implies a sharded mesh)")


def _add_turnover_flags(sp):
    """Volume-sort flags of every turnover-conditioned command (doublesort,
    horizons --by-volume)."""
    sp.add_argument("--fetch-shares", dest="fetch_shares",
                    action="store_true",
                    help="fetch shares outstanding for true turnover "
                         "(network); default uses a volume proxy")
    sp.add_argument("--turnover-lookback", dest="turnover_lookback",
                    type=int,
                    help="months averaged into the volume sort (default: "
                         "config's 3; use J for the paper's "
                         "formation-period turnover)")


def build_parser() -> argparse.ArgumentParser:
    from csmom_tpu_torch import __version__

    p = argparse.ArgumentParser(prog=PROG, description=__doc__)
    p.add_argument("--version", action="version",
                   version=f"csmom_tpu_torch {__version__}")
    sub = p.add_subparsers(dest="command")

    for name, fn, extra in (
        ("run", cmd_run,
         ("bootstrap", "strategy", "tables", "tearsheet", "monthly_extras",
          "model")),
        ("replicate", cmd_replicate,
         ("bootstrap", "strategy", "tables", "tearsheet", "monthly_extras")),
        ("grid", cmd_grid, ("js", "ks", "bootstrap", "tearsheet", "tc")),
        ("doublesort", cmd_doublesort, ("doublesort",)),
        ("sweep", cmd_sweep, ("js", "ks", "min_months", "tc_bps")),
        ("intraday", cmd_intraday, ("model", "tearsheet")),
        ("horizons", cmd_horizons, ("horizons",)),
        ("fetch", cmd_fetch, ("fetch",)),
        ("residual", cmd_residual,
         ("js", "est_windows", "tearsheet", "wf", "min_months")),
        ("strategies", cmd_strategies, ()),
        ("pack-info", cmd_packinfo, ()),
    ):
        sp = sub.add_parser(name, help=(fn.__doc__ or "").splitlines()[0])
        sp.set_defaults(fn=fn)
        if name == "pack-info":
            sp.add_argument("pack_dir", help="packed panel directory")
            continue
        _add_common(sp, tickers=(name != "fetch"))  # fetch has its own
        if "js" in extra:
            sp.add_argument("--js", help="comma-separated J values")
        if "ks" in extra:
            sp.add_argument("--ks", help="comma-separated K values")
        if "est_windows" in extra:
            sp.add_argument("--est-windows", dest="est_windows",
                            help="comma-separated OLS estimation windows "
                                 "(months; default 12,24,36)")
        if "wf" in extra:
            sp.add_argument("--sweep", action="store_true",
                            help="also walk-forward the grid (out-of-sample "
                                 "expanding-window cell selection)")
        if name == "grid":
            sp.add_argument("--shards", type=int, metavar="N",
                            help="run the grid asset-sharded over an N-shard "
                                 "mesh: the visible cards, or N logical CPU "
                                 "shards with --device cpu (required form "
                                 "for --mode rank_hist)")
            sp.add_argument("--impl",
                            choices=["kernel", "plain", "matmul", "matmul_bf16",
                                     "pallas", "xla"],
                            help="cohort aggregation (default kernel: the "
                                 "CUDA kernel on the card; plain = the "
                                 "rolled PyTorch form; matmul = the cross-"
                                 "table form; matmul_bf16 = bf16 operands, "
                                 "f32 sums; the reference's pallas and xla "
                                 "mean kernel and plain)")
        if "min_months" in extra:
            sp.add_argument("--min-months", dest="min_months", type=int)
        if "bootstrap" in extra:
            sp.add_argument("--bootstrap", type=int, metavar="N",
                            help="print block-bootstrap 95%% CIs from N resamples")
            sp.add_argument("--block-len", dest="block_len", type=int)
        if "tables" in extra:
            sp.add_argument("--tables", action="store_true",
                            help="print the paper-style per-decile table")
        if "tearsheet" in extra:
            sp.add_argument("--tearsheet", action="store_true",
                            help="print the full risk tearsheet (drawdown, "
                                 "Calmar, Sortino, tails; per-cell tables "
                                 "for grid)")
        if ("monthly_extras" in extra or "tc" in extra
                or "tc_bps" in extra or "doublesort" in extra):
            if "tc_bps" in extra:  # the sweep: costs change the selection
                tc_help = ("select cells and report OOS performance NET of "
                           "linear transaction costs at this half-spread "
                           "(bps per unit weight turnover)")
            elif "doublesort" in extra:
                tc_help = ("also report each tercile's book turnover, the "
                           "spread net of linear costs at this half-spread, "
                           "and its break-even bps")
            else:
                tc_help = ("also report the spread net of linear "
                           "transaction costs at this half-spread (bps per "
                           "unit weight turnover)")
            sp.add_argument("--tc-bps", dest="tc_bps", type=float,
                            help=tc_help)
        if "tc" in extra:
            sp.add_argument("--tc-sweep", dest="tc_sweep", metavar="BPS,...",
                            help="with --tc-bps: also print net mean spreads "
                                 "at these half-spread levels, re-priced "
                                 "from the single unit-cost run (the cost "
                                 "model is linear in the half-spread)")
        if "monthly_extras" in extra:
            sp.add_argument("--sector-map", dest="sector_map",
                            help="ticker,sector CSV: rank within sectors "
                                 "(sector-neutral momentum; card engine)")
            sp.add_argument("--band", type=int, metavar="B",
                            help="also run the hysteresis-banded book: "
                                 "enter at the extreme decile, stay within "
                                 "B deciles of it (cuts turnover; with "
                                 "--tc-bps also reports the banded net and "
                                 "break-even)")
            sp.add_argument("--vol-target", dest="vol_target", type=float,
                            metavar="PCT",
                            help="also report the volatility-managed "
                                 "overlay (Barroso-Santa-Clara 2015): "
                                 "scale exposure to this annualized vol "
                                 "target (percent, e.g. 12) using the "
                                 "trailing 6-month realized vol")
            sp.add_argument("--band-sweep", dest="band_sweep",
                            metavar="B,B,...",
                            help="compare several hysteresis band widths in "
                                 "one table (gross mean / turnover / "
                                 "break-even; net at --tc-bps when given); "
                                 "formation runs once")
            sp.add_argument("--band-select", dest="band_select",
                            metavar="B,B,...",
                            help="walk-forward band selection: each month "
                                 "take the width with the best expanding-"
                                 "window Sharpe over prior months (net of "
                                 "--tc-bps when given) and realize its month")
        if "doublesort" in extra:
            _add_turnover_flags(sp)
        if "horizons" in extra:
            sp.add_argument("--max-h", dest="max_h", type=int,
                            help="longest horizon in months (default 36; "
                                 "the paper's five-year view is 60; the "
                                 "card kernel takes at most 128)")
            sp.add_argument("--group", type=int,
                            help="horizons per table row (default 6)")
            sp.add_argument("--by-volume", dest="by_volume",
                            action="store_true",
                            help="condition the profile on volume terciles "
                                 "(the paper's momentum life cycle, Table "
                                 "VIII: high-volume momentum reverses "
                                 "sooner)")
            _add_turnover_flags(sp)
        if "fetch" in extra:
            sp.add_argument("--tickers", help="comma-separated symbols "
                                              "(default: config universe)")
            sp.add_argument("--kind", choices=["daily", "intraday", "both"],
                            help="which bars to fetch (default both)")
            sp.add_argument("--start", help="daily range start (YYYY-MM-DD)")
            sp.add_argument("--end", help="daily range end")
            sp.add_argument("--period", help="intraday lookback (default 7d)")
            sp.add_argument("--interval", help="intraday bar size (default 1m)")
            sp.add_argument("--force-refresh", dest="force_refresh",
                            action="store_true",
                            help="re-download even when a cache file exists")
            sp.add_argument("--pack", metavar="DIR",
                            help="after fetch, convert the daily CSV cache "
                                 "to a packed binary panel directory "
                                 "(dense [A,T] .npy + manifest; loads "
                                 "memmapped via panel.load_packed)")
            sp.add_argument("--pack-f32", dest="pack_f32",
                            action="store_true",
                            help="store packed values as float32 (half the "
                                 "disk; the card's compute type)")
        if "model" in extra:
            sp.add_argument("--model",
                            choices=["ridge", "online_ridge", "elastic_net",
                                     "lasso", "mlp"],
                            help="score model (default: ridge, the reference's)")
            sp.add_argument("--alpha", type=float,
                            help="regularization strength (mlp: weight decay)")
            sp.add_argument("--l1-ratio", dest="l1_ratio", type=float,
                            help="elastic-net l1 ratio (default 0.5)")
            sp.add_argument("--threshold-sweep", dest="threshold_sweep",
                            help="comma-separated score thresholds: print "
                                 "PnL/trades/cost sensitivity")
            sp.add_argument("--threshold-hi", dest="threshold_hi",
                            type=float, metavar="S",
                            help="hysteresis entry threshold (default: the "
                                 "config threshold); used with "
                                 "--threshold-lo")
            sp.add_argument("--threshold-lo", dest="threshold_lo",
                            type=float, metavar="S",
                            help="ALSO run the Schmitt-trigger event "
                                 "engine: enter a bounded 1-unit position "
                                 "when |score| > entry, exit when |score| "
                                 "< this, hold in between (cuts intraday "
                                 "churn; reports trades/PnL vs the plain "
                                 "engine)")
            sp.add_argument("--latency-bars", dest="latency_bars",
                            type=int, metavar="N",
                            help="order-to-fill delay in bars (fills at the "
                                 "next valid row >= decision+N; the cost "
                                 "print adds the delay-drift leg of the "
                                 "implementation shortfall)")
            sp.add_argument("--parity", action="store_true",
                            help="reproduce the reference's EFFECTIVE daily "
                                 "risk-map universe (drop the dialect-B "
                                 "caches its loader loses) for its trade log")
        if "strategy" in extra:
            sp.add_argument("--strategy",
                            help="registered strategy plugin to rank instead of "
                                 "the built-in momentum path")
            sp.add_argument("--strategy-arg", dest="strategy_arg",
                            action="append", metavar="K=V",
                            help="strategy parameter, repeatable")

    from csmom_tpu_torch.cli.fleet import register as register_fleet
    from csmom_tpu_torch.cli.ledger import register as register_ledger
    from csmom_tpu_torch.cli.lint import register as register_lint
    from csmom_tpu_torch.cli.registry import register as register_registry
    from csmom_tpu_torch.cli.rehearse import register as register_rehearse
    from csmom_tpu_torch.cli.replay import register as register_replay
    from csmom_tpu_torch.cli.serve import register as register_serve
    from csmom_tpu_torch.cli.timeline import register as register_timeline
    from csmom_tpu_torch.cli.trace import register as register_trace

    _add_warmup(sub)
    register_fleet(sub)
    register_ledger(sub)
    register_lint(sub)
    register_registry(sub)
    register_rehearse(sub)
    register_replay(sub)
    register_serve(sub)
    register_timeline(sub)
    register_trace(sub)
    p.epilog = _subcommand_epilog(sub)
    p.formatter_class = argparse.RawDescriptionHelpFormatter
    return p


def _subcommand_epilog(sub) -> str:
    """The ``--help`` subcommand table, generated from the subparsers
    (names and their help lines), so it cannot drift from them."""
    helps = {a.dest: a.help or "" for a in
             getattr(sub, "_choices_actions", [])}
    names = sorted(sub.choices)
    lines = [f"subcommands ({len(names)}):"]
    for n in names:
        first = helps.get(n, "").split("\n")[0]
        lines.append(f"  {n:<12} {first}".rstrip())
    return "\n".join(lines)


# commands that compute nothing on a device (rehearse decides for
# itself: only its warm-up scenario touches one).  A command whose
# parser has no --device (``ledger show`` and ``ledger roadmap``) is
# never probed either
_DEVICE_FREE_COMMANDS = {"fetch", "strategies", "pack-info", "fleet",
                         "trace", "registry", "lint", "timeline", "rehearse"}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    if getattr(args, "mode", None) == "rank_hist" and args.command != "grid":
        print("--mode rank_hist is distributed-only: use "
              f"`{PROG} grid --shards N --mode rank_hist`", file=sys.stderr)
        return 2
    if (args.command not in _DEVICE_FREE_COMMANDS
            and getattr(args, "device", None) == "cuda"
            and not getattr(args, "list", False)
            and not getattr(args, "stub", False)
            and getattr(args, "engine", None) != "stub"):
        import torch

        if not torch.cuda.is_available():
            print("error: no CUDA device is available; pass --device cpu to "
                  "run on the CPU (the plain PyTorch versions of every "
                  "kernel)", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
