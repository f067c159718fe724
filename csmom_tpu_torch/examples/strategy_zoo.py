"""Strategy zoo: every registered signal over one panel, one comparison table.

Demonstrates the Strategy plugin boundary (the engines never change as the
signal does) and the batched tearsheet: each strategy's monthly spread
series gets the full risk summary, printed as one table.

Run:  python -m csmom_tpu_torch.examples.strategy_zoo [--data-dir DIR]
      [--device cuda|cpu]
"""

import argparse

from csmom_tpu_torch.compile.workloads import REFERENCE_DATA


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default=REFERENCE_DATA)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-bins", type=int, default=10)
    args = ap.parse_args(argv)

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    import torch

    from csmom_tpu_torch.analytics import tearsheet
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.config import DEFAULT_TICKERS
    from csmom_tpu_torch.strategy import make_strategy, strategy_backtest

    # parity universe: the reference's 20 names minus AAPL
    tickers = [t for t in DEFAULT_TICKERS if t != "AAPL"]
    panel, volume = monthly_price_panel(args.data_dir, tickers, device=dev)
    v, m = panel.tensors(device=dev, dtype=torch.float64)
    vol_v, vol_m = volume.tensors(device=dev, dtype=torch.float64)

    zoo = [
        ("momentum J=12",        make_strategy("momentum"), {}),
        ("momentum J=6",         make_strategy("momentum", lookback=6), {}),
        # Novy-Marx (2012) intermediate momentum: months t-12..t-7 only
        ("intermediate mom",     make_strategy("intermediate_momentum"), {}),
        ("reversal 1m",          make_strategy("reversal"), {}),
        ("residual mom",         make_strategy("residual_momentum"), {}),
        # Blitz-van Vliet (2007) volatility effect at the paper's 36m
        # window (min_obs=12 starts it before a strict 36-of-36 would)
        ("low vol (36m)",        make_strategy("low_volatility"), {}),
        # rank mode: the 52w-high score has an atom at exactly 1.0, and
        # qcut's duplicate-edge dropping would empty the top bin on
        # strong-market months
        ("52w high (rank)",      make_strategy("high_52w"),
         {"mode": "rank"}),
        ("volume-z mom",         make_strategy("volume_z_momentum"),
         {"volumes": vol_v, "volumes_mask": vol_m}),
    ]

    rows = []
    for label, strat, panels in zoo:
        mode = panels.pop("mode", "qcut")
        res = strategy_backtest(v, m, strat, n_bins=args.n_bins, mode=mode,
                                **panels)
        ts = tearsheet(torch.nan_to_num(res.spread), res.spread_valid,
                       freq_per_year=12)
        rows.append((
            label,
            float(res.mean_spread),
            float(res.ann_sharpe),
            float(res.tstat_nw),
            float(ts.max_drawdown),
            float(ts.hit_rate),
            int(ts.n_periods),
        ))

    hdr = f"{'strategy':<16} {'mean/mo':>9} {'sharpe':>7} {'t(NW)':>6} " \
          f"{'maxDD':>7} {'hit':>6} {'months':>7}"
    print(hdr)
    print("-" * len(hdr))
    for label, mu, sh, t, dd, hit, n in rows:
        print(f"{label:<16} {mu:>+9.4f} {sh:>7.3f} {t:>+6.2f} "
              f"{dd:>6.1%} {hit:>6.1%} {n:>7d}")


if __name__ == "__main__":
    main()
