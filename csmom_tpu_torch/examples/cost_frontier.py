"""Cost frontier: hysteresis band width x transaction-cost level, one table.

The practical question every momentum desk asks ("at what cost level does
the strategy die, and how much does trading less buy back?") answered
with the framework's two cost tools composed:

- the hysteresis band (``backtest/banded.py``) cuts turnover by holding
  names inside a stay-zone instead of re-forming the book monthly;
- linear cost netting (``net = gross - hs * turnover``) is exact per band,
  so every (band, cost-level) cell prices from ONE banded run per band;
  formation itself ranks exactly once for the whole table
  (``banded_from_labels`` reuses the plain run's labels).

Run:  python -m csmom_tpu_torch.examples.cost_frontier [--data-dir DIR]
      [--device cuda|cpu]
"""

import argparse

from csmom_tpu_torch.compile.workloads import REFERENCE_DATA


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default=REFERENCE_DATA)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bands", default="0,1,2")
    ap.add_argument("--tc-bps", default="0,5,10,25,50")
    args = ap.parse_args(argv)

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.backtest import monthly_spread_backtest
    from csmom_tpu_torch.backtest.banded import banded_from_labels
    from csmom_tpu_torch.config import DEFAULT_TICKERS
    from csmom_tpu_torch.signals.momentum import monthly_returns
    from csmom_tpu_torch.utils.profiling import fetch

    bands = [int(b) for b in args.bands.split(",")]
    levels = [float(x) for x in args.tc_bps.split(",")]

    panel, _ = monthly_price_panel(args.data_dir, list(DEFAULT_TICKERS),
                                   device=dev)
    v, m = panel.tensors(device=dev)
    plain = monthly_spread_backtest(v, m, lookback=12, skip=1)
    mret, mret_valid = monthly_returns(v, m)

    print(f"universe: {panel.n_assets} tickers x {panel.n_times} months; "
          "net mean spread per (band, half-spread bps):")
    hdr = f"{'band':>4}  {'turnover':>8}  " + "  ".join(
        f"{f'{x:g}bps':>10}" for x in levels
    )
    print(hdr)
    rows = {}
    for b in bands:
        r = banded_from_labels(plain.labels, mret, mret_valid,
                               n_bins=10, band=b)
        rv = fetch(r.spread_valid)
        turn = fetch(r.turnover)
        spread = fetch(r.spread)
        mt = float(turn[rv].mean())
        nets = [float(np.nanmean(np.where(rv, spread - hs / 1e4 * turn,
                                          np.nan)))
                for hs in levels]
        rows[b] = (mt, nets)
        print(f"{b:>4}  {mt:>8.3f}  " + "  ".join(
            f"{n:>+10.6f}" for n in nets))

    # golden sanity: turnover must fall with the band, and at a high-enough
    # cost level the wider band must dominate (its whole economic point)
    mts = [rows[b][0] for b in bands]
    assert all(a > b for a, b in zip(mts, mts[1:])), "turnover not falling"
    worst = [rows[b][1][-1] for b in bands]
    assert worst[-1] > worst[0], (
        "widest band should win at the highest cost level"
    )
    print("frontier sanity checks passed")
    return 0


if __name__ == "__main__":
    main()
