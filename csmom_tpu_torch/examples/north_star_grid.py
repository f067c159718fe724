"""North-star scale: the full J x K grid on a synthetic 3000 x 60yr panel.

One call evaluates all 16 Jegadeesh-Titman cells (overlapping 1/K cohort
holding) over a 3,000-stock, 60-year monthly panel with staggered
listings; the same result then walk-forwards the grid for an
out-of-sample selection path.  The default is scaled down so the demo
finishes in seconds (pass --assets 3000 --years 60 for the real thing).

Run:  python -m csmom_tpu_torch.examples.north_star_grid [--assets N]
      [--years Y] [--impl kernel|plain|matmul|matmul_bf16]
      [--device cuda|cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--assets", type=int, default=512)
    ap.add_argument("--years", type=int, default=15)
    ap.add_argument("--impl", default="matmul",
                    choices=["kernel", "plain", "matmul", "matmul_bf16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    import time

    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import to_tensors
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.utils.profiling import fetch

    T = args.years * 252
    panel = synthetic_daily_panel(args.assets, T, seed=7, listing_gaps=True)
    seg, ends = month_end_segments(panel.times)
    v, m = to_tensors(panel.values, panel.mask, device=dev, dtype=torch.float32)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))

    Js = np.array([3, 6, 9, 12])
    Ks = np.array([3, 6, 9, 12])

    # one callable: the timed rep fetches only the [nJ, nK] means; the
    # first call's full result feeds the report and the walk-forward
    def g(p, q):
        return jk_grid_backtest(p, q, Js, Ks, skip=1, mode="rank", impl=args.impl)

    res = g(pm, mm)
    fetch(res.mean_spread)  # warm + materialize
    t0 = time.perf_counter()
    fetch(g(pm, mm).mean_spread)
    wall = time.perf_counter() - t0
    print(f"{args.assets} assets x {args.years} yr "
          f"({len(ends)} months), impl={args.impl}: "
          f"16-cell grid in {wall:.3f}s")
    print("\nmean spread (%/mo):")
    ms = fetch(res.mean_spread) * 100
    print("      " + "  ".join(f"K={k:<4d}" for k in Ks))
    for i, j in enumerate(Js):
        print(f"J={j:<3d} " + "  ".join(f"{ms[i, k]:+.3f}" for k in range(len(Ks))))

    from csmom_tpu_torch.backtest.walkforward import walk_forward_select

    wf = walk_forward_select(res.spreads, res.spread_valid)
    picked = fetch(wf.choice)
    live = picked >= 0
    if live.any():
        uniq, cnt = np.unique(picked[live], return_counts=True)
        top = uniq[np.argmax(cnt)]
        print(f"\nwalk-forward: Sharpe {float(wf.ann_sharpe):.3f} "
              f"(NW t {float(wf.tstat_nw):+.2f}); most-picked cell "
              f"J={Js[top // len(Ks)]}, K={Ks[top % len(Ks)]} "
              f"({cnt.max()}/{live.sum()} months)")


if __name__ == "__main__":
    main()
