"""In-sample vs walk-forward scoring: how much of the demo PnL is leak?

The reference's intraday demo trains on the first 70% of minute rows and
then scores the ENTIRE history, its own training rows included, and
books +$765k on its shipped data.  This example runs the same pipeline
twice:

1. ``model='ridge'``: the reference's scaffold, replicated (leaky by
   design, kept for parity), and
2. ``model='online_ridge'``: the strictly causal walk-forward scan (every
   score out-of-sample by construction,
   ``csmom_tpu_torch/models/online_ridge.py``),

and prints both PnLs side by side.  On the reference data the sign flip
is the finding: the in-sample profit does not survive causal scoring.

Run:  python -m csmom_tpu_torch.examples.causal_scoring [--data-dir DIR]
      [--device cuda|cpu]

The pipeline computes in f64 (``intraday_pipeline``'s default).
"""

import argparse

from csmom_tpu_torch.compile.workloads import REFERENCE_DATA


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default=REFERENCE_DATA)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from csmom_tpu_torch.api import intraday_pipeline
    from csmom_tpu_torch.config import DEFAULT_TICKERS
    from csmom_tpu_torch.panel.ingest import load_daily, load_intraday

    minute_df = load_intraday(args.data_dir, list(DEFAULT_TICKERS))
    daily_df = load_daily(
        args.data_dir, [t for t in DEFAULT_TICKERS if t != "AAPL"]
    )
    if len(minute_df) == 0:
        raise SystemExit(f"no intraday caches under {args.data_dir}")

    rows = []
    for model in ("ridge", "online_ridge"):
        res, fit, *_ = intraday_pipeline(minute_df, daily_df, model=model,
                                         device=dev)
        rows.append((
            model,
            int(res.n_trades),
            float(res.total_pnl),
            [float(x) for x in fit.cv_mse.cpu().numpy()],
        ))

    mse_label = {"ridge": "fold MSEs (in-sample folds)",
                 "online_ridge": "prequential MSEs (all OOS)"}
    print(f"{'model':<14} {'trades':>8} {'total PnL':>16}   quality")
    for model, n, pnl, mses in rows:
        ms = ", ".join(f"{m:.2e}" for m in mses)
        print(f"{model:<14} {n:>8} {pnl:>16,.2f}   {mse_label[model]}: [{ms}]")

    leak = rows[0][2] - rows[1][2]
    print(
        f"\nscoring the training span (the reference's scaffold) is worth "
        f"${leak:,.0f} of the in-sample PnL on this universe — the causal "
        f"number is the one a live strategy would have seen"
    )


if __name__ == "__main__":
    main()
