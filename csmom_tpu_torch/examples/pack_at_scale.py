"""At-scale data path: packed binary panels feeding the grid.

The reference re-parses per-ticker CSV text on every run, fine at 20
tickers and hopeless at the north star.  This demo is the scale
workflow:

1. build a universe once (synthetic here; ``fetch --pack`` for real
   caches) and write it as a packed directory: dense ``[A, T]`` ``.npy``
   per field plus a manifest (:mod:`csmom_tpu_torch.panel.pack`);
2. re-open it memory-mapped (an O(metadata) open; pages are read on the
   way to the card) and run the 16-cell J x K grid from it;
3. assert the packed path is bit-identical to the in-memory panel: the
   pack is a cache, never a different answer.

Run:  python -m csmom_tpu_torch.examples.pack_at_scale [--assets N]
      [--years Y] [--device cuda|cpu] [--keep DIR]
"""

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--assets", type=int, default=256)
    ap.add_argument("--years", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keep", metavar="DIR",
                    help="write the pack here and keep it (default: tmp)")
    args = ap.parse_args(argv)

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    import dataclasses

    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.pack import load_packed, save_packed
    from csmom_tpu_torch.panel.panel import PanelBundle
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.utils.profiling import fetch

    T = args.years * 252
    t0 = time.perf_counter()
    px = synthetic_daily_panel(args.assets, T, seed=11, listing_gaps=True)
    # pack the full daily bundle the monthly pipeline expects (adj_close +
    # volume) so the kept pack really is a drop-in --data-dir
    panel = dataclasses.replace(px, name="adj_close")
    vol_rng = np.random.default_rng(12)
    vol_vals = np.where(
        panel.mask, np.exp(vol_rng.normal(13.0, 1.0, size=panel.shape)), np.nan
    )
    volume = dataclasses.replace(panel, values=vol_vals, name="volume")
    bundle = PanelBundle(
        panels={"adj_close": panel, "volume": volume},
        tickers=panel.tickers, times=panel.times,
    )
    synth_s = time.perf_counter() - t0

    tmp_root = None if args.keep else tempfile.mkdtemp(prefix="csmom_pack_demo_")
    pack_dir = args.keep or os.path.join(tmp_root, "pack")
    t0 = time.perf_counter()
    save_packed(bundle, pack_dir)
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    packed = load_packed(pack_dir)["adj_close"]  # memmap: no bulk read yet
    open_s = time.perf_counter() - t0

    Js = np.array([3, 6, 9, 12])
    Ks = np.array([3, 6, 9, 12])

    def run(p):
        seg, ends = month_end_segments(p.times)
        v, m = p.tensors(device=dev, dtype=torch.float32)
        pm, mm = month_end_aggregate(v, m, seg, len(ends))
        res = jk_grid_backtest(pm, mm, Js, Ks, skip=1, mode="rank",
                               impl="matmul")
        fetch(res.mean_spread)
        return res

    t0 = time.perf_counter()
    res_packed = run(packed)                # pages are read here
    grid_s = time.perf_counter() - t0
    res_mem = run(panel)

    np.testing.assert_array_equal(
        fetch(res_packed.mean_spread), fetch(res_mem.mean_spread)
    )
    np.testing.assert_array_equal(
        fetch(res_packed.spread_valid), fetch(res_mem.spread_valid)
    )

    a, t = panel.shape
    size_mb = sum(
        os.path.getsize(os.path.join(pack_dir, f))
        for f in os.listdir(pack_dir)
    ) / 1e6
    print(f"{a} assets x {t} days: pack {size_mb:.1f} MB "
          f"(synth {synth_s:.2f}s, write {write_s:.2f}s, "
          f"open {open_s * 1e3:.1f}ms, grid-from-pack {grid_s:.2f}s)")
    print("packed == in-memory: bit-identical 16-cell grid "
          f"(best cell mean {float(np.nanmax(fetch(res_packed.mean_spread))) * 100:+.3f}%/mo)")
    if args.keep:
        print(f"pack kept at {pack_dir} — any monthly subcommand accepts it "
              "as --data-dir")
    else:
        import shutil

        shutil.rmtree(tmp_root, ignore_errors=True)


if __name__ == "__main__":
    main()
