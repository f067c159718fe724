"""A dry run of meshes over several processes: the sharded engines across
a process boundary.

Counterpart of the reference's ``benchmarks/multihost_dryrun.py``.  Two
processes joined by :func:`~csmom_tpu_torch.parallel.mesh.distributed_init`
each drive 4 logical shards of one device (``--device``: ``cuda:0`` by
default, which puts both on one card, over gloo; ``cpu`` rehearses the
run on the CPU; ``cuda:0,cuda:1;cuda:2,cuda:3`` gives each process two
cards of its own, over nccl) of an 8-shard mesh,
and run on the seeded 96 x 72 f64 panel (seed 11, rows ``:A//8`` x months
``:M//5`` masked):

- the asset-sharded monthly engine (qcut, J = 12, skip 1) and banded
  engine (5 bins, band 1);
- the time-sharded online ridge at 4 assets x 64 rows x 3 features
  (alpha 0.8, burn-in 8).

Process 0 also runs the single-device engines and holds the sharded
results to the reference's tolerances: spreads within rtol 1e-12 (NaN in
the same places) and the monthly mean within 1e-12; the banded
Newey-West t within 1e-11; the ridge scores within rtol 1e-9, atol 0.

Run ``python -m csmom_tpu_torch.parallel.multihost_dryrun [--device
cuda:0|cpu]``: it prints one JSON line (the reference's fields, with the
backend and each process's kernel launches) and exits 1 when a check
fails, 2 when the device asked for is a card and none is visible.  ``--save DIR`` writes each process's results to
``DIR/rank<r>.npz``; ``--panel FILE.npz`` (arrays ``prices`` and ``mask``)
adds a leg on that panel, the monthly (qcut, J = 12) and banded (band 1)
engines, saved as ``DIR/rank<r>_panel.npz`` with their K1 launches.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

__all__ = ["LOCAL_SHARDS", "N_PROC", "dryrun_panel", "launch", "main",
           "ridge_inputs", "summary", "worker"]

N_PROC = 2
LOCAL_SHARDS = 4
A, M = 96, 72     # divisible by the 8-shard mesh; months past the J = 12 warm-up
SEED = 11
RIDGE_SHAPE = (4, 64, 3)
RIDGE_ALPHA, RIDGE_BURN_IN = 0.8, 8
# the reference's limits between the sharded and single-device engines
SPREAD_RTOL = 1e-12
MEAN_ATOL = 1e-12
NW_ATOL = 1e-11
RIDGE_RTOL = 1e-9


def dryrun_panel():
    """The seeded ``(prices f64[A, M], mask bool[A, M])`` of the dry run,
    the same on every process."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.003, 0.07, size=(A, M)), axis=1))
    prices[: A // 8, : M // 5] = np.nan
    return prices, np.isfinite(prices)


def ridge_inputs():
    """The online ridge's seeded ``(features f64[A, R, F], y f64[A, R],
    valid bool[A, R])``."""
    import numpy as np

    a, r, f = RIDGE_SHAPE
    rng = np.random.default_rng(SEED + 1)
    feats = rng.normal(size=(a, r, f))
    y = rng.normal(scale=1e-2, size=(a, r))
    valid = rng.random((a, r)) > 0.1
    return feats, y, valid


def _close(a, b, rtol: float) -> bool:
    """NaN in the same places, the rest within ``rtol`` (atol 0)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    live = np.isfinite(b)
    return bool(np.array_equal(np.isfinite(a), live)
                and np.allclose(a[live], b[live], rtol=rtol, atol=0.0))


def _host(x):
    return x.detach().cpu().numpy()


def worker(rank: int, port: int, device: str, save: str | None,
           panel: str | None) -> dict:
    """One process of the run: join, run the sharded engines on this
    process's shards, check (process 0) and save; returns its record."""
    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.mesh.rules import P
    from csmom_tpu_torch.mesh.shard import gather, shard_args
    from csmom_tpu_torch.models.online_ridge import online_ridge_scores
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.parallel.collectives import (
        sharded_banded_backtest,
        sharded_monthly_spread_backtest,
    )
    from csmom_tpu_torch.parallel.mesh import (
        Mesh,
        backend,
        distributed_init,
        distributed_shutdown,
        global_devices,
        mesh_topology,
    )
    from csmom_tpu_torch.parallel.online_ridge import time_sharded_online_ridge_scores
    from csmom_tpu_torch.utils.deadline import mono_now_s

    torch.set_num_threads(2)
    mine = _process_devices(device, rank)
    dev = mine[0]
    distributed_init(f"127.0.0.1:{port}", N_PROC, rank,
                     devices=[mine[i % len(mine)] for i in range(LOCAL_SHARDS)])
    try:
        devices, procs = global_devices()
        mesh_a = Mesh(devices, ("assets",), processes=procs)
        mesh_t = Mesh(devices, ("time",), processes=procs)
        rec = {"rank": rank, "backend": backend(),
               "topology": {"assets": mesh_topology(mesh_a)["assets"],
                            "time": mesh_topology(mesh_t)["time"]},
               "local_shards": list(mesh_a.local_shards)}

        def sync():
            for d in mine:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        prices, mask = dryrun_panel()
        spec = P("assets", None)
        pv, mv = shard_args(mesh_a, (spec, spec), prices, mask)
        # each process holds its blocks only, and gathering them gives
        # every process the whole panel
        rec["gathered_equal"] = bool(
            sorted(pv.blocks) == list(mesh_a.local_shards)
            and np.array_equal(gather(pv, mesh_a), prices, equal_nan=True)
            and np.array_equal(gather(mv, mesh_a), mask))
        kernels.reset_launches()
        t0 = mono_now_s()
        spread, valid, mean, sh, ts = sharded_monthly_spread_backtest(pv, mv, mesh_a)
        sync()
        monthly_wall = mono_now_s() - t0
        rec["monthly_launches"] = kernels.decile_partial_sums.launches
        t0 = mono_now_s()
        b_spread, b_valid, b_mean, b_sh, b_tnw = sharded_banded_backtest(
            pv, mv, mesh_a, lookback=12, skip=1, n_bins=5, band=1)
        sync()
        banded_wall = mono_now_s() - t0

        feats, y, yv = ridge_inputs()
        tf, ty, tv = (torch.as_tensor(x, device=dev) for x in (feats, y, yv))
        t0 = mono_now_s()
        fit = time_sharded_online_ridge_scores(tf, ty, tv, mesh_t,
                                               alpha=RIDGE_ALPHA,
                                               burn_in=RIDGE_BURN_IN)
        sync()
        ridge_wall = mono_now_s() - t0
        rec.update(monthly_wall_s=round(monthly_wall, 3),
                   banded_wall_s=round(banded_wall, 3),
                   online_ridge_wall_s=round(ridge_wall, 3))
        if save:
            np.savez(os.path.join(save, f"rank{rank}.npz"),
                     spread=_host(spread), valid=_host(valid),
                     stats=np.array([float(mean), float(sh), float(ts)]),
                     b_spread=_host(b_spread), b_valid=_host(b_valid),
                     b_stats=np.array([float(b_mean), float(b_sh), float(b_tnw)]),
                     scores=_host(fit.scores), cv_mse=_host(fit.cv_mse),
                     coef=_host(fit.coef))

        if panel:
            with np.load(panel) as z:
                big_p, big_m = z["prices"], z["mask"]
            bp, bm = shard_args(mesh_a, (spec, spec), big_p, big_m)
            kernels.reset_launches()
            t0 = mono_now_s()
            ns = sharded_monthly_spread_backtest(bp, bm, mesh_a, lookback=12,
                                                 skip=1, mode="qcut")
            sync()
            rec["panel_monthly_launches"] = kernels.decile_partial_sums.launches
            rec["panel_monthly_wall_s"] = round(mono_now_s() - t0, 3)
            kernels.reset_launches()
            t0 = mono_now_s()
            nb = sharded_banded_backtest(bp, bm, mesh_a, lookback=12, skip=1,
                                         mode="qcut", band=1)
            sync()
            rec["panel_banded_launches"] = kernels.decile_partial_sums.launches
            rec["panel_banded_wall_s"] = round(mono_now_s() - t0, 3)
            rec["panel_shape"] = list(big_p.shape)
            if save:
                np.savez(os.path.join(save, f"rank{rank}_panel.npz"),
                         spread=_host(ns[0]), valid=_host(ns[1]),
                         b_spread=_host(nb[0]), b_valid=_host(nb[1]))

        if rank == 0:
            pt, mt = (torch.as_tensor(x, device=dev) for x in (prices, mask))
            single = monthly_spread_backtest(pt, mt)
            sb = banded_monthly_backtest(pt, mt, lookback=12, skip=1, n_bins=5,
                                         band=1)
            walk = online_ridge_scores(tf, ty, tv, alpha=RIDGE_ALPHA,
                                       burn_in=RIDGE_BURN_IN)
            rec["monthly_equal"] = (
                _close(_host(spread), _host(single.spread), SPREAD_RTOL)
                and abs(float(mean) - float(single.mean_spread)) < MEAN_ATOL)
            rec["banded_equal"] = (
                _close(_host(b_spread), _host(sb.spread), SPREAD_RTOL)
                and abs(float(b_tnw) - float(sb.tstat_nw)) < NW_ATOL)
            rec["online_ridge_equal"] = _close(_host(fit.scores),
                                               _host(walk.scores), RIDGE_RTOL)
        return rec
    finally:
        distributed_shutdown()


def _process_devices(device: str, rank: int) -> list:
    """Process ``rank``'s devices in a ``--device`` spec: one device
    for every process, or one comma list a process, the lists separated
    by ``;`` (``cuda:0,cuda:1;cuda:2,cuda:3`` gives each process two cards
    of its own; its 4 shards take them in turn)."""
    import torch

    groups = device.split(";")
    if len(groups) not in (1, N_PROC):
        raise ValueError(f"--device {device!r}: one device list, or {N_PROC} "
                         "separated by ';'")
    return [torch.device(d) for d in groups[rank % len(groups)].split(",")]


def _no_card(device: str) -> str | None:
    """Why ``device`` cannot run here (a card asked for and none is
    visible), or ``None``."""
    import torch

    cards = [d for r in range(N_PROC) for d in _process_devices(device, r)
             if d.type == "cuda"]
    if cards and not torch.cuda.is_available():
        return (f"no CUDA device is visible for device {device!r}; pass "
                "device='cpu' (--device cpu) to run on the CPU")
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(device: str = "cuda:0", save: str | None = None,
           panel: str | None = None, timeout: float = 900.0,
           port: int = 0) -> list:
    """Start the ``N_PROC`` processes on ``device`` and wait for them
    (at most ``timeout`` seconds, then every one is killed); returns their
    records in rank order.  Raises when ``device`` is a card and none is
    visible (naming ``device="cpu"``), and when a process fails, naming
    its output."""
    missing = _no_card(device)
    if missing:
        raise RuntimeError(missing)
    port = port or _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")]))}
    argv = ["--port", str(port), "--device", device]
    if save:
        argv += ["--save", save]
    if panel:
        argv += ["--panel", panel]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "csmom_tpu_torch.parallel.multihost_dryrun",
         "--worker", str(r), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(N_PROC)]
    outs = [""] * N_PROC

    def drain(r):
        outs[r] = procs[r].stdout.read()

    readers = [threading.Thread(target=drain, args=(r,), daemon=True)
               for r in range(N_PROC)]
    for t in readers:
        t.start()
    try:
        end = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"the dry run's processes ran over {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=30)
    records = []
    for r, p in enumerate(procs):
        lines = [ln for ln in (outs[r] or "").splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dry-run process {r} failed (exit {p.returncode}):\n"
                               + (outs[r] or "")[-3000:])
        records.append(json.loads(lines[-1]))
    return records


def summary(records: list, device: str) -> dict:
    """The reference's one-line record of a run, with the backend and
    each process's kernel launches."""
    r0 = records[0]
    ok = bool(r0["monthly_equal"] and r0["banded_equal"] and r0["online_ridge_equal"]
              and all(rec["gathered_equal"] for rec in records))
    a, r, f = RIDGE_SHAPE
    return {
        "metric": "multihost_sharded_equals_single",
        "value": float(ok),
        "unit": "bool",
        "vs_baseline": 0.0,
        "extra": {
            "topology": f"{N_PROC} OS processes x {LOCAL_SHARDS} logical shards "
                        f"of {device}, torch.distributed ({r0['backend']})",
            "workload": f"{A} assets x {M} months f64, masked lanes; monthly "
                        "(qcut rank, all_gather + psum), banded (band recursion "
                        f"+ one psum), J=12 skip=1; online ridge {a}x{r}x{f} "
                        "time-sharded across both processes",
            "backend": r0["backend"],
            "topology_axes": r0["topology"],
            "monthly_equal": r0["monthly_equal"],
            "banded_equal": r0["banded_equal"],
            "online_ridge_equal": r0["online_ridge_equal"],
            "gathered_equal": [rec["gathered_equal"] for rec in records],
            "monthly_wall_s": r0["monthly_wall_s"],
            "banded_wall_s": r0["banded_wall_s"],
            "online_ridge_wall_s": r0["online_ridge_wall_s"],
            "launches": {k: [rec.get(k) for rec in records]
                         for k in ("monthly_launches", "panel_monthly_launches",
                                   "panel_banded_launches")},
            "note": "walls are one-shot runs, recorded for provenance only; "
                    "the payload is the cross-process equality",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m csmom_tpu_torch.parallel.multihost_dryrun",
        description="the sharded engines over two processes, checked "
                    "against the single-device engines")
    ap.add_argument("--device", default="cuda:0",
                    help="each process's device, shared by its 4 logical "
                         "shards (default cuda:0: both processes on one "
                         "card; cpu rehearses the run on the CPU), or one "
                         "comma list of devices a process, separated by ';'")
    ap.add_argument("--port", type=int, default=0,
                    help="the rendezvous port on 127.0.0.1 (default: a free one)")
    ap.add_argument("--save", metavar="DIR",
                    help="write each process's results to DIR/rank<r>.npz")
    ap.add_argument("--panel", metavar="FILE",
                    help="an .npz of prices and mask: add the monthly and "
                         "banded engines on it (saved as rank<r>_panel.npz)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before every process is killed")
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.port, args.device, args.save,
                                args.panel)))
        return 0
    missing = _no_card(args.device)
    if missing:
        print(f"error: {missing}", file=sys.stderr)
        return 2
    line = summary(launch(args.device, args.save, args.panel, args.timeout,
                          args.port), args.device)
    print(json.dumps(line))
    return 0 if line["value"] == 1.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
