#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (csmom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

``--out DIR`` keeps phase 12's ``GPU_SERVE_POOL_*.json``, phase 13's
``GPU_SERVE_FABRIC_*.json``, phase 14's ``GPU_FLEET_*.json``, phase
15's ``GPU_TRACE_*.json`` and ``GPU_REPLAY_*.json`` and phase 18's
``GPU_SERVE_MESH_*.json`` artifacts there (by default phases 12-15's go
to a temporary directory, removed at the end, and phase 18's to
``chiprun_out/``).  Each phase's wall is printed
on a ``[smoke] phase N`` line as it ends, and all of them on one line
after phase 23.
Needs one CUDA card and nvcc; exits non-zero without them, and whenever
any phase fails (nothing is caught).  Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off;
2. build: the three CUDA kernels from csmom_tpu_torch/csrc, one nvcc
   each, in parallel;
3. kernels: K1, K2 and K3 against their plain PyTorch versions at the
   test shapes and at the north-star shape, in f64 and f32, each launched
   twice to show bit-for-bit repeatable results; K3 (rank labels) also at
   every plan's width, on special values, a stride-0 lead, a transposed
   panel and rows past its widest plan (the plain sort, counted), then
   timed at the grid's ranking shape ``[4, 3000, 696]`` and the serve
   shape ``[128, 480]`` in f32 and f64 with L2 flushed (CUDA events, no
   profiler trace) beside its bound, its plain version and the
   ``torch.sort`` path it replaced: a ``{"k3": ...}`` line at the end;
4. golden: the monthly engine in f64 reproduces the pinned synthetic
   fingerprints (the JAX package's tests/test_synthetic_golden.py);
5. north star: the month-end panel (3,000 stocks x 15,120 days) built and
   aggregated on the card, the monthly engine (qcut, J=12) and the
   16-cell J x K grid (rank and qcut) in f32 through the kernels — launch
   counts read around this run — checked against the plain versions and
   timed with CUDA events;
6. research paths (BASELINE configs 3 and 5): (a) on the golden panel in
   f64, the sector-neutral engine, its net of costs, the grid's netting,
   break-evens, walk-forward selection, block-bootstrap CIs and the
   threefry draws reproduce the JAX package's pinned ``RESEARCH``
   fingerprints; (b) at the north star in f32, ``hist`` labels equal
   ``rank`` labels, the matmul cohort sums equal K2's counts, the
   sector-neutral engine (11 sectors) equals its plain run, and each new
   path is timed with CUDA events — launch counts read around the run;
7. data-in: (a) the committed 8-ticker CSV universe through the native
   parser and ``monthly_price_panel`` on the card reproduces the JAX
   package's CSV golden in f64 through K1; (b) the north-star daily panel
   written as a two-field f32 pack, read back memmapped and aggregated on
   the card equals ``north_star_month_panel()`` bit for bit, and
   ``run_monthly`` (K1) and ``run_grid`` (K2) from it equal phase 5's
   results bit for bit; banded rebalancing (band 0 = the plain engine's
   spread and turnover charge) and tearsheets of the 16 cells; launch
   counts read around this run, and each step timed; (c) 256 tickers x
   3,780 days of CSVs in both dialects -> native ingest -> pack, with the
   pack equal to its frames and equal month-end panels from either source;
8. cli: the port's CLI (``csmom_tpu_torch.cli.main``) in-process on
   phase 7(b)'s pack with ``--device cuda``: ``replicate`` with every
   reporting flag (its statistics equal phase 5's monthly engine, K1 once),
   five ``--strategy`` runs (momentum bit-equal to the monthly engine; K1
   once each), ``grid`` and ``sweep`` (equal to phase 5's rank grid; K2
   once each), K2 held against its plain version at the horizon shapes
   and timed there, then ``horizons`` at 36 and 60 months and
   ``--by-volume`` (K2 once each, tables equal to the engines' own),
   ``doublesort``, ``residual`` (3 x 3 cells, K1 once a cell),
   ``pack-info``, ``strategies``, and ``replicate`` on the committed CSV
   universe in f64 (the CSV golden); each command's host wall on a
   ``[cli]`` line, launch counts read around each command;
9. intraday: (a) on the JAX package's golden minute frame in f64, the
   ridge and online-ridge pipelines reproduce its ``EVENT`` and ``ONLINE``
   fingerprints and the rest of the leg (elastic net, lasso, the MLP,
   hysteresis, latency 3 with cost attribution, limit orders, a 5-point
   sweep) its pinned ``INTRADAY`` outputs; (b) three days of minute bars
   for 500 names (up to 585k rows): the pipeline's stages in f64 on the card
   equal the same calls on the CPU, f32 decisions differ from f64 only
   near the threshold, the accounting identities hold, every latency path
   repeats bit for bit, each stage is timed and one f32 pipeline traced;
   (c) online ridge at the reference's 20 x ~2,730 shape timed in f64,
   and on its first ``F32_WALK_ROWS`` rows in f32, its launches counted; (d) the CLI's ``intraday`` (each model and
   every flag) and ``run`` on a CSV cache, numbers and trade logs equal to
   the API's; launch counts read around the phase (``run`` launches K1
   once, nothing else launches a kernel);
10. a ``{"kernels": [...]}`` line: per kernel its launches, error, times
   and bound at the main-path shape (measured before phase 9, whose long
   traces leave later profiler traces losing records; printed after it).  ``ms`` is one call's time by CUDA
   events (the wrapper's host work before the launch included);
   ``device_ms`` the kernels' own durations in a profiler trace of the
   same call, ``kernels_per_call`` how many kernels it launched,
   ``wrapper_ms`` the difference and ``bound_share`` = bound / device;
   ``research_launches``, ``data_in_launches``, ``cli_launches``,
   ``intraday_launches``, ``serve_launches``, ``pool_launches``,
   ``fabric_launches``, ``fleet_launches``, ``trace_launches`` and
   ``replay_launches`` the counts of phases 6, 7, 8, 9, 11, 12, 13, 14
   and 15, ``warmup_launches`` and ``examples_launches`` phase 16's,
   ``mesh_launches`` phase 17's, ``serve_mesh_launches`` phase 18 (a)'s,
   ``multihost_launches`` phase 19 (b)'s (the two processes' north-star
   legs, summed), ``rehearse_launches`` phase 20 (a)'s (the healed
   warm-up process's entries), ``ledger_launches`` phase 21 (a)'s (its
   two service runs), ``bench_launches`` phase 22 (a)'s (the measuring
   child's), ``donation_launches`` phase 23's
   (12's, 13's and 14's in the worker processes; 16's warm-ups in theirs; 13's over its
   serving windows, equal to the workers' ``backtest`` batches; 14's
   each worker process's whole life, warm-up included, spares and forked
   workers too; 15's traced runs in this process and the workers, equal
   to their ``backtest`` batches, and its replay windows, warm-ups
   excluded), and K1's
   ``serve_device_ms`` and ``serve_bound_ms`` at the serve shape
   ``serve_shape``;
11. serve (run before phase 9): (a) each of the five endpoints'
   ``TorchEngine`` on the card against ``TorchEngine(device="cpu")`` at
   all six shapes of profile ``serve`` (B in {1, 4, 8} x A in {32, 128} x
   60 months, padded rows and assets) in f64 and f32, K1 on the folded
   ``[A, B*60]`` against its plain version, ``backtest`` launching K1 once
   a micro-batch, one request alone against the same request in a batch
   of 8, and each endpoint's micro-batch timed and traced; (b)
   ``SignalService`` on the card, telemetry disarmed, driven by
   ``run_loadgen`` with the schedules ``2x40``, ``bursty`` and ``5x200``
   (seed 0; the last long enough for p99 to be a percentile): closed
   books, no kernel built in the window, no worker crash, a valid
   artifact, every served
   result equal to the engine scoring that request alone, its latency,
   batch and cache figures and the allocator's growth; launch counts read
   around the runs; (c) the CLI's ``serve`` and ``loadgen``; (d) K1 timed
   at the serve shape ``[128, 480]`` and at ``[128, 60]`` (a B = 1 batch,
   each batch shard's shape in phase 18), before the service runs;
12. pool (run after phase 11 and before phase 9): three torch workers on
   the one card behind the router in this process, profile ``serve``:
   (a) each ready with platform ``gpu``, no kernel built in its window
   and this process's cache version, its spawn → ready wall and the
   card's memory before and after the spawns; a worker expecting another
   cache version exits ``RC_VERSION_SKEW``; (b) every endpoint at all six
   shapes through the router, each result equal to this process's
   engine scoring the request alone, and the workers' K1 launches (read
   through their ``stats`` replies) equal to their ``backtest`` batches;
   (c) the JAX package's ``SERVE_POOL_r11.json`` cell, its 26 s tail at
   15 req/s cut to 6 s (``2x30,2x60,6x15``, seed 11, hedging at 0.35, worker ``w0`` SIGKILLed 2 s in and its warm
   replacement awaited): books closed per class, no infra rejection, one
   kill and one restart, three workers ready at the end, no kernel built
   in the window, every served result equal to the engine alone, a valid
   ``GPU_SERVE_POOL_*.json``; (d) the ceiling: one
   saturating backtest schedule through one worker and through three;
   then ``serve --workers 2`` and ``loadgen --pool --kill-worker-after 1``
   in subprocesses; the kernels line's ``pool_launches`` the workers'
   counts;
13. fabric (run after phase 12 and before phase 9): two router-replica
   processes over tcp in front of three torch workers, the fabric client
   in this process: (a) the workers ready with platform ``gpu``, no
   kernel built and this process's cache version, each replica's
   ``stats`` saying it never loaded torch, each tier's spawn -> ready
   wall and the card's memory; (b) every endpoint at all six shapes
   through client -> replica -> worker, each result equal to this
   process's engine alone, K1 launches equal to ``backtest`` batches;
   (c) the JAX package's ``SERVE_FABRIC_r20.json`` cell (its bursty
   schedule, seed 0, five endpoints, class mix, reuse and version bump,
   500 ms deadlines) with router ``r0`` SIGKILLed 1.0 s and worker
   ``w0`` 1.6 s in, both replacements awaited: books closed per class
   and per replica, no infra rejection, one kill and one restart in each
   tier, no kernel built, every served result equal to the engine alone,
   a valid ``GPU_SERVE_FABRIC_*.json``; (d) phase 12's ceiling offer
   (its rate, reused) behind two routers through one worker and through
   three, with each router process's and this process's CPU and the
   submission wall; (e) ``loadgen --fabric --kill-router-after 1`` in a
   subprocess;
14. fleet (run after phase 13 and before phase 9): (a) the prefork parent
   (torch and the serve stack imported, the kernel libraries read into
   the page cache, CUDA never initialized, one native thread), a worker
   spawned by subprocess and one forked by the parent, each one's
   spawn -> bind -> warm -> ready walls and card memory, both answering
   the six serve shapes equal to this process's engine; (b) phase 13's
   r20 cell with the fleet observatory armed: a ``GPU_FLEET_*.json``
   valid, every stream book reason-closed, both victims' streams
   severed, no sequence gap, the demand by class equal to the client's
   books, the kill-window capacity loss; (c) the same cell with a hot
   spare, the autoscaler and the prefork path: the spare promoted into
   w0's slot, no spare id in a serving book, the backfill ready, no
   infra rejection, every served result equal to the engine alone, no
   kernel built, every decision reasoned, quotas within [8, 64], each
   fork at one native thread; (d) three workers (floor 3, ceiling 4)
   under phase 12's ceiling offer for 6 s, then idle: a reasoned
   ``scale_up``, the new worker ready with no kernel built, closed
   books, and whether the drain brought the fleet back to the floor;
   (e) ``loadgen --fabric --fleet --spares 1 --autoscale --prefork`` and
   ``fleet <run>`` in subprocesses;
15. trace and replay (run after phase 14 and before phase 9): each
   serving cell with the trace book armed once its tier is ready, its
   ``GPU_TRACE_*.json`` valid with books that close against the run's
   request books (complete == served, partial == rejected + expired) and
   stage sums within epsilon: (a) ``SignalService`` on the card under
   ``bursty``, K1 launches equal to its ``backtest`` batches; (b) the
   JAX package's ``TRACE_r17.json`` pool cell (two torch workers, the
   bursty schedule, ``w0`` SIGKILLed 2 s in): the stitched route and
   transport stages, orphan halves equal to the router's worker
   connection failures, each naming ``w0``; (c) its ``TRACE_r19.json``
   fabric cell (phase 13's r20 with every router replica traced): every
   trace reason-closed through the router and worker kills, orphan
   halves equal to the client's router connection failures, each naming
   ``r0``, the surviving replicas' books closed, torch never loaded
   there, and the armed p50/p99 against phase 13's disarmed run; the
   workers' K1 launches equal to their ``backtest`` batches; (d) the
   replay of ``REPLAY_r12.json``'s configuration with builtin chaos on
   the card: its tick, panel and version books equal to the file's, no
   drift, no kernel built, the engine reconcile's largest difference;
   (e) a full session, 128 assets x 390 one-minute bars with the ring
   wrapping: closed books, no drift, no kernel built, ticks/s and
   staleness; neither replay window launches K1 or K2; (f) ``loadgen
   --trace`` in a subprocess, ``trace <run>`` on each landed artifact
   (two renderings, equal), ``replay --chaos builtin`` and ``registry
   list [--endpoints]`` in-process;
16. warm-start and examples (run last, after phase 9; no profiler trace):
   (a) cold: ``warmup --profiles bench-gpu,golden,serve,stream --strict``
   in a process of its own from a copy of the package in a temporary
   directory, whose build directory starts empty: exit 0, every kernel
   library (K1, K2, K3) built, 0 errors, every entry's allocator peak and first- and
   warm-call walls logged; (b) warm: the same in the tree (phase 2 built
   the libraries): every entry a cache hit, 0 built, the report read back;
   (c) K1 and K2 against their plain versions on the warm-up's own inputs
   at a warmed shape (K1 at ``monthly.spread@20x60`` f64, K2 at
   ``grid.jk16.rank.kernel@3000x696`` f32), and the two warm-ups' launches
   (each record's own count); (d) ``examples.north_star_grid --assets 3000
   --years 60 --impl kernel`` (K2) and its default run, whose table equals
   the same script's with ``--device cpu``; (e) ``examples.pack_at_scale``
   (its own bit-identity assert) and the four ``--data-dir`` examples on a
   synthetic 20-ticker directory, each printout on the card equal to the
   ``--device cpu`` one (``replicate_reference`` stops at its golden mean
   on both: the data is not the reference's); launch counts read around
   (d)-(e); the kernels line gains ``warmup_launches`` and
   ``examples_launches``;
17. the multi-GPU compute layer (run after phase 16; no profiler trace),
   every mesh made of logical shards of ``cuda:0`` (one thread a shard,
   :mod:`csmom_tpu_torch.parallel`): (a) the sharded monthly engine (qcut,
   J=12, f32, the north star) at 1, 2, 4 and 8 asset shards; (b) the
   sharded 16-cell grid at ``impl="kernel"`` in rank and in qcut on
   ``(grid=1, assets=8)`` and ``(grid=2, assets=4)`` meshes, and
   ``rank_hist`` on 4 asset shards; (c) the sharded banded engine on 4
   and 8 shards and the sharded bootstrap on 4 shards; (d) the golden event inputs (f64)
   through the asset-sharded engine (market and limit) on 4 shards and
   the time-sharded event and hysteresis engines on ``(time=4)`` and
   ``(assets=2, time=2)`` meshes at latency 0 and 3, and the time-sharded
   online ridge in f64 on 4 shards; (e) ``warmup --profiles bench-mesh
   --strict`` in a process of its own.  Each is held against the
   single-device engine on the card (f32 validity and counts exact,
   spreads within ``SPREAD_ATOL``; the event engines' integer state
   exact, floats within the JAX package's own limits); K1 launches once
   per asset shard and K2 once per (grid, asset) shard pair; each item's
   synchronized walls by shard count on a ``[mesh]`` line (logical shards
   of one card, not speed across cards); the kernels line gains
   ``mesh_launches``; a shard stuck at a collective raises after
   ``MESH_BARRIER_TIMEOUT_S``;
18. the mesh serving engine (run after phase 15 and before phase 9; no
   profiler trace), every mesh logical shards of ``cuda:0``: (a)
   ``SERVE_MESH_r15.json``'s configuration (bursty, seed 0, 240 arrivals,
   the five endpoints, its class mix, reuse 0.35, one version bump,
   profile ``serve`` f32) on ``MeshTorchEngine`` over 8 shards: the warm
   report's 30 shapes and ``mesh`` block equal to that artifact's shard
   for shard, books closed per class and endpoint, 0 kernels built in the
   window, K1 launches exactly ``shards_for(B, 8)`` a ``backtest``
   batch, every served result within ``SERVE_F32`` of the single-device
   engine scoring it alone (bit-equality counted by endpoint), a
   ``GPU_SERVE_MESH_r15.json`` valid, the headline beside phase 11's
   single-device bursty; the same cell traced, every dispatched trace
   carrying ``mesh_devices`` 8 and its bucket's ``mesh_shards``; (b) the
   scaling probe, one ``backtest`` B = 8 dispatch at 1, 4 and 8 shards
   (in order on this thread, and a thread a shard), each endpoint's d8
   scorer against the single-device scorer on one batch (bit-equal flag,
   largest difference), K1 against its plain version at ``[128, 60]``
   and phase 11's K1 times at ``[128, 60]`` and ``[128, 480]``; (c) ``warmup --profiles serve-mesh
   --strict`` and ``loadgen --mesh --smoke``, processes of their own; (d)
   two ``torch-mesh`` workers pinned to 4 logical shards of ``cuda:0``
   each under a 5 s burst: slices and d4 in the ready reports, books
   closed across processes, ``rejected_infra`` 0, 0 built;
19. the lint sweep and meshes over two processes (run after phase 17; no
   profiler trace; its wall is printed and held within
   ``MULTIHOST_BUDGET_S``): (a) ``python -m csmom_tpu_torch.cli lint
   --project --format json`` in a process of its own exits 0 with no
   finding over more than 100 files, and ``-X importtime`` shows it
   imported no torch, no ``csmom_tpu`` and no jax; (b)
   ``parallel/multihost_dryrun.py``'s two controller processes, 4
   logical shards of ``cuda:0`` each over gloo (NCCL refuses two ranks on
   one card), read phase 5's north-star panel from a file: the sharded
   monthly engine (qcut, J=12) and banded engine (band 1) in each process
   bit-equal to phase 17's one-process 8-shard results, K1 once per asset
   shard (4 a process, 8 in all; the banded engine none), and the 96 x 72
   f64 dry run within its tolerances of the single-device engines; (c)
   ``distributed_init`` at world size 1: the 8-shard monthly engine
   bit-equal to phase 17's; the kernels line gains ``multihost_launches``;
20. rehearse and timeline (run after phase 19; no profiler trace; its
   wall is printed and held within ``REHEARSE_BUDGET_S``): (a) ``python
   -m csmom_tpu_torch.cli rehearse --only corrupt-aot-cache`` in a
   process of its own: two warm-up processes of profile ``smoke`` with
   ``CSMOM_JIT_CACHE`` in the scenario's sandbox, the first building both
   libraries there with nvcc, the second corrupting every file of it
   before its first entry; green, with at least one entry
   ``self_healed``, no error and K1 and K2 launched from the rebuilt
   libraries, which, loaded as they are in a process of their own, equal
   their plain versions at the warmed shapes (counts equal, f32 sums
   within the smoke's limits); every file of the repository's own
   ``build/csmom_tpu_torch/`` keeps its sha256; (b) ``rehearse --fast``
   (13 of 13 green) and ``rehearse --only fabric`` (3 of 3), each
   scenario's wall logged; (c) ``timeline rehearse_fast --json`` over
   (b)'s ``GPU_TELEMETRY_rehearse_fast.json``: valid, one
   ``rehearse.row`` span a scenario; the kernels line gains
   ``rehearse_launches``;
21. the perf ledger (run after phase 20; no profiler trace; its wall is
   held within ``LEDGER_BUDGET_S``): (a) ``SignalService`` on the card
   (profile ``serve``, the ``torch`` engine) driven twice by phase 11's
   ``2x40`` schedule, seed 0, landed as ``GPU_SERVE_r01.json`` and
   ``GPU_SERVE_r02.json`` (round names: phase 11's runs carry none, so
   the ledger skips them), both valid, K1 launched by their ``backtest``
   micro-batches and K2 never, launch counts read around the two runs;
   (b) ``ledger show`` over them: ``serve_p99_ms`` rows for both runs,
   platform ``gpu``, with samples, no problem; (c) ``ledger diff r01 r02
   --device cuda``: a verdict for every comparable key, each key's CIs
   computed on the card equal to ``regress.compare(..., device="cpu")``'s
   within ``LEDGER_CI_RTOL`` with the same verdict, each verdict and the
   bootstrap's time a key on the card and on the CPU logged (two real
   runs may truly differ: no pass is asked of r02); (d) r02 with every
   latency percentile and sample x3 as ``GPU_SERVE_r03.json``: ``ledger
   gate --offline --device cuda`` exits 1 with a FAIL line for
   ``serve_p99_ms``; (e) r01 and an exact copy as ``GPU_SERVE_r04.json``:
   the gate exits 0 with no FAIL line; (f) (d)'s gate as ``python -m
   csmom_tpu_torch.cli ledger gate`` in a process of its own exits 1;
   (g) ``ledger roadmap --write`` splices a file carrying the port's
   markers and refuses a copy of ROADMAP.md (exit 1), leaving it byte for
   byte unchanged; the kernels line gains ``ledger_launches``;
22. bench and the capture tier (run after phase 21; no profiler trace;
   its wall is held within ``BENCH_PHASE_BUDGET_S`` = 150 s): (a)
   ``python -m csmom_tpu_torch.cli bench --device cuda`` in a process of
   its own at the full workload (``CSMOM_ROUND=r22``,
   ``CSMOM_BENCH_BUDGET=600``, its records in a temporary directory):
   exit 0, one headline line of at most 1600 characters passing
   ``validate_headline_text``, ``GPU_BENCH_FULL_r22.json`` and its
   ``GPU_TELEMETRY_r22.json`` sidecar valid, platform ``gpu`` and
   nvidia-smi's device name, ``golden_ok``, a measured float for the
   headline and every leg of ``BENCH_MEASURED`` (the plain, matmul,
   kernel (K2) and bf16 grids, the two full-size legs, the sharded leg on
   8 logical shards of ``cuda:0``), ``grid_hbm_fraction`` at most 1.05, a
   histrank comparison, the warm-up child not needed (phase 2 built the
   libraries) or run without errors, and K2 launched by the measuring
   child at least the kernel leg's 6 calls (its record's
   ``kernel_launches``: the process's own counts from 0); (b) ``ledger
   show`` over (a)'s directory: ``grid16_rank_s`` rows on platform
   ``gpu``, no problem; (c) ``rehearse --device cuda`` over the ``mini``
   and ``shell`` tiers and ``expire-deadline-mid-row`` (7 of 7 green;
   ``kill-child-mid-compile`` runs on the CPU in tier-1); the kernels
   line gains ``bench_launches`` (the measuring child's counts);
23. donation (after 22; in this process, no subprocess, no profiler
   trace; its wall is held within ``DONATION_BUDGET_S`` = 20 s): every
   donated surface against its plain call, outputs bit-equal, the
   caller's tensors consumed, the allocator peaks of both calls on a
   ``[donation]`` line and the donated one no higher (``donation_phase``:
   (a) the grid and its netting pass on phase 5's panel, K2 launched;
   (b) the two event engines on a ``[512, 23,400]`` minute panel; (c) the
   ``backtest`` scorer's donated variant, K1 once; (d) a read after
   donation); the kernels line gains ``donation_launches``;
then the phase walls, the card's name line and, last, ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the monthly leg of the JAX package's committed synthetic golden
# (tests/test_synthetic_golden.py: synthetic_daily_panel(40, 1260,
# seed=123, listing_gaps=True), J=12, skip=1, f64)
MONTHLY = {
    "n_months": 58,
    "n_valid_spreads": 44,
    "mean_spread": -0.024151046163,
    "ann_sharpe": -0.838545964552,
    "nw_t": -2.001284759867,
    "cum_return": 0.271094424165,
}

# the research paths' leg of the same golden panel: the JAX package's own
# outputs in f64 (jax_enable_x64, so its bootstrap draws int64 indices),
# recomputed from csmom_tpu by tests/test_torch_inference.py so these pins
# cannot drift.  Sector ids: golden_sector_ids(); grid: J, K in {3, 6, 9,
# 12}, skip 1, rank mode; costs at 10 bps half-spread (monthly) and a unit
# half-spread (grid); bootstrap and draws from PRNGKey(0).
GOLDEN_SECTORS = 3
RESEARCH = {
    "sector_valid": 44,
    "sector_mean_spread": -0.02184539400257678,
    "sector_nw_t": -2.1447455472780788,
    "net10_mean": -0.023087818245001022,
    "net10_sharpe": -0.8227915036932137,
    "grid_unit_net_mean": [
        -1.1375619411478115, -0.5766345049280238, -0.4088790438471827,
        -0.2985255023033044, -0.8246914593086627, -0.604875565048859,
        -0.41812075472667704, -0.2869995931006015, -0.7712193945631716,
        -0.5438731071001996, -0.40523748264861215, -0.28584517664729353,
        -0.6821371426437131, -0.4704619733012217, -0.3753955398595861,
        -0.2805966447665517,
    ],
    "grid_break_even_bps": [
        -43.103115730822594, -136.56586485885552, -367.02917934739133,
        -324.1207566925033, -144.26851996988572, -369.29540083758184,
        -464.5538702284668, -93.87346476063426, -342.51174828094344,
        -513.1186133406032, -252.64462347402034, 78.86049986897648,
        -326.3051629685034, -196.48981961894424, 81.96616625393713,
        264.34538602034314,
    ],
    "wf_choice": [
        -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 15, 15, 15, 15, 15, 15, 15, 15,
        15,
    ],
    "wf_oos_mean": 0.00013420447103893384,
    "ci_lo": [
        -0.017202204168308873, -0.021317994081515287, -0.031737939554437045,
        -0.024565331851112603, -0.04396679417973012, -0.053507869079660826,
        -0.043135847167136546, -0.01577099144566405, -0.058615576649757306,
        -0.05648369283213483, -0.031877705239885486, -0.015095789505290022,
        -0.043033728729207306, -0.03423074349276336, -0.016358061469760186,
        -0.011263989698251398,
    ],
    "ci_hi": [
        0.009305687620646149, 0.004067271771847802, -0.0017797179226282458,
        0.0018299452066358295, 0.011749231295398479, 0.002331093131830444,
        -0.0005929201760837455, 0.012356232631685312, 0.0028775928861093157,
        -0.0012209196075792668, 0.016723919247570055, 0.02244877744741283,
        -0.002649450482245071, 0.015277745920678428, 0.024139569073935104,
        0.026747658451305112,
    ],
    "randint32_sum": 8042429.0,
    "randint32_head": [349, 576, 296, 205, 155, 3, 528, 311],
    "randint64_sum": 8054003.0,
    "randint64_head": [87, 575, 119, 437, 357, 343, 530, 24],
    "uniform32_sum": 11577.633524537086,
    "uniform32_head": [
        0.9476670026779175, 0.9785798788070679, 0.33229148387908936,
        0.46866846084594727, 0.569888710975647, 0.16550302505493164,
        0.31019461154937744, 0.6894805431365967,
    ],
}


def golden_sector_ids(n_assets: int) -> np.ndarray:
    """Seeded sector ids in [-1, GOLDEN_SECTORS) (-1: unclassified)."""
    return np.random.default_rng(5).integers(-1, GOLDEN_SECTORS, size=n_assets)


def research_fingerprints(dev) -> dict:
    """The port's research paths on the golden panel in f64 on ``dev``:
    the values ``RESEARCH`` pins, by the same names."""
    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.tables import jk_grid_ci_table
    from csmom_tpu_torch.backtest.grid import (
        grid_break_even_bps, grid_net_of_costs, jk_grid_backtest,
    )
    from csmom_tpu_torch.backtest.monthly import net_of_costs, sector_neutral_backtest
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import to_tensors
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS

    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device=dev)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    sid = torch.as_tensor(golden_sector_ids(pm.shape[0]), device=dev)
    sec = sector_neutral_backtest(pm, mm, sid, GOLDEN_SECTORS, lookback=12, skip=1)
    _, net_mean, net_sharpe = net_of_costs(sec, half_spread=0.001)
    g = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=1, mode="rank")
    unit = grid_net_of_costs(pm, mm, g, half_spread=1.0)
    be, _ = grid_break_even_bps(pm, mm, g, unit=unit)
    wf = walk_forward_select(g.spreads, g.spread_valid)
    lo, hi = jk_grid_ci_table(g.spreads, g.spread_valid, GRID_JS, GRID_KS,
                              key=random.PRNGKey(0, device=dev), n_samples=200,
                              index_dtype=torch.int64)
    key = random.PRNGKey(0, device=dev)
    draws = {
        "randint32": random.randint(key, (200, 116), 0, 696, dtype=torch.int32),
        "randint64": random.randint(key, (200, 116), 0, 696, dtype=torch.int64),
        "uniform32": random.uniform(key, (200, 116), dtype=torch.float32),
    }
    got = {
        "sector_valid": int(sec.spread_valid.sum()),
        "sector_mean_spread": float(sec.mean_spread),
        "sector_nw_t": float(sec.tstat_nw),
        "net10_mean": float(net_mean),
        "net10_sharpe": float(net_sharpe),
        "grid_unit_net_mean": unit.mean_spread.flatten().tolist(),
        "grid_break_even_bps": be.flatten().tolist(),
        "wf_choice": wf.choice.tolist(),
        "wf_oos_mean": float(wf.mean_spread),
        "ci_lo": lo.to_numpy().ravel().tolist(),
        "ci_hi": hi.to_numpy().ravel().tolist(),
    }
    for name, d in draws.items():
        got[f"{name}_sum"] = float(d.to(torch.float64).sum())
        got[f"{name}_head"] = d.flatten()[:8].tolist()
    return got


def check_research(got: dict) -> None:
    """Hold fingerprints to ``RESEARCH``: integers and draws exactly, floats
    to the f64 golden's ``rtol=1e-9``."""
    if set(got) != set(RESEARCH):
        raise AssertionError(f"research keys differ: {sorted(set(got) ^ set(RESEARCH))}")
    for k, want in RESEARCH.items():
        exact = isinstance(want, int) or k == "wf_choice" or k.endswith("_head") \
            or k.startswith("randint")
        if exact:
            if got[k] != want:
                raise AssertionError(f"research {k}: {got[k]} != {want}")
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-9, err_msg=k)


# tests/test_synthetic_golden.py::test_csv_universe_golden: the committed
# universe (tests/fixtures/universe, 8 tickers in both cache dialects),
# lookback 6, skip 1, 4 bins, f64
CSV_GOLDEN = {"shape": (8, 23), "n_valid_spreads": 15, "mean_spread": 0.007170869622,
              "ann_sharpe": 0.207281538823, "nw_t": 0.249081731114}
# the JAX package's ingest workload (BENCH_FULL_r05.json, pack_ingest_note)
CSV_AT_SCALE = (256, 3780)


def write_csv_cache(daily, volume, out_dir: str) -> list:
    """Each asset's listed days as one cache CSV, ``<ticker>_daily.csv``, in
    dialect A (Date header and a junk ticker row) for even rows and
    dialect B (Price/Ticker/Date preamble, no Adj Close) for odd ones, six
    decimals.  Returns the tickers."""
    import pandas as pd

    dates = np.datetime_as_string(daily.times.astype("datetime64[D]"))
    for i, t in enumerate(daily.tickers):
        live = daily.mask[i]
        close = daily.values[i, live]
        cols = {"Date": dates[live]}
        if i % 2 == 0:
            cols["Adj Close"] = close
            head = f"Date,Adj Close,Close,High,Low,Open,Volume\n,{t},{t},{t},{t},{t},{t}\n"
        else:
            head = f"Price,Close,High,Low,Open,Volume\nTicker,{t},{t},{t},{t},{t}\nDate,,,,,\n"
        cols.update({"Close": close, "High": close * 1.01, "Low": close * 0.99,
                     "Open": close * 1.002,
                     "Volume": volume[i, live].astype(np.int64)})
        body = pd.DataFrame(cols).to_csv(header=False, index=False, float_format="%.6f")
        with open(os.path.join(out_dir, f"{t}_daily.csv"), "w") as f:
            f.write(head + body)
    return list(daily.tickers)


def same(a, b) -> bool:
    """Bit-for-bit equal arrays or tensors (NaN where NaN), of one type."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and a[~nan].tobytes() == b[~nan].tobytes()


def data_in(dev, smi, pm, mm, ends, mres, grids, pack_dir) -> dict:
    """Phase 7: CSV caches and packs -> month-end panels on the card.

    ``pm, mm, ends`` are phase 5's north-star month-end panel, ``mres`` its
    monthly engine run and ``grids`` its grids; part (b) writes its pack to
    ``pack_dir``, which the caller keeps for phase 8.  Returns the kernel
    launch counts of part (b)'s run (the slice's main path at full width)."""
    import warnings

    import torch

    from csmom_tpu_torch import native
    from csmom_tpu_torch.analytics.stats import nw_t_stat
    from csmom_tpu_torch.analytics.tearsheet import tearsheet
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
    from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.panel.ingest import load_daily, long_to_panel
    from csmom_tpu_torch.panel.pack import load_packed, pack_csv_cache, save_packed
    from csmom_tpu_torch.panel.panel import Panel, PanelBundle
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.phases import REPS, time_call
    from csmom_tpu_torch.workloads import NORTH_STAR_GRID

    def wall(fn):
        """(result, host ms) of ``fn()``, the card synchronized around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def copy_ms(dst, src, reps=5):
        """Median CUDA-event ms of ``dst.copy_(src)`` (asynchronous when
        ``src`` is pinned)."""
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def dir_bytes(path):
        return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))

    if not native.available():
        raise AssertionError("data-in: the native CSV parser did not build")

    # (a) the committed CSV universe, f64, through K1
    universe = os.path.join(REPO, "tests", "fixtures", "universe")
    tickers = sorted(n.split("_")[0] for n in os.listdir(universe))
    files0 = native.parse_price_csv_native.files
    kernels.reset_launches()
    (prices, _), golden_ms = wall(lambda: monthly_price_panel(universe, tickers))
    parsed = native.parse_price_csv_native.files - files0
    if parsed != len(tickers):
        raise AssertionError(f"data-in (a): {parsed} of {len(tickers)} files parsed natively")
    if prices.shape != CSV_GOLDEN["shape"] or prices.values.dtype != np.float64:
        raise AssertionError(f"data-in (a): panel {prices.shape} {prices.values.dtype}")
    v, m = prices.tensors()
    res = monthly_spread_backtest(v, m, lookback=6, skip=1, n_bins=4)
    k1_golden = kernels.decile_partial_sums.launches
    if k1_golden < 1:
        raise AssertionError("data-in (a): K1 was not launched")
    got = {"n_valid_spreads": int(res.spread_valid.sum()),
           "mean_spread": float(res.mean_spread), "ann_sharpe": float(res.ann_sharpe),
           "nw_t": float(nw_t_stat(res.spread, res.spread_valid))}
    if got["n_valid_spreads"] != CSV_GOLDEN["n_valid_spreads"]:
        raise AssertionError(f"data-in (a): {got['n_valid_spreads']} valid spreads")
    for k in ("mean_spread", "ann_sharpe", "nw_t"):
        np.testing.assert_allclose(got[k], CSV_GOLDEN[k], rtol=1e-9, err_msg=k)
    log("data-in", f"(a) CSV universe {len(tickers)} tickers, every file by the native "
                   f"parser -> {prices.shape[0]}x{prices.shape[1]} f64 month ends on "
                   f"{dev}: the JAX package's CSV golden reproduced ({got}); K1 "
                   f"launches {k1_golden}; monthly_price_panel {golden_ms:.2f} ms host")

    # (b) the north-star daily panel as a two-field f32 pack
    n_stocks, n_days = NORTH_STAR_GRID
    t0 = time.perf_counter()
    daily = synthetic_daily_panel(n_stocks, n_days, seed=7, listing_gaps=True)
    vol = np.random.default_rng(70).integers(10_000, 5_000_000, size=daily.shape
                                             ).astype(np.float32)
    vol[~daily.mask] = np.nan
    gen_ms = (time.perf_counter() - t0) * 1e3
    fields = {"adj_close": daily.values.astype(np.float32), "volume": vol}
    bundle = PanelBundle(
        panels={f: Panel(values=x, mask=daily.mask, tickers=daily.tickers,
                         times=daily.times, name=f) for f, x in fields.items()},
        tickers=daily.tickers, times=daily.times)
    _, write_ms = wall(lambda: save_packed(bundle, pack_dir))
    packed, open_ms = wall(lambda: load_packed(pack_dir))
    if not isinstance(packed["adj_close"].values, np.memmap):
        raise AssertionError("data-in (b): the pack did not open memmapped")
    # the hand-off of both memmapped fields (read into pinned host
    # memory, then copied), and its two parts for the price field
    _, tensors_ms = wall(lambda: [packed[f].tensors() for f in packed.fields])
    src = packed["adj_close"].values
    pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        _, fill_ms = wall(lambda: pinned.copy_(torch.from_numpy(src)))
    pageable = torch.from_numpy(np.array(src))
    dst = torch.empty(src.shape, dtype=torch.float32, device=dev)
    h2d = {"pinned": copy_ms(dst, pinned), "pageable": copy_ms(dst, pageable)}
    if not same(dst, pageable):
        raise AssertionError("data-in (b): the copied panel differs from the pack")
    del pinned, pageable, dst

    # the slice's main path at full width; launch counts read around it
    kernels.reset_launches()
    (dprices, dvolume), mpp_ms = wall(lambda: monthly_price_panel(pack_dir, None))
    rep, run_monthly_ms = wall(lambda: run_monthly(dprices, lookback=12, skip=1,
                                                   mode="qcut"))
    grep, run_grid_ms = wall(lambda: run_grid(dprices, mode="rank"))
    dpm, dmm = dprices.tensors()
    band1 = banded_monthly_backtest(dpm, dmm, lookback=12, skip=1, mode="qcut", band=1)
    band0 = banded_monthly_backtest(dpm, dmm, lookback=12, skip=1, mode="qcut", band=0)
    gs = torch.as_tensor(grep.spreads, device=dev)
    gv = torch.as_tensor(grep.spread_valid, device=dev)
    ts = tearsheet(gs, gv)
    torch.cuda.synchronize()
    launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"data-in (b): a kernel was not launched: {launches}")
    pack_mb = dir_bytes(pack_dir) / 1e6
    mpp_again = [wall(lambda: monthly_price_panel(pack_dir, None))[1] for _ in range(2)]

    # the month ends are a selection, so the f32 pack aggregates to the
    # generated panel's month ends bit for bit
    if not (same(dprices.values, pm) and same(dprices.mask, mm)
            and np.array_equal(dprices.times, ends) and dprices.tickers == daily.tickers
            and dprices.values.dtype == np.float32):
        raise AssertionError("data-in (b): the pack's month ends differ from "
                             "north_star_month_panel()")
    if not (np.array_equal(dvolume.mask, dprices.mask)
            and bool((dvolume.values[dvolume.mask] > 0).all())
            and bool((dvolume.values[~dvolume.mask] == 0).all())):
        raise AssertionError("data-in (b): monthly volumes or their mask are wrong")
    np.testing.assert_allclose(dvolume.values.astype(np.float64).sum(),
                               np.nansum(vol, dtype=np.float64), rtol=1e-6)
    if not (same(rep.labels, mres.labels) and same(rep.decile_counts, mres.decile_counts)
            and same(rep.decile_means, mres.decile_means)
            and same(rep.spread, torch.where(mres.spread_valid, mres.spread, torch.nan))
            and rep.mean_spread == float(mres.mean_spread)
            and rep.tstat_nw == float(mres.tstat_nw)):
        raise AssertionError("data-in (b): run_monthly from the pack differs from phase 5")
    g5 = grids["rank"]
    if not all(same(getattr(grep, k), getattr(g5, k)) for k in
               ("spreads", "spread_valid", "mean_spread", "ann_sharpe", "tstat_nw")):
        raise AssertionError("data-in (b): run_grid from the pack differs from phase 5")
    # band 0 is the plain engine: its spread and its turnover charge
    if not torch.equal(band0.spread_valid, mres.spread_valid):
        raise AssertionError("data-in (b): band=0 validity differs from the plain engine")
    torch.testing.assert_close(band0.spread, mres.spread, rtol=0, atol=SPREAD_ATOL,
                               equal_nan=True)
    charge = turnover_cost(long_short_weights(mres.labels, mres.decile_counts, 10,
                                              dtype=torch.float32), half_spread=1.0)
    torch.testing.assert_close(band0.turnover, charge, rtol=F32_RTOL, atol=F32_ATOL)
    if not float(band1.turnover.mean()) < float(band0.turnover.mean()):
        raise AssertionError("data-in (b): the band did not cut turnover")
    # the tearsheet on the card against its CPU run on the same spreads
    ts_cpu = tearsheet(gs.cpu(), gv.cpu())
    for f in ts.__dataclass_fields__:
        a, b = getattr(ts, f).cpu(), getattr(ts_cpu, f)
        if f == "n_periods":
            if not torch.equal(a, b) or not torch.equal(a, gv.sum(-1).to(torch.int32).cpu()):
                raise AssertionError("data-in (b): tearsheet period counts")
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, equal_nan=True, msg=f)
    if tuple(ts.ann_return.shape) != (4, 4) or not bool(torch.isfinite(ts.ann_return).all()):
        raise AssertionError("data-in (b): tearsheet returns not finite over 4x4 cells")
    banded_ms = time_call(lambda: banded_monthly_backtest(dpm, dmm, 12, 1, mode="qcut", band=1))
    tear_ms = time_call(lambda: tearsheet(gs, gv))
    log("data-in", f"(b) {n_stocks}x{n_days} f32 pack ({pack_mb:.1f} MB: adj_close and "
                   f"volume, values and masks) -> {dprices.shape[0]}x{dprices.shape[1]} "
                   f"month ends on {dev} equal north_star_month_panel() bit for bit; "
                   f"run_monthly (qcut, J=12; K1) and run_grid (rank; K2) from it equal "
                   f"phase 5 bit for bit; band 0 = the plain engine's spread and "
                   f"turnover charge (max |turnover err| "
                   f"{(band0.turnover - charge).abs().max().item():.3g}); band 1 mean "
                   f"turnover {float(band1.turnover.mean()):.4f} vs "
                   f"{float(band0.turnover.mean()):.4f}; tearsheet of 16 cells equals "
                   f"its CPU run; launches {launches}")
    timings = {
        "generate_host_ms": gen_ms, "pack_write_ms": write_ms, "pack_open_ms": open_ms,
        "tensors_two_fields_ms": tensors_ms,
        "adj_close_read_into_pinned_ms": fill_ms,
        "adj_close_h2d_pinned_ms": h2d["pinned"], "adj_close_h2d_pageable_ms": h2d["pageable"],
        "adj_close_mb": src.nbytes / 1e6,
        "monthly_price_panel_ms": [mpp_ms] + mpp_again,
        "run_monthly_ms": run_monthly_ms, "run_grid_ms": run_grid_ms,
        "banded_band1_device_ms": banded_ms[0], "banded_band1_host_ms": banded_ms[1],
        "tearsheet_16_device_ms": tear_ms[0], "tearsheet_16_host_ms": tear_ms[1],
    }
    log("data-in", f"(b) times (host wall around a synchronized call unless named "
                   f"device: CUDA events, medians of {REPS}; H2D medians of 5) "
                   f"{json.dumps(timings)} | {smi}")

    # (c) CSVs at scale in both dialects -> native ingest -> pack
    n_csv, d_csv = CSV_AT_SCALE
    cdaily = synthetic_daily_panel(n_csv, d_csv, seed=7, listing_gaps=True)
    cvol = np.random.default_rng(71).integers(10_000, 5_000_000, size=cdaily.shape)
    with tempfile.TemporaryDirectory(prefix="csmom_smoke_") as tmp:
        csv_dir, cpack = os.path.join(tmp, "csv"), os.path.join(tmp, "pack")
        os.makedirs(csv_dir)
        ctk, csv_write_ms = wall(lambda: write_csv_cache(cdaily, cvol, csv_dir))
        csv_mb = dir_bytes(csv_dir) / 1e6
        files0 = native.parse_price_csv_native.files
        df, load_ms = wall(lambda: load_daily(csv_dir, ctk))
        _, pack_ms = wall(lambda: pack_csv_cache(csv_dir, ctk, cpack))
        parsed = native.parse_price_csv_native.files - files0
        if parsed != 2 * n_csv:
            raise AssertionError(f"data-in (c): {parsed} of {2 * n_csv} files parsed natively")
        cp = load_packed(cpack)
        for f in ("adj_close", "volume"):
            want = long_to_panel(df, f)
            if not (same(cp[f].values, want.values) and same(cp[f].mask, want.mask)
                    and cp[f].tickers == want.tickers
                    and np.array_equal(cp[f].times, want.times)):
                raise AssertionError(f"data-in (c): the pack's {f} differs from its frames")
        if len(cp["adj_close"].tickers) != n_csv or len(df) != int(cdaily.mask.sum()):
            raise AssertionError(f"data-in (c): {len(df)} rows of {int(cdaily.mask.sum())}")
        (csv_p, csv_v), csv_mpp_ms = wall(lambda: monthly_price_panel(csv_dir, ctk))
        (pk_p, pk_v), pack_mpp_ms = wall(lambda: monthly_price_panel(cpack, ctk))
        for a, b in ((csv_p, pk_p), (csv_v, pk_v)):
            if not (same(a.values, b.values) and same(a.mask, b.mask)
                    and a.tickers == b.tickers and np.array_equal(a.times, b.times)):
                raise AssertionError("data-in (c): CSV and pack month ends differ")
        cpack_mb = dir_bytes(cpack) / 1e6
    log("data-in", f"(c) {n_csv} tickers x {d_csv} days as CSVs in both dialects "
                   f"({csv_mb:.1f} MB, {len(df)} rows) -> native ingest -> f64 pack "
                   f"({cpack_mb:.1f} MB) equal to its frames; month ends "
                   f"{csv_p.shape[0]}x{csv_p.shape[1]} equal from the CSVs and the pack; "
                   + json.dumps({"csv_write_ms": csv_write_ms, "load_daily_native_ms": load_ms,
                                 "pack_csv_cache_ms": pack_ms,
                                 "monthly_price_panel_csv_ms": csv_mpp_ms,
                                 "monthly_price_panel_pack_ms": pack_mpp_ms})
                   + f" | {smi}")
    return launches


def k2_bound_inputs(labels, ret, ret_valid, n_bins: int, H: int):
    """(bytes, operations) K2 must move and do on these inputs: each input
    read once and both outputs written once; two adds per (member,
    horizon inside the panel)."""
    nJ, A, M = labels.shape
    out_bytes = 2 * nJ * 2 * M * H * ret.element_size()
    nbytes = labels.nbytes + ret.nbytes + ret_valid.nbytes + out_bytes
    members = ((labels == 0).sum(dim=(0, 1)) + (labels == n_bins - 1).sum(dim=(0, 1)))
    horizons = (M - 1 - np.arange(M)).clip(0, H)
    return nbytes, 2 * int((members.cpu().numpy().astype(np.int64) * horizons).sum())


def cli_phase(dev, smi, pack_dir, out_dir, mres, grids, assert_sums, bound) -> dict:
    """Phase 8: the port's CLI on phase 7(b)'s pack, in-process, on the card.

    ``mres`` and ``grids`` are phase 5's monthly engine run and grids on
    the same month ends.  Each command runs with the launch counts set to 0
    just before it and read just after; returns their sums per kernel."""
    import contextlib
    import io

    import torch

    from csmom_tpu_torch.analytics.tables import (
        double_sort_table,
        horizon_table,
        jk_grid_table,
        volume_horizon_table,
    )
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.backends.dispatch import run_monthly
    from csmom_tpu_torch.backtest.double_sort import volume_double_sort
    from csmom_tpu_torch.backtest.horizon import (
        _momentum_labels,
        horizon_profile,
        volume_horizon_profile,
    )
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.phases import REPS, time_kernels
    from csmom_tpu_torch.signals.momentum import monthly_returns
    from csmom_tpu_torch.signals.turnover import turnover_features, volume_tercile_labels
    from csmom_tpu_torch.strategy import Momentum
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS

    common = ["--data-dir", pack_dir, "--device", "cuda", "--out", out_dir]
    totals = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    walls = {}

    def run(label, argv, k1, k2):
        """The command's stdout; it must exit 0 and launch K1 ``k1`` and
        K2 ``k2`` times."""
        buf = io.StringIO()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {"decile_partial_sums": kernels.decile_partial_sums.launches,
               "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}\n{buf.getvalue()}")
        if got != {"decile_partial_sums": k1, "cohort_partial_sums": k2}:
            raise AssertionError(f"cli {label}: launches {got}, expected K1 {k1}, K2 {k2}")
        for name, n in got.items():
            totals[name] += n
        walls[label] = ms
        log("cli", f"{label}: {ms:.2f} ms host wall, launches {got} | {smi}")
        return buf.getvalue()

    def expect(label, out, *texts):
        for text in texts:
            if text not in out:
                raise AssertionError(f"cli {label}: {text!r} not in its output:\n{out}")

    stats_lines = (f"Mean monthly spread: {float(mres.mean_spread):.6f}\n"
                   f"Annualized Sharpe:   {float(mres.ann_sharpe):.4f}\n"
                   f"t-stat (NW):         {float(mres.tstat_nw):.3f}\n"
                   f"t-stat (iid):        {float(mres.tstat):.3f}\n")

    prices, volume = monthly_price_panel(pack_dir, None)
    A, M = prices.shape

    # 1. replicate with every reporting flag: phase 5's monthly engine
    out = run("replicate", ["replicate", *common, "--tables", "--tc-bps", "10",
                            "--band", "1", "--bootstrap", "200", "--tearsheet"], 1, 0)
    expect("replicate", out, f"Universe: {A} tickers x {M} dates", stats_lines,
           "net of 10 bps half-spread turnover costs", "break-even half-spread",
           "hysteresis band 1", "Per-decile performance (R1 = losers):",
           "-- tearsheet: monthly spread (torch) --", "Per-year compounded spread:",
           "95% CI mean:", "95% CI Sharpe:")

    # 2. the strategies; momentum is the monthly engine bit for bit
    for name, extra in (("momentum", ()), ("low_volatility", ()),
                        ("volume_z_momentum", ()), ("residual_momentum", ()),
                        ("zscore_combo", ("--strategy-arg",
                                          "components=momentum:0.6,reversal:0.4"))):
        out = run(f"replicate --strategy {name}",
                  ["replicate", *common, "--strategy", name, *extra], 1, 0)
        expect(name, out, "strategy: ", "Mean monthly spread: ")
        if name == "momentum":
            expect(name, out, "strategy: Momentum(lookback=12, skip=1)\n", stats_lines)
    srep = run_monthly(prices, strategy=Momentum(), device="cuda")
    if not (same(srep.labels, mres.labels) and same(srep.decile_counts, mres.decile_counts)
            and same(srep.spread, torch.where(mres.spread_valid, mres.spread, torch.nan))
            and srep.mean_spread == float(mres.mean_spread)
            and srep.tstat_nw == float(mres.tstat_nw)):
        raise AssertionError("cli: --strategy momentum differs from the monthly engine")

    # 3. grid and sweep: phase 5's rank grid
    g = grids["rank"]
    out = run("grid --mode rank --tc-bps 5",
              ["grid", *common, "--mode", "rank", "--tc-bps", "5"], 0, 1)
    for title, df in zip(("mean monthly spread", "Newey-West t-stat (lag=K)",
                          "annualized Sharpe"),
                         jk_grid_table(g.spreads, g.spread_valid, GRID_JS, GRID_KS)):
        expect("grid", out, f"\n{title}:\n{df.round(4).to_string()}\n")
    expect("grid", out, "NET of 5 bps half-spread", "break-even half-spread (bps)",
           "95% CI mean spread, lower (200 block-bootstrap resamples):")
    out = run("sweep --mode rank", ["sweep", *common, "--mode", "rank"], 0, 1)
    wf = walk_forward_select(g.spreads, g.spread_valid, min_months=24)
    expect("sweep", out, "Selection basis:   gross\n",
           f"OOS months:        {int(wf.oos_valid.sum())}\n",
           f"OOS mean spread:   {float(wf.mean_spread):.6f}\n",
           f"OOS ann. Sharpe:   {float(wf.ann_sharpe):.4f}\n")

    # 4. K2 at the horizon commands' shapes against its plain version,
    # timed there; then the commands, each one K2 launch
    pm, mm = prices.tensors(device=dev)
    ret, ret_valid = monthly_returns(pm, mm)
    labels, mom_valid = _momentum_labels(pm, mm, 12, 1, 10, "qcut")
    turn, turn_valid = turnover_features(
        torch.as_tensor(volume.values, device=dev), torch.as_tensor(volume.mask, device=dev),
        np.ones(A), lookback=3)["turn_avg"]
    both = mom_valid & turn_valid
    vol_labels, _ = volume_tercile_labels(torch.where(both, turn, torch.nan), both)
    terciles = torch.arange(3, device=dev)[:, None, None]
    labels_v = torch.where(vol_labels[None] == terciles, labels[None], -1).to(torch.int32)
    absum_r = torch.where(ret_valid, torch.nan_to_num(ret), 0.0).abs()
    k2_shapes = []
    for lab, H in ((labels[None], 36), (labels[None], 60), (labels_v, 36)):
        shape = f"{list(lab.shape)} H={H}"
        s, c = kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H)
        again = kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H)
        p, pc = kernels.cohort_partial_sums_plain(ret, ret_valid, lab, 10, H)
        absum, _ = kernels.cohort_partial_sums_plain(absum_r, ret_valid, lab, 10, H)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"K2 {shape}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"K2 {shape}: counts differ from the plain version")
        assert_sums(s, p, absum, torch.float32, f"K2 {shape}")
        nbytes, ops = k2_bound_inputs(lab, ret, ret_valid, 10, H)
        b_ms, b_by = bound(nbytes, ops)
        device_ms, per_call = time_kernels(
            lambda: kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H),
            kernels.cohort_partial_sums.device_kernels)
        k2_shapes.append({"shape": shape, "device_ms": device_ms, "kernels_per_call": per_call,
                          "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / device_ms,
                          "bytes": nbytes, "ops": ops,
                          "max_abs_err": (s - p).abs().max().item()})
    log("kernels", f"K2 at the horizons shapes, f32, equal to its plain version (counts "
                   f"exact, sums within 1e-6 + 1e-5 sum|x|), device ms medians of {REPS} "
                   f"with L2 flushed, bound as in the kernels line: "
                   f"{json.dumps(k2_shapes)} | {smi}")

    for max_h in (36, 60):
        argv = ["horizons", *common] + (["--max-h", str(max_h)] if max_h != 36 else [])
        out = run(f"horizons --max-h {max_h}", argv, 0, 1)
        hp = horizon_profile(pm, mm, lookback=12, skip=1, n_bins=10, mode="qcut", max_h=max_h)
        if not bool(torch.isfinite(hp.mean_spread[:max_h - 12]).all()):
            raise AssertionError(f"horizons {max_h}: non-finite mean spreads")
        expect("horizons", out, f"J=12 event-time profile, horizons 1..{max_h}:\n"
                                f"{horizon_table(hp).round(4).to_string()}\n")
    out = run("horizons --by-volume", ["horizons", *common, "--by-volume"], 0, 1)
    vhp = volume_horizon_profile(pm, mm, turn, turn_valid, lookback=12, skip=1,
                                 n_bins=10, mode="qcut", max_h=36)
    expect("horizons --by-volume", out,
           "J=12 momentum life cycle by volume tercile (turnover avg 3m), horizons "
           f"1..36:\n{volume_horizon_table(vhp).round(4).to_string()}\n")

    # 5. doublesort, residual, pack-info, strategies
    out = run("doublesort", ["doublesort", *common], 0, 0)
    ds = volume_double_sort(pm, mm, turn, turn_valid, lookback=12, skip=1)
    expect("doublesort", out, double_sort_table(ds).round(4).to_string())
    out = run("residual", ["residual", *common], 9, 0)
    expect("residual", out, "mean monthly spread:", "Newey-West t-stat:",
           "annualized Sharpe:", "est_window")
    out = run("pack-info", ["pack-info", pack_dir], 0, 0)
    expect("pack-info", out, f"universe: {A} tickers", "field adj_close: dtype float32",
           "field volume: dtype float32")
    out = run("strategies", ["strategies"], 0, 0)
    expect("strategies", out, *(f"\n{n}(" for n in (
        "intermediate_momentum", "low_volatility", "momentum", "residual_momentum",
        "reversal", "volume_z_momentum", "zscore_combo")), "high_52w(")

    # 6. the committed CSV universe in f64: the CSV golden
    universe = os.path.join(REPO, "tests", "fixtures", "universe")
    tickers = ",".join(sorted(n.split("_")[0] for n in os.listdir(universe)))
    out = run("replicate (CSV universe, f64)",
              ["replicate", "--data-dir", universe, "--tickers", tickers, "--lookback",
               "6", "--n-bins", "4", "--device", "cuda", "--out", out_dir], 1, 0)
    expect("replicate (CSV universe)", out,
           f"Mean monthly spread: {CSV_GOLDEN['mean_spread']:.6f}\n"
           f"Annualized Sharpe:   {CSV_GOLDEN['ann_sharpe']:.4f}\n"
           f"t-stat (NW):         {CSV_GOLDEN['nw_t']:.3f}\n")
    log("cli", f"every command exited 0 with its checks; host walls (ms) "
               f"{json.dumps(walls)}; launches over the phase {totals} | {smi}")
    return totals


# the intraday leg's goldens (the JAX package's tests/test_synthetic_golden.py:
# synthetic_daily_panel(8, 10, seed=77) -> synthetic_minute_frame(seed=5),
# 31,200 rows, f64): the ridge pipeline (EVENT) and the causal one (ONLINE)
EVENT = {
    "n_trades": 29_423,
    "total_pnl": 12_246.7590405609,
    "final_cash": 1_469_477.6043309155,
    "cv_mse": [1.111000906788e-06, 1.028217201301e-06, 1.515819594342e-06],
    "n_train": 21_828,
}
ONLINE = {
    "n_trades": 28_545,
    "total_pnl": -12_923.9031903070,
    "final_cash": 1_270_969.0140300414,
    "cv_mse": [1.284104689967e-06, 1.622457984344e-06, 1.779746464592e-06],
    "n_train": 31_184,
}
# the rest of the intraday leg on the same frame: the JAX package's own
# outputs in f64, recomputed from csmom_tpu by
# tests/test_torch_intraday_pipeline.py so these pins cannot drift.
# Elastic net and lasso at the pipeline's default alpha (1e-8); the MLP at
# its defaults (hidden (32, 16), 500 AdamW steps, seed 0); the engines on
# the ridge pipeline's dense panels: hysteresis (1e-4 / 2e-5), latency 3
# with its cost attribution, limit orders (PRNGKey(0)), a 5-point sweep.
INTRADAY_SWEEP = (1e-6, 5e-6, 1e-5, 5e-5, 1e-4)
INTRADAY = {
    "elastic_net": {"n_nonzero": 5, "cv_mse": [1.11100013624304e-06, 1.0282157024999398e-06,
                                               1.515818927663514e-06],
                    "n_trades": 29424, "total_pnl": 12179.140292694443},
    "lasso": {"n_nonzero": 5, "cv_mse": [1.1109995659184345e-06, 1.028216279242958e-06,
                                         1.5158182669953623e-06],
              "n_trades": 29422, "total_pnl": 12008.142506781267},
    "mlp": {"cv_mse": [1.1363744362946263e-06, 1.0544982299941935e-06,
                       1.5348318120859117e-06],
            "train_mse": 1.6258897182683836e-06, "score_sum": 0.020626221256286513,
            "score_abs_sum": 3.1794855774760427},
    "hysteresis": {"n_trades": 11177, "total_pnl": -3825.454071377055,
                   "final_cash": 996006.9428465493},
    "latency3": {"n_trades": 29403, "total_pnl": -979.4997836352559,
                 "total_cost": 35870.48389169092, "delay_cost": 13229.754129829815,
                 "spread_cost": 22045.63201748551, "impact_cost": 595.0977443752278,
                 "gross_notional": 44090978.95119476},
    "limit": {"n_trades": 16071, "total_pnl": 5321.471526839072},
    "sweep": {"total_pnl": [8834.901612664107, 9829.45828935213, 12246.759040560923,
                            18309.229193306644, 22854.144585987553],
              "n_trades": [31023, 30292, 29423, 22507, 14105],
              "cost_bps": [5.1350318390250935, 5.135034491609319, 5.134968396198647,
                           5.134951740121305, 5.135080379503219]},
}
# the goldens' float tolerance; the MLP's drift between the packages, 500
# AdamW steps x 4 fits in f64, measured 1.4e-14 relative on the MSEs and
# 9.1e-15 absolute on a score (tests/test_torch_models.py), so its sums
# take the same 1e-9 relative
INTRADAY_RTOL = 1e-9
# phase 9(b): a week of minute bars for an S&P-500-sized universe (the
# universe's width kept, the month's 21 days cut to 5)
INTRADAY_SCALE = (500, 3)
# phase 9(d): the CLI cache, 20 tickers of daily bars and 7 days of minutes
CLI_CACHE = (20, 1260, 7)
# phase 9(c): the f32 online-ridge walk is timed on this many of the
# cache's ~2,700 rows (all of them before the smoke's depth was cut)
F32_WALK_ROWS = 450


def golden_minute_frame():
    """The goldens' frames: ``(minute_df, daily_df)``, 31,200 minute rows."""
    import pandas as pd

    from csmom_tpu_torch.api import synthetic_minute_frame
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(8, 10, seed=77)
    a, t = len(daily.tickers), len(daily.times)
    v = daily.values.T.ravel()
    df = pd.DataFrame({"date": np.repeat(daily.times, a), "ticker": np.tile(daily.tickers, t),
                       "open": v, "close": v, "adj_close": v, "volume": 1e6})
    return synthetic_minute_frame(df, seed=5), df


def intraday_fingerprints(dev) -> dict:
    """The port's intraday leg on the golden frame in f64 on ``dev``, in
    the layout of ``INTRADAY``, the MLP apart (:func:`mlp_fingerprint`)."""
    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.api import daily_risk_maps, intraday_pipeline
    from csmom_tpu_torch.backtest.event import (
        cost_attribution, event_backtest, hysteresis_event_backtest, threshold_sweep,
    )

    minute_df, df = golden_minute_frame()
    out = {}
    _, _, compact, score, price, valid = intraday_pipeline(minute_df, df, device=dev)
    for model in ("elastic_net", "lasso"):
        r, f, *_ = intraday_pipeline(minute_df, df, model=model, device=dev)
        out[model] = {"n_nonzero": int((f.coef != 0).sum()), "cv_mse": f.cv_mse.cpu().tolist(),
                      "n_trades": int(r.n_trades), "total_pnl": float(r.total_pnl)}
    adv, vol = (torch.as_tensor(x, dtype=price.dtype).to(dev)
                for x in daily_risk_maps(df, compact.tickers))
    sc = torch.nan_to_num(score)
    h = hysteresis_event_backtest(price, valid, sc, adv, vol, threshold_hi=1e-4,
                                  threshold_lo=2e-5)
    out["hysteresis"] = {"n_trades": int(h.n_trades), "total_pnl": float(h.total_pnl),
                         "final_cash": float(h.cash[-1])}
    r3 = event_backtest(price, valid, sc, adv, vol, latency_bars=3)
    tca = cost_attribution(r3, price, latency_bars=3, valid=valid)
    out["latency3"] = {"n_trades": int(r3.n_trades), "total_pnl": float(r3.total_pnl),
                       **{k: float(getattr(tca, k)) for k in (
                           "total_cost", "delay_cost", "spread_cost", "impact_cost",
                           "gross_notional")}}
    rl = event_backtest(price, valid, sc, adv, vol, order_type="limit",
                        fill_key=random.PRNGKey(0))
    out["limit"] = {"n_trades": int(rl.n_trades), "total_pnl": float(rl.total_pnl)}
    p, n, b = threshold_sweep(price, valid, sc, adv, vol, np.asarray(INTRADAY_SWEEP))
    out["sweep"] = {"total_pnl": p.cpu().tolist(), "n_trades": n.cpu().tolist(),
                    "cost_bps": b.cpu().tolist()}
    return out


def mlp_fingerprint(dev) -> dict:
    """``INTRADAY["mlp"]``'s layout from the port's MLP pipeline on the
    golden frame in f64 on ``dev``."""
    import torch

    from csmom_tpu_torch.api import intraday_pipeline

    _, f, *_ = intraday_pipeline(*golden_minute_frame(), model="mlp", device=dev)
    s = torch.nan_to_num(f.scores)
    return {"mlp": {"cv_mse": f.cv_mse.cpu().tolist(), "train_mse": float(f.train_mse),
                    "score_sum": float(s.sum()), "score_abs_sum": float(s.abs().sum())}}


def check_intraday(got: dict) -> None:
    """Hold fingerprints to ``INTRADAY``: integers exact, floats within
    ``INTRADAY_RTOL``; a section ``got`` lacks is not checked."""
    for section, pins in INTRADAY.items():
        if section not in got:
            continue
        for key, want in pins.items():
            have = got[section][key]
            w, h = np.asarray(want), np.asarray(have)
            ok = (np.array_equal(h, w) if w.dtype.kind == "i"
                  else np.allclose(h, w, rtol=INTRADAY_RTOL, atol=0))
            if not ok:
                raise AssertionError(f"intraday {section}.{key}: {have} vs pinned {want}")


def check_event_golden(res, fit, want: dict, what: str) -> None:
    """The EVENT / ONLINE rules: trades and n_train exact, PnL and final
    cash at rtol 1e-9, the CV MSEs at rtol 1e-8."""
    if int(res.n_trades) != want["n_trades"] or int(fit.n_train) != want["n_train"]:
        raise AssertionError(f"{what}: trades {int(res.n_trades)}, n_train "
                             f"{int(fit.n_train)} vs {want}")
    for got, pin, rtol in ((float(res.total_pnl), want["total_pnl"], 1e-9),
                           (float(res.cash[-1]), want["final_cash"], 1e-9)):
        if not np.isclose(got, pin, rtol=rtol, atol=0):
            raise AssertionError(f"{what}: {got} vs pinned {pin}")
    if not np.allclose(fit.cv_mse.cpu().numpy(), want["cv_mse"], rtol=1e-8, atol=0):
        raise AssertionError(f"{what}: cv_mse {fit.cv_mse.tolist()} vs {want['cv_mse']}")


def _result_fields(r):
    import dataclasses

    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(_result_fields(a).values(),
                                                  _result_fields(b).values()))


def _near_threshold(score, th, rel):
    """Cells whose score lies within ``rel`` relative of +-threshold."""
    return ((score - th).abs() <= rel * th) | ((score + th).abs() <= rel * th)


# Phase 9(b)'s f32 error model, first order, computed in f64 from the f64
# run's own data; no f32 result enters a limit.  U32 is f32's unit
# roundoff.  An elementwise operation rounds its result by U32 relative.
# A sum over n rows in an order the library picks (torch.sum, cuBLAS) is
# off by at most LAMBDA sqrt(n) U32 sum|x| (Higham and Mary, SIAM J. Sci.
# Comput. 41(5), 2019, Thm. 3.1: independent rounding errors, failing
# with probability under 2n exp(-LAMBDA^2/2) < 1e-14 here).  A trailing
# window is a difference of two torch.cumsum prefixes.  On the card
# torch scans a row in chunks of 2^(lx+1) (ATen's ScanUtils.cuh,
# tensor_kernel_scan_innermost_dim): a Sklansky tree in the chunk, in
# which element j is the root of adds at most bitlen(j) deep, each level
# summing disjoint parts of the prefix, then the chunk's last prefix
# carried into the next chunk's first element.  A carry shared by both
# ends cancels, so a window's rounding is at most U32 times the prefix of
# |x| at its end, times each end's depth plus (lx + 2) for every chunk
# end between them.
U32 = 2.0 ** -24
LAMBDA = 10.0


def _wsum(x, w):
    """Trailing window sums over rows of ``x [A, R]`` (f64)."""
    from csmom_tpu_torch.ops.rolling import _windowed_prefix_diff

    return _windowed_prefix_diff(x, w)


def _window_err(x, e, w):
    """Error bound of an f32 trailing-window sum of terms ``x`` (exact,
    f64), each off by at most ``e``: the terms' errors plus the prefix
    difference's rounding."""
    import math

    import torch

    rows, size = x.shape
    # the scan's threads a row, as torch picks them: 2^lx, 4 <= lx <= 9
    lx = min(max(4, (9 + math.ceil(math.log2(size)) - math.ceil(math.log2(rows))) // 2), 9)
    chunk = 2 ** (lx + 1)
    t = torch.arange(size, device=x.device)
    lo = (t + 1 - w).clamp(min=0) - 1          # the prefix subtracted; -1: none

    def path(i):                               # adds on prefix i's path
        j = (i % chunk).to(x.dtype)
        bits = torch.where(j > 0, torch.floor(torch.log2(j.clamp(min=1))) + 1, 0.0)
        return torch.where(i >= 0, bits + (i >= chunk).to(x.dtype), 0.0)

    n_round = path(t) + path(lo) + (lx + 2) * (t // chunk - lo.clamp(min=0) // chunk)
    prefix = torch.cumsum(x.abs(), 1)
    return _wsum(e, w) + n_round * U32 * prefix + U32 * _wsum(x, w).abs()


def _sum_err(x_abs_sum, n):
    """Rounding of a library sum of ``n`` terms with ``sum|x|`` given."""
    return LAMBDA * (n ** 0.5) * U32 * x_abs_sum


def feature_error_bound(price, volume, row_valid, window):
    """Per-cell limits ``[A, R, 5]`` on how far ``minute_features`` in f32
    can fall from f64, from the rounding of the f64 run's inputs and of
    each step, in FEATURE_NAMES order; zero off the valid rows, inf where
    the volume z-score's std is not bounded away from its own error."""
    import torch

    u = U32
    inf = torch.tensor(float("inf"), dtype=price.dtype, device=price.device)
    prev = torch.roll(price, 1, 1)
    prev_valid = torch.roll(row_valid, 1, 1)
    prev_valid[:, 0] = False
    ret_valid = row_valid & prev_valid
    q = torch.where(ret_valid, price / torch.where(ret_valid, prev, 1.0), 1.0)
    r1 = torch.where(ret_valid, q - 1.0, 0.0)
    # two rounded inputs and a quotient, then the subtraction of 1
    e_r1 = torch.where(ret_valid, 3.01 * u * q.abs() + u * r1.abs(), 0.0)
    e_r5 = _window_err(r1, e_r1, 5)
    v = torch.where(row_valid, volume, 0.0)
    e_vr = _window_err(v, u * v.abs(), window)
    # the tick rule's sign survives rounding (it is monotone) unless the
    # two prices round to one f32: then it may read 0, off by |v|
    tick = torch.where(ret_valid, torch.sign(price - prev), 0.0)
    tie = ret_valid & (price != prev) & (
        (price - prev).abs() <= 2 * u * torch.maximum(price.abs(), prev.abs()))
    e_sr = _window_err(tick * v, u * (tick * v).abs() + tie * v.abs(), window)

    # z-score against 60-row moments of vol_roll (centred on its row mean:
    # the variance does not see the centre, only the centred values)
    vr = torch.where(row_valid, _wsum(v, window), 0.0)
    e_vr = torch.where(row_valid, e_vr, 0.0)
    n = _wsum(row_valid.to(price.dtype), 60)
    nn = n.clamp(min=1)
    vm = _wsum(vr, 60) / nn
    e_vm = _window_err(vr, e_vr, 60) / nn + u * vm.abs()
    center = vr.sum(1, keepdim=True) / row_valid.sum(1, keepdim=True).clamp(min=1)
    xc = torch.where(row_valid, vr - center, 0.0)
    e_xc = torch.where(row_valid, e_vr + u * xc.abs(), 0.0)
    s1, e_s1 = _wsum(xc, 60), _window_err(xc, e_xc, 60)
    x2 = xc * xc
    s2, e_s2 = _wsum(x2, 60), _window_err(x2, 2 * xc.abs() * e_xc + u * x2, 60)
    num = s2 - s1 * s1 / nn
    e_num = e_s2 + 2 * s1.abs() * e_s1 / nn + 3 * u * s1 * s1 / nn + u * num.abs()
    std_valid = n > 1
    var = (num / (n - 1).clamp(min=1)).clamp(min=0.0)
    e_var = e_num / (n - 1).clamp(min=1) + u * var
    std = var.sqrt()
    e_std = torch.minimum(e_var / (2 * std), e_var.sqrt()) + u * std
    std = torch.where(std_valid, std, 1.0)
    e_std = torch.where(std_valid, e_std, 0.0)
    d = vr - vm
    z = d / std
    e_z = torch.where(e_std < std, (e_vr + e_vm + u * d.abs() + z.abs() * e_std)
                      / (std - e_std) + u * z.abs(), inf)
    e = torch.stack([e_r1, e_r5, e_vr, e_z, e_sr], dim=-1)
    return torch.where(row_valid[..., None], e, 0.0)


def fit_rounding_bound(feats, y, yv, fit, alpha):
    """Limits on the f32 rounding of the ridge harness's final fit and
    scores about the f64 ``fit`` of the same inputs (``feats`` and ``y``
    are f64 copies of f32 values, so exact).  The scaler's mean error
    shifts a column, which the centring and the intercept take back; its
    std error ``rho`` (relative) rescales the column and its coefficient
    the other way, so a score sees neither, only through ``alpha``.  What
    remains is rounding: of the scaled and centred features, the Gram
    matrix and right side, the solve (LU's backward error, first order,
    closed by a Neumann factor), the intercept and the scores.  Returns
    ``(e_coef [F], e_intercept, e_score [A, R])``, ``e_coef`` with the
    rescaling."""
    import torch

    u = U32
    F = feats.shape[-1]
    X = torch.nan_to_num(feats.reshape(-1, F))
    vf = yv.reshape(-1)
    yf = torch.nan_to_num(y.reshape(-1))
    train = vf & (torch.cumsum(vf, 0) - 1 < fit.n_train)
    w = train.to(X.dtype)
    n = float(w.sum())

    mean, std = fit.scale_mean, fit.scale_std
    e_mean = _sum_err(w @ X.abs(), n) / n + u * mean.abs()
    dX = X - mean
    e_var = (w @ (2 * dX.abs() * (e_mean + u * dX.abs()) + u * dX ** 2)
             + _sum_err(w @ dX ** 2, n)) / n + u * std ** 2
    rho = (e_var / (2 * std) + u * std) / std
    Xs = dX / std
    e_r = 2 * u * Xs.abs()                    # the subtraction and the quotient
    xbar = (w @ Xs) / n
    ybar = (w @ yf) / n
    e_xbar = (w @ e_r + _sum_err(w @ Xs.abs(), n)) / n + u * xbar.abs()
    e_ybar = _sum_err(w @ yf.abs(), n) / n + u * ybar.abs()
    Xc = (Xs - xbar) * w[:, None]
    aXc = Xc.abs()
    e_Xc = (e_r + e_xbar + u * (Xs - xbar).abs()) * w[:, None]
    yc = (yf - ybar) * w
    e_yc = (e_ybar + u * (yf - ybar).abs()) * w
    G = Xc.T @ Xc + alpha * torch.eye(F, dtype=X.dtype, device=X.device)
    # the Gram's inputs and sums, then LU's backward error 3F U32 |G|
    # (partial pivoting on this symmetric positive definite matrix)
    e_G = (aXc.T @ e_Xc + e_Xc.T @ aXc + _sum_err(aXc.T @ aXc, n)
           + (1 + 3 * F) * u * G.abs())
    e_b = e_Xc.T @ yc.abs() + aXc.T @ e_yc + _sum_err(aXc.T @ yc.abs(), n)
    coef = fit.coef.abs()
    Gi = torch.linalg.inv(G).abs()
    grow = float(torch.linalg.matrix_norm(Gi @ e_G, ord=float("inf")))
    if grow >= 1:
        raise AssertionError(f"fit_rounding_bound: the perturbation {grow} leaves the "
                             f"Neumann radius; no first-order limit")
    # rounding, and alpha against the rescaled Gram: (G + alpha D^-2)^-1
    e_c = Gi @ (e_b + e_G @ coef + alpha * (2 * rho + rho ** 2) * coef) / (1 - grow)
    r_ic = (F + 1) * u * (ybar.abs() + xbar.abs() @ coef)
    e_ic = (e_ybar + (e_mean / std) @ coef + (1 + rho) * (xbar.abs() + e_mean / std) @ e_c
            + e_xbar @ ((1 + rho) * coef + e_c) + r_ic)
    e_s = ((1 + rho) * (Xs - xbar).abs() @ e_c + (e_r + e_xbar) @ ((1 + rho) * coef + e_c)
           + e_ybar + r_ic + (F + 1) * u * (Xs.abs() @ coef + fit.intercept.abs()))
    return rho * coef + e_c, e_ic, e_s.reshape(yv.shape)


def hold_f32(d32, d64, fit32, window, alpha):
    """Phase 9(b)'s f32 checks, every f32 stage held to its own derived
    limit: the features to f64 within :func:`feature_error_bound`, the
    label within its quotient's rounding, the masks exactly, and the fit
    and scores to the f64 fit of the same f32 features within
    :func:`fit_rounding_bound`.  ``d32`` and ``d64`` hold the compact
    ``price``, ``volume``, ``rv`` and the ``feats``, ``fv``, ``y`` and
    ``yv`` made from them.  Returns the band about the f64 scores ``[A, R]``
    inside which an f32 score must lie: the fit's limit plus the f64
    fit's own response to the f32 features (both fits in f64), and a dict
    of what was held."""
    import torch

    from csmom_tpu_torch.models import ridge_time_series_cv
    from csmom_tpu_torch.signals.intraday import FEATURE_NAMES

    u = U32
    for m in ("fv", "yv"):
        if not torch.equal(d32[m], d64[m]):
            raise AssertionError(f"intraday (b): f32 mask {m} differs from f64")
    fv, yv = d64["fv"], d64["yv"]
    E = feature_error_bound(d64["price"], d64["volume"], d64["rv"], window)
    err = torch.where(fv[..., None], (d32["feats"].double() - d64["feats"]).abs(), 0.0)
    stats = {"feature_err_over_limit": {}}
    for i, name in enumerate(FEATURE_NAMES):
        over = int((err[..., i] > E[..., i]).sum())
        if over:
            raise AssertionError(f"intraday (b): f32 {name} off f64 beyond its derived "
                                 f"limit at {over} cells")
        fin = fv & torch.isfinite(E[..., i]) & (E[..., i] > 0)
        stats["feature_err_over_limit"][name] = float((err[..., i][fin] / E[..., i][fin]).max())
    y64 = torch.nan_to_num(d64["y"])
    e_y = 3.01 * u * (1 + y64).abs() + u * y64.abs()
    if bool(((d32["y"].double() - d64["y"]).abs() > e_y)[yv].any()):
        raise AssertionError("intraday (b): the f32 label is off f64 beyond its rounding")

    X, y = d32["feats"].double(), d32["y"].double()
    star = ridge_time_series_cv(X, y, yv, alpha=alpha)
    if int(fit32.n_train) != int(star.n_train):
        raise AssertionError(f"intraday (b): n_train moved in f32 ({int(fit32.n_train)} vs "
                             f"{int(star.n_train)}): the f32 fit trains on other rows")
    e_coef, e_ic, e_s = fit_rounding_bound(X, y, yv, star, alpha)
    d_coef = (fit32.coef.double() - star.coef).abs()
    d_ic = (fit32.intercept.double() - star.intercept).abs()
    d_s = (fit32.scores.double() - star.scores).abs()[yv]
    if bool((d_coef > e_coef).any()) or bool(d_ic > e_ic) or bool((d_s > e_s[yv]).any()):
        raise AssertionError(f"intraday (b): the f32 fit is off the f64 fit of its own "
                             f"features beyond the rounding limit: coef {d_coef.tolist()} vs "
                             f"{e_coef.tolist()}, intercept {float(d_ic)} vs {float(e_ic)}, "
                             f"scores max {float((d_s / e_s[yv]).max())} of the limit")
    stats.update(coef_err_over_limit=float((d_coef / e_coef).max()),
                 intercept_err_over_limit=float(d_ic / e_ic),
                 score_err_over_limit=float((d_s / e_s[yv]).max()))
    return e_s + (star.scores - d64["fit"].scores).abs(), stats


def intraday_scale(dev, smi):
    """Phase 9(b): an S&P-500-sized universe's month of minute bars
    through ``intraday_pipeline``, f64 on the card against the same call
    on the CPU, f32 against f64 stage by stage, the accounting
    identities, bit-equal latency repeats, and a time for every stage of
    the entry point."""
    import pandas as pd
    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.api import daily_risk_maps, intraday_pipeline, scatter_to_minutes, \
        synthetic_minute_frame
    from csmom_tpu_torch.backtest.event import (
        cost_attribution, event_backtest, hysteresis_event_backtest, threshold_sweep,
    )
    from csmom_tpu_torch.models import (
        elastic_net_time_series_cv, mlp_time_series_cv, ridge_time_series_cv,
    )
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.phases import _trace, time_call
    from csmom_tpu_torch.signals.intraday import (
        compact_minutes, minute_features, next_row_return,
    )

    def L(msg):
        log("intraday", f"(b) {msg} | {smi}")

    n_assets, n_days = INTRADAY_SCALE
    daily = synthetic_daily_panel(n_assets, n_days, seed=7, listing_gaps=True)
    a, t = daily.values.shape
    v = daily.values.T.ravel()
    df = pd.DataFrame({"date": np.repeat(daily.times, a), "ticker": np.tile(daily.tickers, t),
                       "open": v, "close": v, "adj_close": v, "volume": 1e6})
    df = df[np.isfinite(df["close"])].reset_index(drop=True)
    t0 = time.perf_counter()
    minute_df = synthetic_minute_frame(df, seed=5)
    gen_ms = (time.perf_counter() - t0) * 1e3
    compact = compact_minutes(minute_df)
    _, compact_ms = time_call(lambda: compact_minutes(minute_df), reps=3, warmup=0)
    A, R = compact.price.shape
    T = len(compact.times)
    tidx = torch.as_tensor(compact.time_idx).to(dev)
    L(f"{len(minute_df):,} minute rows, compact [{A}, {R}], minute axis {T}; "
      f"host: synthetic frame {gen_ms:.1f} ms (one call), compaction {compact_ms:.1f} "
      f"ms (median of 3)")
    adv_h, vol_h = daily_risk_maps(df, compact.tickers)
    window, alpha, threshold = 30, 1.0, 1e-5

    def entry(device, dtype=None, model="ridge"):
        """``intraday_pipeline`` itself (its own dtype, f64, unless one is
        given), with its panels and risk maps."""
        res, fit, comp, score, price, valid = intraday_pipeline(
            minute_df, df, window_minutes=window, threshold=threshold, cash0=1e6,
            dtype=dtype, model=model, device=device)
        if not (np.array_equal(comp.price, compact.price, equal_nan=True)
                and np.array_equal(comp.time_idx, compact.time_idx)):
            raise AssertionError("intraday (b): the entry point compacts otherwise")
        if price.dtype != (dtype or torch.float64):
            raise AssertionError(f"intraday (b): the entry point ran in {price.dtype}")
        return dict(res=res, fit=fit, score=score, sc=torch.nan_to_num(score), price=price,
                    valid=valid, adv=torch.as_tensor(adv_h, dtype=price.dtype).to(device),
                    vol=torch.as_tensor(vol_h, dtype=price.dtype).to(device))

    def features(dtype):
        """The entry point's first device stages on the card: H2D of the
        compact panels, features, labels."""
        price = torch.as_tensor(compact.price, dtype=dtype).to(dev)
        volume = torch.as_tensor(compact.volume, dtype=dtype).to(dev)
        rv = torch.as_tensor(compact.row_valid).to(dev)
        feats, fv = minute_features(price, volume, rv, window=window)
        y, yv = next_row_return(price, fv)
        return dict(price=price, volume=volume, rv=rv, feats=feats, fv=fv, y=y, yv=yv)

    def extras(d, lat):
        """The engines beyond the plain one, on the entry point's panels."""
        p, va, sc, adv, vol = d["price"], d["valid"], d["sc"], d["adv"], d["vol"]
        out = {"lat": event_backtest(p, va, sc, adv, vol, latency_bars=lat),
               "limit": event_backtest(p, va, sc, adv, vol, order_type="limit",
                                       latency_bars=lat, fill_key=random.PRNGKey(0)),
               "hyst": hysteresis_event_backtest(p, va, sc, adv, vol, threshold_hi=1e-4,
                                                 threshold_lo=2e-5, latency_bars=lat),
               "sweep": threshold_sweep(p, va, sc, adv, vol, np.geomspace(1e-6, 1e-3, 8))}
        out["tca"] = cost_attribution(d["res"], p)
        out["tca_lat"] = cost_attribution(out["lat"], p, latency_bars=lat, valid=va)
        return out

    lat = 2
    cpu = torch.device("cpu")
    g64 = entry(dev)
    x64 = extras(g64, lat)
    c64 = entry(cpu)
    y64 = extras(c64, lat)

    # -- f64 card == f64 CPU ---------------------------------------------
    if not torch.equal(g64["valid"].cpu(), c64["valid"]) or not torch.equal(
            g64["fit"].scores.isnan().cpu(), c64["fit"].scores.isnan()):
        raise AssertionError("intraday (b): the validity masks differ card vs CPU")
    if int(g64["fit"].n_train) != int(c64["fit"].n_train):
        raise AssertionError("intraday (b): n_train differs card vs CPU")
    torch.testing.assert_close(g64["score"].cpu(), c64["score"], rtol=1e-9, atol=1e-15,
                               equal_nan=True, msg="intraday (b): scores card vs CPU")

    def same_engine(label, got, want, score_cpu, ths):
        """Decisions equal but where the CPU score sits within 1e-9
        relative of a +-threshold (printed); with every decision equal, the
        floats agree within 1e-9 relative."""
        diff = got.trade_side.cpu() != want.trade_side
        near = torch.zeros_like(diff)
        for th in ths:
            near |= _near_threshold(score_cpu, th, 1e-9)
        if bool((diff & ~near).any()):
            raise AssertionError(f"intraday (b) {label}: card and CPU decide "
                                 f"{int(diff.sum())} cells apart, away from a threshold")
        if bool(diff.any()):
            L(f"{label}: {int(diff.sum())} decisions differ card vs CPU, each within "
              f"1e-9 of the threshold: {torch.nonzero(diff).tolist()[:10]}")
            return
        for f in ("n_trades", "n_buys", "n_sells"):
            if int(getattr(got, f)) != int(getattr(want, f)):
                raise AssertionError(f"intraday (b) {label}: {f} card vs CPU")
        for f in ("total_pnl", "net_notional", "cash", "portfolio_value"):
            torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f), rtol=1e-9,
                                       atol=1e-6, msg=f"intraday (b) {label}: {f}")

    sc_cpu = c64["sc"]
    same_engine("intraday_pipeline", g64["res"], c64["res"], sc_cpu, (threshold,))
    same_engine(f"latency {lat}", x64["lat"], y64["lat"], sc_cpu, (threshold,))
    same_engine(f"limit latency {lat}", x64["limit"], y64["limit"], sc_cpu, (threshold,))
    same_engine(f"hysteresis latency {lat}", x64["hyst"], y64["hyst"], sc_cpu, (1e-4, 2e-5))
    if not torch.equal(x64["sweep"][1].cpu(), y64["sweep"][1]):
        raise AssertionError("intraday (b): sweep trade counts card vs CPU")
    torch.testing.assert_close(x64["sweep"][0].cpu(), y64["sweep"][0], rtol=1e-9, atol=1e-6)
    for k in ("tca", "tca_lat"):
        for f, val in _result_fields(x64[k]).items():
            torch.testing.assert_close(val.cpu(), getattr(y64[k], f), rtol=1e-9, atol=1e-6,
                                       msg=f"intraday (b): {k}.{f} card vs CPU")
    ge = entry(dev, model="elastic_net")
    ce = entry(cpu, model="elastic_net")
    torch.testing.assert_close(ge["score"].cpu(), ce["score"], rtol=1e-9, atol=1e-15,
                               equal_nan=True)
    same_engine("elastic net intraday_pipeline", ge["res"], ce["res"], ce["sc"], (threshold,))
    L(f"f64 intraday_pipeline, card == CPU: masks, n_train {int(g64['fit'].n_train)}, "
      f"scores (rtol 1e-9), trades {int(g64['res'].n_trades)} / latency {lat} "
      f"{int(x64['lat'].n_trades)} / limit {int(x64['limit'].n_trades)} / hysteresis "
      f"{int(x64['hyst'].n_trades)} / sweep {x64['sweep'][1].tolist()}, elastic net "
      f"trades {int(ge['res'].n_trades)}")
    del c64, y64, ce, ge

    # -- accounting identities and bit-equal repeats on the card ----------
    for label, r in (("event", g64["res"]), ("latency", x64["lat"]), ("limit", x64["limit"]),
                     ("hysteresis", x64["hyst"])):
        if int(r.n_trades) != int(r.n_buys) + int(r.n_sells):
            raise AssertionError(f"intraday (b) {label}: n_trades != buys + sells")
        if not torch.isclose(r.total_pnl, r.pnl.sum(), rtol=1e-12, atol=1e-9):
            raise AssertionError(f"intraday (b) {label}: total_pnl != sum(pnl)")
    if int(x64["hyst"].positions.abs().max()) > 50:
        raise AssertionError("intraday (b): the hysteresis book exceeds one unit")
    for k in ("tca", "tca_lat"):
        c = x64[k]
        legs = c.delay_cost + c.spread_cost + c.impact_cost
        if not torch.isclose(c.total_cost, legs + c.residual, rtol=1e-12, atol=1e-9):
            raise AssertionError(f"intraday (b) {k}: total != delay + spread + impact + residual")
        if float(c.residual.abs()) > 1e-9 * float(c.total_cost.abs()):
            raise AssertionError(f"intraday (b) {k}: market-order residual {float(c.residual)}")
    p, va, sc, adv, vol = (g64[k] for k in ("price", "valid", "sc", "adv", "vol"))
    for label, fn in (
        (f"event latency {lat}", lambda: event_backtest(p, va, sc, adv, vol, latency_bars=lat)),
        (f"limit latency {lat}", lambda: event_backtest(
            p, va, sc, adv, vol, order_type="limit", latency_bars=lat,
            fill_key=random.PRNGKey(0))),
        (f"hysteresis latency {lat}", lambda: hysteresis_event_backtest(
            p, va, sc, adv, vol, threshold_hi=1e-4, threshold_lo=2e-5, latency_bars=lat)),
    ):
        r1, r2 = fn(), fn()
        if not _bit_equal(r1, r2):
            raise AssertionError(f"intraday (b): {label} run twice is not bit-equal")
        c1 = cost_attribution(r1, p, latency_bars=lat, valid=va)
        c2 = cost_attribution(r2, p, latency_bars=lat, valid=va)
        if not _bit_equal(c1, c2):
            raise AssertionError(f"intraday (b): {label} cost attribution not bit-equal")
    L(f"identities hold (trades = buys + sells, total PnL = sum of PnL, total cost = "
      f"delay + spread + impact + residual with residual {float(x64['tca'].residual):.3e} "
      f"of {float(x64['tca'].total_cost):.6f}; hysteresis book within one unit); every "
      f"latency path run twice bit-equal")

    # -- f32 against f64, stage by stage ------------------------------------
    d64, d32 = features(torch.float64), features(torch.float32)
    g32 = entry(dev, torch.float32)
    # the features are the entry point's: its own fit comes back from them
    # (to the reduction order a library may vary from call to call)
    same_fit = {"f64": dict(rtol=1e-12, atol=1e-18), "f32": dict(rtol=1e-5, atol=1e-10)}
    for dt, d, g in (("f64", d64, g64), ("f32", d32, g32)):
        fit = ridge_time_series_cv(d["feats"], d["y"], d["yv"], alpha=alpha)
        torch.testing.assert_close(fit.scores, g["fit"].scores, equal_nan=True, **same_fit[dt],
                                   msg=f"intraday (b): {dt} features are not the entry point's")
    d64["fit"] = g64["fit"]
    band, held = hold_f32(d32, d64, g32["fit"], window, alpha)
    (dense_band,) = scatter_to_minutes(tidx, T, d64["yv"], (band,))[:1]
    s64 = g64["sc"]
    at_risk = ((s64 - threshold).abs() <= dense_band) | ((s64 + threshold).abs() <= dense_band)
    diff = g32["res"].trade_side.to(torch.int32) != g64["res"].trade_side.to(torch.int32)
    if bool((diff & ~at_risk).any()):
        raise AssertionError("intraday (b): an f32 decision differs from f64 outside the "
                             "band of the threshold")
    yv = d64["yv"]
    L(f"f32 vs f64, each stage within its derived limit (largest error / limit): "
      f"{json.dumps(held)}; n_train {int(g32['fit'].n_train)} vs {int(g64['fit'].n_train)}; "
      f"score band median {float(band[yv].median()):.3e}, max {float(band[yv].max()):.3e}; "
      f"{int(at_risk.sum())} decisions lie within the band of +-threshold, "
      f"{int(diff.sum())} differ; trades f32 {int(g32['res'].n_trades)} vs f64 "
      f"{int(g64['res'].n_trades)}, PnL {float(g32['res'].total_pnl):.4f} vs "
      f"{float(g64['res'].total_pnl):.4f}")

    # -- MLP at scale, f64 on the card (the CPU is too slow to hold it) -----
    feats, y = d64["feats"], d64["y"]
    fits = []
    mlp_dev_ms, mlp_ms = time_call(lambda: fits.append(mlp_time_series_cv(feats, y, yv)),
                                   reps=1, warmup=0)
    mfit = fits.pop()
    if int(mfit.n_train) != int(g64["fit"].n_train) or not bool(
            torch.isfinite(mfit.scores[yv]).all()) or not bool(
            (torch.isfinite(mfit.cv_mse) & (mfit.cv_mse > 0)).all()):
        raise AssertionError("intraday (b): the MLP at scale is not finite")
    L(f"MLP f64: one fit (4 x 500 AdamW steps over {int(yv.sum()):,} rows) {mlp_ms:.1f} ms "
      f"host wall, {mlp_dev_ms:.1f} ms CUDA events; cv_mse {mfit.cv_mse.tolist()}")
    del mfit

    # -- the entry point's stages, timed on its own inputs, f64 and f32 -----
    for dtype, d, g in ((torch.float64, d64, g64), (torch.float32, d32, g32)):
        p, va, sc, adv, vol = (g[k] for k in ("price", "valid", "sc", "adv", "vol"))
        stages = {
            "h2d": (lambda: [torch.as_tensor(x, dtype=dtype).to(dev)
                             for x in (compact.price, compact.volume)], {}),
            "features": (lambda: minute_features(d["price"], d["volume"], d["rv"],
                                                 window=window), {}),
            "ridge_fit": (lambda: ridge_time_series_cv(d["feats"], d["y"], d["yv"],
                                                       alpha=alpha), {}),
            "elastic_net_fit": (lambda: elastic_net_time_series_cv(
                d["feats"], d["y"], d["yv"], alpha=1e-8), dict(reps=3, warmup=1)),
            "scatter": (lambda: scatter_to_minutes(tidx, T, d["yv"],
                                                   (g["fit"].scores, d["price"])), {}),
            "event_backtest": (lambda: event_backtest(p, va, sc, adv, vol,
                                                      threshold=threshold), {}),
            "cost_attribution": (lambda: cost_attribution(g["res"], p), {}),
            "hysteresis": (lambda: hysteresis_event_backtest(
                p, va, sc, adv, vol, threshold_hi=1e-4, threshold_lo=2e-5), {}),
            "sweep8": (lambda: threshold_sweep(p, va, sc, adv, vol,
                                               np.geomspace(1e-6, 1e-3, 8)), dict(reps=5)),
            "limit": (lambda: event_backtest(p, va, sc, adv, vol, order_type="limit",
                                             fill_key=random.PRNGKey(0)), {}),
            f"latency{lat}": (lambda: event_backtest(p, va, sc, adv, vol,
                                                    latency_bars=lat), {}),
        }
        times = {}
        for name, (fn, kw) in stages.items():
            d_ms, h_ms = time_call(fn, **kw)
            times[name] = {"device_ms": d_ms, "host_ms": h_ms}
        L(f"{str(dtype)[6:]} stage medians (CUDA events / host, ms; 25 reps unless "
          f"noted: elastic net 3, sweep 5): {json.dumps(times)}")

    adv32, vol32 = g32["adv"], g32["vol"]

    def device_part():
        """The entry point's device work after compaction, f32, for the trace."""
        d = features(torch.float32)
        fit = ridge_time_series_cv(d["feats"], d["y"], d["yv"], alpha=alpha)
        score, price, valid = scatter_to_minutes(tidx, T, d["yv"], (fit.scores, d["price"]))
        return fit, event_backtest(price, valid, torch.nan_to_num(score), adv32, vol32,
                                   threshold=threshold)

    fit_p, _ = device_part()
    torch.testing.assert_close(fit_p.scores, g32["fit"].scores, equal_nan=True,
                               **same_fit["f32"],
                               msg="intraday (b): the traced device part is not the entry point's")
    whole = _trace(lambda: intraday_pipeline(minute_df, df, dtype=torch.float32,
                                             device=dev), warm=False)
    part = _trace(device_part)
    L(f"trace f32: intraday_pipeline whole call (host compaction included) {json.dumps(whole)}; "
      f"its device part (H2D -> features -> ridge -> scatter -> engine, its fit the "
      f"call's) {json.dumps(part)}")


def ridge_kernel_scale(dev, smi, bw) -> dict:
    """Phase 9(e): K4 at the intraday cell's shape (the quarter of minute
    bars of ``workloads.NORTH_STAR_MINUTES``, 500 names x 60 days,
    compacted, f64, the demo's 3 folds and alpha 1): against its plain
    version on the same card within the f64 limits of
    ``tests/test_torch_ridge_kernel.py`` (1e-12 of each quantity's scale,
    times kappa = 1 + max |m| / s), two calls bit-equal, one launch a call
    over every row; then its kernels' device time (L2 flushed) against the
    byte bound of its two passes (the moments pass reads the features, the
    label and the validity, the score pass the features and the validity
    and writes the scores, each once), with the plain version's and the
    masked-pass harness's time on the same inputs.  Returns the numbers."""
    import torch

    from csmom_tpu_torch.models.ridge import _masked_ridge, time_series_cv_harness
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.phases import time_call, time_kernels
    from csmom_tpu_torch.signals.intraday import minute_features, next_row_return
    from csmom_tpu_torch.workloads import NORTH_STAR_MINUTES, minute_panels

    price, volume, rv, *_ = minute_panels(*NORTH_STAR_MINUTES, device=dev)
    feats, fv = minute_features(price, volume, rv, window=30)
    y, yv = next_row_return(price, fv)
    del price, volume, rv, fv
    A, R, F = feats.shape
    N, s = A * R, feats.element_size()
    args = (feats, y, yv)

    def k4():
        return kernels.ridge_moments(*args)

    def plain():
        return kernels.ridge_moments_plain(*args, 3, 1.0, 0.7, 0.6, 100)

    def harness():
        return time_series_cv_harness(
            *args, solver=lambda Xs, yf, w: _masked_ridge(Xs, yf, w, 1.0), n_splits=3,
            train_frac=0.7, train_frac_small=0.6, small_threshold=100)

    kernels.reset_launches()
    got, again = k4(), k4()
    torch.cuda.synchronize()
    if kernels.ridge_moments.launches != 2 or kernels.ridge_moments.rows != 2 * N:
        raise AssertionError(f"intraday (e): K4 counted {kernels.ridge_moments.launches} "
                             f"launches over {kernels.ridge_moments.rows} rows in two calls")
    for a, b in zip(got, again):
        if not torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                           b.view(torch.int64) if b.dtype == torch.float64 else b):
            raise AssertionError("intraday (e): two K4 calls are not bit-equal")
    want = plain()
    coef, icept, m, sd, cv, scores, n_train = (t.double() for t in got)
    wc, wi, wm, ws, wcv, wsc, wn = (t.double() for t in want)
    kappa = 1 + float((wm.abs() / ws).max())
    lever = float((wm.abs() / ws * wc.abs()).sum())
    scale = max(float(wc.abs().max()), abs(float(wi)))
    ok = yv
    rms = float(wsc[ok].pow(2).mean().sqrt())
    gaps = {"coef": float((coef - wc).abs().max()) / scale,
            "intercept": abs(float(icept - wi)) / (scale + lever),
            "cv_mse": float(((cv - wcv).abs() / wcv.abs()).max()),
            "scores": float((scores[ok] - wsc[ok]).abs().max()) / (rms + lever)}
    if int(n_train) != int(wn) or not torch.equal(scores.isnan(), wsc.isnan()) \
            or max(gaps.values()) > 1e-12 * kappa:
        raise AssertionError(f"intraday (e): K4 off its plain version: n_train "
                             f"{int(n_train)} vs {int(wn)}, gaps {gaps}, kappa {kappa}")
    hp, _, _, hcv, hsc, *_ = harness()
    harness_gap = max(float((hp[0] - wc).abs().max()) / scale,
                      float(((hcv - wcv).abs() / wcv.abs()).max()),
                      float((hsc[ok] - wsc[ok]).abs().max()) / (rms + lever))
    del want, hp, hcv, hsc

    moments_bytes = N * (F * s + s + 1)
    score_bytes = N * (F * s + 1) + N * s
    bound_ms = (moments_bytes + score_bytes) / bw * 1e3
    device_ms, per_call, by_kernel = time_kernels(k4, kernels.ridge_moments.device_kernels,
                                                  split=True)
    call_ms = time_call(k4, cold=True)[0]
    plain_ms = time_call(plain, reps=5, warmup=1)[0]
    harness_ms = time_call(harness, reps=5, warmup=1)[0]
    out = {"shape": [A, R, F], "n_train": int(n_train), "kappa": kappa, "gaps": gaps,
           "harness_gap": harness_gap, "bytes": moments_bytes + score_bytes,
           "bound_ms": bound_ms, "device_ms": device_ms, "kernels_per_call": per_call,
           "by_kernel": by_kernel, "call_ms": call_ms, "bound_share": bound_ms / device_ms,
           "plain_ms": plain_ms, "harness_ms": harness_ms}
    log("intraday", f"(e) K4 ridge_moments at [{A}, {R}, {F}] f64: equal to its plain "
                    f"version (gaps {json.dumps(gaps)}, kappa {kappa:.3g}; the harness "
                    f"{harness_gap:.3e}), two calls bit-equal; device {device_ms:.4f} ms "
                    f"in {per_call} kernels {json.dumps(by_kernel)}, bound {bound_ms:.4f} "
                    f"ms ({(moments_bytes + score_bytes) / 1e6:.1f} MB, share "
                    f"{bound_ms / device_ms:.3f}); call {call_ms:.4f} ms; plain "
                    f"{plain_ms:.3f} ms; harness {harness_ms:.3f} ms | {smi}")
    return out


def write_cli_cache(out_dir: str):
    """Phase 9(d)'s cache in the reference's naming: ``<T>_daily.csv``
    (CLI_CACHE[1] days) and ``<T>_intraday.csv`` (the last CLI_CACHE[2]
    days' minutes, 2% of them missing) for CLI_CACHE[0] tickers."""
    import pandas as pd

    from csmom_tpu_torch.api import synthetic_minute_frame
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    n, days, mdays = CLI_CACHE
    daily = synthetic_daily_panel(n, days, seed=3)
    tickers = [f"TK{i:02d}" for i in range(n)]
    stamps = pd.DatetimeIndex(daily.times)
    for i, tk in enumerate(tickers):
        v = daily.values[i]
        pd.DataFrame({"date": stamps.strftime("%Y-%m-%d"), "open": v * 0.998, "high": v,
                      "low": v * 0.995, "close": v, "adj_close": v,
                      "volume": 1e6 + 1e4 * (np.arange(days) % 17)}).to_csv(
            os.path.join(out_dir, f"{tk}_daily.csv"), index=False)
    last = pd.DataFrame({"date": np.repeat(daily.times[-mdays:], n),
                         "ticker": np.tile(tickers, mdays),
                         "open": daily.values[:, -mdays:].T.ravel() * 0.998,
                         "close": daily.values[:, -mdays:].T.ravel(), "volume": 1e6})
    minutes = synthetic_minute_frame(last, seed=9)
    minutes = minutes[np.random.default_rng(9).random(len(minutes)) > 0.02]
    for tk, g in minutes.groupby("ticker"):
        pd.DataFrame({"datetime": g["datetime"].dt.strftime("%Y-%m-%d %H:%M:%S"),
                      "open": g["price"], "high": g["price"], "low": g["price"],
                      "close": g["price"], "volume": g["volume"]}).to_csv(
            os.path.join(out_dir, f"{tk}_intraday.csv"), index=False)
    return tickers


def intraday_cli(dev, smi, cache, tickers, out_dir):
    """Phase 9(c) and (d): online ridge at the cache's reference shape, then
    the CLI's ``intraday`` and ``run`` on the cache with ``--device cuda``,
    each command's numbers and trade log held to the API's own."""
    import contextlib
    import io

    import pandas as pd
    import torch

    from csmom_tpu_torch.analytics.plots import save_trades_csv
    from csmom_tpu_torch.api import daily_risk_maps, intraday_pipeline, scatter_to_minutes
    from csmom_tpu_torch.backtest.event import event_backtest, trades_dataframe
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.config import RunConfig
    from csmom_tpu_torch.models import online_ridge_scores
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.panel.ingest import load_daily, load_intraday
    from csmom_tpu_torch.phases import _trace
    from csmom_tpu_torch.signals.intraday import (
        compact_minutes, minute_features, next_row_return,
    )

    minute_df = load_intraday(cache, tickers)
    daily_df = load_daily(cache, tickers)
    compact = compact_minutes(minute_df)
    A, R = compact.price.shape
    icfg = RunConfig().intraday

    # -- (c) online ridge at the reference's shape (f64, whose walk (d)
    # reuses) and on its first F32_WALK_ROWS rows in f32 (the walk's time
    # is linear in its rows: a + b*R launches) -------------------------
    walls = {}
    for dtype in (torch.float64, torch.float32):
        price = torch.as_tensor(compact.price, dtype=dtype).to(dev)
        volume = torch.as_tensor(compact.volume, dtype=dtype).to(dev)
        feats, fv = minute_features(price, volume, torch.as_tensor(compact.row_valid).to(dev),
                                    window=icfg.window_minutes)
        y, yv = next_row_return(price, fv)
        rows = R if dtype == torch.float64 else min(R, F32_WALK_ROWS)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        walk = online_ridge_scores(feats[:, :rows], y[:, :rows], yv[:, :rows],
                                   n_splits=icfg.n_splits, alpha=icfg.alpha)
        end.record()
        torch.cuda.synchronize()
        walls[str(dtype)[6:]] = {"rows": rows,
                                 "host_ms": (time.perf_counter() - t0) * 1e3,
                                 "device_ms": start.elapsed_time(end)}
        if dtype == torch.float64:
            # the CLI's own online-ridge walk: (d) finishes the pipeline
            # from it rather than walking the same inputs again
            walk64 = (walk, price, yv)
            # the walk is a fixed Python loop, so its launches are a + b*R:
            # profile two row counts and read a and b off them exactly
            traces = {r: _trace(lambda r=r: online_ridge_scores(
                feats[:, :r], y[:, :r], yv[:, :r]), warm=False) for r in (20, 40)}
            per_row = (traces[40]["device_activities"] - traces[20]["device_activities"]) / 20
            fixed = traces[20]["device_activities"] - 20 * per_row
    launches = fixed + per_row * R
    log("intraday", f"(c) online_ridge_scores at [{A}, {R}] in f64 and its first "
                    f"{min(R, F32_WALK_ROWS)} rows in f32 (one call each): "
                    f"{json.dumps(walls)}; launches {launches:.0f} = {fixed:.0f} + "
                    f"{per_row:.0f} a row (profiled at 20 and 40 rows: "
                    f"{json.dumps(traces)}) | {smi}")

    # -- (d) the CLI --------------------------------------------------------
    walk, price, yv = walk64
    score, dprice, dvalid = scatter_to_minutes(torch.as_tensor(compact.time_idx).to(dev),
                                               len(compact.times), yv, (walk.scores, price))
    adv, vol = (torch.as_tensor(x, dtype=torch.float64).to(dev)
                for x in daily_risk_maps(daily_df, compact.tickers))
    res = event_backtest(dprice, dvalid, torch.nan_to_num(score), adv, vol,
                         size_shares=icfg.size_shares, threshold=icfg.threshold,
                         cash0=icfg.cash0)
    results = {("online_ridge", 0): (res, walk, compact, score, dprice, dvalid)}

    def api(model, lat=0):
        key = (model, lat)
        if key not in results:
            alpha = icfg.alpha if model in ("ridge", "online_ridge") else None
            results[key] = intraday_pipeline(
                minute_df, daily_df, window_minutes=icfg.window_minutes,
                n_splits=icfg.n_splits, alpha=alpha, size_shares=icfg.size_shares,
                threshold=icfg.threshold, cash0=icfg.cash0, model=model,
                latency_bars=lat, device=dev)
        return results[key]

    common = ["--data-dir", cache, "--tickers", ",".join(tickers), "--device", "cuda",
              "--out", out_dir]
    totals = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    for label, argv, model, lat, k1 in (
        [(f"intraday --model {m}", ["intraday", "--model", m], m, 0, 0)
         for m in ("ridge", "online_ridge", "elastic_net", "lasso", "mlp")]
        + [("intraday sweep/hysteresis/latency 2/tearsheet",
            ["intraday", "--threshold-sweep", "1e-6,1e-5,1e-4", "--threshold-hi", "1e-4",
             "--threshold-lo", "2e-5", "--latency-bars", "2", "--tearsheet"], "ridge", 2, 0),
           ("intraday --parity", ["intraday", "--parity"], "ridge", 0, 0),
           ("run", ["run"], "ridge", 0, 1)]):
        buf = io.StringIO()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv + common)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {"decile_partial_sums": kernels.decile_partial_sums.launches,
               "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        out = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"intraday cli {label}: exit {rc}\n{out}")
        if got != {"decile_partial_sums": k1, "cohort_partial_sums": 0}:
            raise AssertionError(f"intraday cli {label}: launches {got}, expected K1 {k1}")
        for name, n in got.items():
            totals[name] += n
        res, fit, comp, score, *_ = api(model, lat)
        for line in (f"CV MSEs:     {[f'{m:.3g}' for m in fit.cv_mse.cpu().numpy()]}",
                     f"Trades:      {int(res.n_trades)} ({int(res.n_buys)} buys / "
                     f"{int(res.n_sells)} sells)",
                     f"Total PnL:   ${float(res.total_pnl):,.2f}"):
            if line not in out.splitlines():
                raise AssertionError(f"intraday cli {label}: {line!r} not in\n{out}")
        ref_dir = os.path.join(out_dir, "api")
        want = pd.read_csv(save_trades_csv(trades_dataframe(
            res, comp.tickers, comp.times, score, size_shares=icfg.size_shares), ref_dir))
        have = pd.read_csv(os.path.join(out_dir, "trades.csv"))
        pd.testing.assert_frame_equal(have, want, check_exact=True)
        log("intraday", f"(d) cli {label}: exit 0, {ms:.2f} ms host wall, launches {got}, "
                        f"CV MSEs / trades / PnL and trades.csv ({len(have)} rows) equal "
                        f"the API's | {smi}")
    return totals


def intraday_phase(dev, smi, bw) -> dict:
    """Phase 9: the intraday leg on the card, with K4 at the intraday
    cell's shape (e).  Returns the phase's launch counts of K1 and K2
    (only ``run``'s replicate leg launches one: K1)."""
    import torch

    from csmom_tpu_torch.api import intraday_pipeline
    from csmom_tpu_torch.ops import kernels

    kernels.reset_launches()
    # -- (a) goldens in f64 --------------------------------------------------
    t0 = time.perf_counter()
    minute_df, df = golden_minute_frame()
    if len(minute_df) != 31_200:
        raise AssertionError(f"intraday (a): golden frame has {len(minute_df)} rows")
    res, fit, *_ = intraday_pipeline(minute_df, df, device=dev)
    check_event_golden(res, fit, EVENT, "intraday (a) EVENT")
    t1 = time.perf_counter()
    res, fit, *_ = intraday_pipeline(minute_df, df, model="online_ridge", device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_event_golden(res, fit, ONLINE, "intraday (a) ONLINE")
    fp = {**intraday_fingerprints(dev), **mlp_fingerprint(dev)}
    check_intraday(fp)
    t3 = time.perf_counter()
    log("intraday", f"(a) f64 goldens on the card: EVENT (trades {EVENT['n_trades']}) "
                    f"{(t1 - t0) * 1e3:.1f} ms, ONLINE (trades {ONLINE['n_trades']}) "
                    f"{(t2 - t1) * 1e3:.1f} ms, INTRADAY pins (elastic net, lasso, MLP, "
                    f"hysteresis, latency 3 + TCA, limit, sweep) {(t3 - t2) * 1e3:.1f} ms "
                    f"host walls | {smi}")
    log("intraday", f"(a) {json.dumps(fp)} | {smi}")

    # -- (b) at scale ------------------------------------------------------
    intraday_scale(dev, smi)
    launched = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if any(launched.values()):
        raise AssertionError(f"intraday (a)-(b) launched a kernel: {launched}")
    if not kernels.ridge_moments.launches:
        raise AssertionError("intraday (a)-(b): no ridge fit went through K4")
    # -- (e) K4 at the intraday cell's shape --------------------------------
    ridge_kernel_scale(dev, smi, bw)

    # -- (c) and (d) on a CSV cache of the reference's shape ---------------
    with tempfile.TemporaryDirectory(prefix="csmom_intraday_") as tmp:
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        tickers = write_cli_cache(cache)
        return intraday_cli(dev, smi, cache, tickers, os.path.join(tmp, "results"))


# phase 11: the in-process serving tier on the card.  Profile "serve":
# 60-month histories, universes padded to 32 or 128 names, micro-batches
# padded to 1, 4 or 8 requests, f32 (the JAX package's production grid)
SERVE_SHAPES = ((1, 32), (1, 128), (4, 32), (4, 128), (8, 32), (8, 128))
SERVE_MONTHS = 60
# the card's f32 scores against the CPU's: the same algorithm in f32 on
# both, differing only in the order of their reductions (K1's sums over
# at most 128 assets, cumulative sums over 60 months, z-score moments
# over 128 assets).  Each reordered sum moves by at most n u sum|x| with
# u = 6e-8 and n <= 128, under 1e-5 of its magnitude; the scores divide
# such sums (means, ratios of a mean to a standard deviation), which at
# worst doubles the relative error.  1e-4 relative leaves a factor of 5
# over that; 1e-6 absolute covers a score that cancels to ~0 (a spread
# or a z-score of a nearly flat cross-section), whose error is relative
# to the magnitudes summed, not to the result.  The same limit as the
# CPU tests hold the port to the JAX package in f32.
SERVE_F32 = dict(rtol=1e-4, atol=1e-6)
# the service runs: the CLI's default schedule and the named bursty one
# (73 and 240 arrivals, where the nearest-rank p99 is the run's worst
# request or close to it), and 5 s at a steady 200 req/s with the
# default load (1,000 arrivals), long enough for p99 to be a percentile
SERVE_SCHEDULES = ("2x40", "bursty", "5x200")


def serve_batch(rng, kind, B, A, dtype):
    """A padded micro-batch as the batcher builds it: ``max(1, B-1)``
    requests of the loadgen's synthetic panels (a padded row wherever B >
    1), the first with ``A - 3`` assets and the others 2..A, the rest of
    every row masked padding.  Returns ``(values, mask, sizes)``."""
    import random as pyrandom

    from csmom_tpu_torch.serve.loadgen import synth_panel

    r = pyrandom.Random(int(rng.integers(2**31)))
    values = np.zeros((B, A, SERVE_MONTHS), dtype)
    mask = np.zeros((B, A, SERVE_MONTHS), bool)
    sizes = []
    for b in range(max(1, B - 1)):
        n = A - 3 if b == 0 else r.randint(2, A)
        v, m = synth_panel(r, n, SERVE_MONTHS, kind)
        values[b, :n], mask[b, :n] = v, m
        sizes.append(n)
    return values, mask, sizes


def hold_scores(got, want, what, f64):
    """NaN in the same places, the rest within F64_TOL or SERVE_F32."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{what}: NaN in different places")
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], err_msg=what,
                               **(F64_TOL if f64 else SERVE_F32))
    return float(np.abs(got[ok] - want[ok]).max()) if ok.any() else 0.0


def k1_inputs_of(engine, values, mask):
    """The ``(ret, labels, n_bins)`` that the ``backtest`` endpoint passes
    to K1 when ``engine`` scores this micro-batch, captured where
    backtest/monthly.py calls the wrapper (the endpoint makes exactly one
    K1 call a batch).  The ``kernels`` module itself is left as it is:
    the wrapper counts its launches through its own module-level name."""
    from csmom_tpu_torch.backtest import monthly
    from csmom_tpu_torch.ops import kernels

    seen = []

    class Capture:
        def __getattr__(self, name):
            return getattr(kernels, name)

        @staticmethod
        def decile_partial_sums(ret, labels, n_bins):
            seen.append((ret.clone(), labels.clone(), n_bins))
            return kernels.decile_partial_sums(ret, labels, n_bins)

    monthly.kernels = Capture()
    try:
        engine.score("backtest", values, mask)
    finally:
        monthly.kernels = kernels
    if len(seen) != 1:
        raise AssertionError(f"serve backtest: {len(seen)} K1 calls in one batch")
    return seen[0]


def serve_metrics(art) -> dict:
    """A serve artifact's headline under the JAX ledger's names:
    throughput, p99 and each class's p99 of total latency."""
    out = {"serve_throughput_rps": art["value"],
           "serve_p99_ms": art["latency_ms"]["total"]["p99"]}
    for name, book in art["classes"].items():
        out[f"serve_{name}_p99_ms"] = book["latency_ms"]["p99"]
    return out


def serve_phase(smi, out_dir, assert_sums, bound) -> dict:
    """Phase 11: the serving tier on the card.  Returns the service runs'
    launch counts, their total-latency percentiles by schedule (phase 15
    runs ``bursty`` traced) and K1's time and bound at the serve shape."""
    import contextlib
    import io

    import torch

    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.phases import REPS, _trace, time_call, time_kernels
    from csmom_tpu_torch.registry import serve_endpoints, serve_surface
    from csmom_tpu_torch.serve.engine import TorchEngine, unpack_result
    from csmom_tpu_torch.serve.loadgen import LoadConfig, resolve_schedule, run_loadgen
    from csmom_tpu_torch.serve.queue import Request
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    rng = np.random.default_rng(20261017)
    kinds = serve_endpoints()
    card, host = TorchEngine(device="cuda"), TorchEngine(device="cpu")

    # -- (a) engine parity on the card ---------------------------------------
    errs = {}
    for kind in kinds:
        for B, A in SERVE_SHAPES:
            for dtype in (np.float64, np.float32):
                v, m, _ = serve_batch(rng, kind, B, A, dtype)
                kernels.reset_launches()
                got = card.score(kind, v, m)
                k1 = kernels.decile_partial_sums.launches
                k3 = kernels.rank_labels.launches
                want = 1 if kind == "backtest" else 0
                if k1 != want or k3 != want or kernels.cohort_partial_sums.launches:
                    raise AssertionError(f"serve {kind} B={B} A={A}: K1 launched "
                                         f"{k1} times and K3 {k3}, expected {want}")
                what = f"serve {kind} B={B} A={A} {np.dtype(dtype).name}"
                err = hold_scores(got, host.score(kind, v, m), what,
                                  dtype == np.float64)
                key = f"{kind}_{np.dtype(dtype).name}"
                errs[key] = max(errs.get(key, 0.0), err)
    # K1 on the folded batch against its plain version
    for B, A in SERVE_SHAPES:
        for dtype in (np.float64, np.float32):
            v, m, _ = serve_batch(rng, "backtest", B, A, dtype)
            r, lab, n_bins = k1_inputs_of(card, v, m)
            if tuple(r.shape) != (A, B * SERVE_MONTHS) or n_bins != 10:
                raise AssertionError(f"serve K1 inputs {tuple(r.shape)}, {n_bins} bins")
            s, c = kernels.decile_partial_sums(r, lab, 10)
            ps, pc = kernels.decile_partial_sums_plain(r, lab, 10)
            absum, _ = kernels.decile_partial_sums_plain(r.abs(), lab, 10)
            torch.cuda.synchronize()
            if not torch.equal(c, pc):
                raise AssertionError(f"serve K1 [{A}, {B * SERVE_MONTHS}]: counts differ")
            assert_sums(s, ps, absum, r.dtype, f"serve K1 [{A}, {B * SERVE_MONTHS}]")
    # one request alone equals the same request inside a full batch
    for kind in kinds:
        v, m, sizes = serve_batch(rng, kind, 8, 128, np.float32)
        full = card.score(kind, v, m)
        for b in (0, 3):
            A1 = 32 if sizes[b] <= 32 else 128
            alone = card.score(kind, v[b:b + 1, :A1], m[b:b + 1, :A1])
            n = sizes[b]
            want = full[b] if serve_surface(kind).output == "summary" else full[b, :n]
            got = alone[0] if serve_surface(kind).output == "summary" else alone[0, :n]
            hold_scores(got, want, f"serve {kind}: request {b} alone vs in a batch of 8",
                        False)
    log("serve", f"(a) 5 endpoints x 6 shapes: card == CPU (f64 within {F64_TOL}, "
                 f"f32 within {SERVE_F32}, NaN in the same places); max |err| "
                 f"{json.dumps(errs)}; K1 == plain on every folded [A, B*60] in both "
                 f"types; backtest launches K1 once a micro-batch at every B; a "
                 f"request alone == the same request in a batch of 8")

    # per-endpoint micro-batch times at B in {1, 8}, A = 128, f32
    for kind in kinds:
        for B in (1, 8):
            v, m, _ = serve_batch(rng, kind, B, 128, np.float32)
            kernels.reset_launches()
            card.score(kind, v, m)
            k1 = kernels.decile_partial_sums.launches
            d_ms, h_ms = time_call(lambda: card.score(kind, v, m))
            log("serve", f"time {kind} B={B} A=128: {d_ms:.4f} ms CUDA events, host "
                         f"{h_ms:.4f} ms (median of {REPS}; H2D + scorer + D2H), K1 "
                         f"launches a call {k1} | {smi}")
    for kind in ("backtest", "momentum"):
        v, m, _ = serve_batch(rng, kind, 8, 128, np.float32)
        tr = _trace(lambda: card.score(kind, v, m))
        log("serve", f"trace {kind} B=8 A=128: {json.dumps(tr)} | {smi}")

    # -- (d) K1 at the serve shape: a full B = 8, A = 128 micro-batch, and
    # at a B = 1 batch's [128, 60] (each batch shard's shape under phase
    # 18's 8-way batch split); timed before the service runs: after (b)'s
    # ~500k launches the profiler lost one K1 record in each of three
    # traces on an H100 (and again after phase 18's service runs)
    k1_at = {}
    for B in (1, 8):
        v, m, _ = serve_batch(rng, "backtest", B, 128, np.float32)
        k1_ret, k1_lab, _ = k1_inputs_of(card, v, m)
        k1_shape = list(k1_ret.shape)
        nbytes = (k1_lab.nbytes + k1_ret.nbytes
                  + 2 * 10 * k1_shape[1] * k1_ret.element_size())
        ops = 2 * int(((k1_lab >= 0) & (k1_lab < 10)).sum())
        b_ms, b_by = bound(nbytes, ops)
        d_ms, per_call = time_kernels(
            lambda: kernels.decile_partial_sums(k1_ret, k1_lab, 10),
            kernels.decile_partial_sums.device_kernels)
        k1_at[str(k1_shape)] = {"device_ms": d_ms, "bound_ms": b_ms, "bound_by": b_by}
        log("serve", f"(d) K1 at the serve shape {k1_shape}, 10 bins, f32: device "
                     f"{d_ms:.6f} ms, bound {b_ms:.6f} ms by {b_by} ({nbytes} bytes, "
                     f"{ops} ops), kernels a call {per_call} | {smi}")

    # -- (b) the service on the card, the main path ------------------------
    # telemetry disarmed, as the CLI's loadgen runs it
    launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    total_ms = {}   # each schedule's total-latency percentiles
    cells = {}      # each schedule's headline metrics (the JAX ledger's names)
    for sched in SERVE_SCHEDULES:
        schedule, schedule_kind, preset = resolve_schedule(sched)
        # the main path: counts from 0 at the service's start (its
        # warm-up included) to the end of the load generator's run
        kernels.reset_launches()
        svc = SignalService(ServeConfig(profile="serve", engine="torch"))
        svc.start()
        submitted = []
        submit = svc.submit

        def recording_submit(*a, **kw):
            req = submit(*a, **kw)
            submitted.append(req)
            return req

        svc.submit = recording_submit
        torch.cuda.synchronize()
        seg0 = torch.cuda.memory_stats()["segment.all.current"]
        res0 = torch.cuda.memory_stats()["reserved_bytes.all.current"]
        art = run_loadgen(svc, LoadConfig(schedule=schedule,
                                          schedule_kind=schedule_kind, seed=0,
                                          run_id=f"chip-{sched}", **preset))
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        run_launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                        "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        for name, n in run_launches.items():
            launches[name] += n
        if svc.invariant_violations():
            raise AssertionError(f"serve {sched}: {svc.invariant_violations()}")
        if art["compile"]["in_window_fresh_compiles"] != 0:
            raise AssertionError(f"serve {sched}: fresh compiles "
                                 f"{art['compile']['in_window_fresh_compiles']}")
        crashes = svc.accounting()["rejected_worker_crash"]
        if art["requests"]["rejected_worker_crash"] or crashes:
            raise AssertionError(f"serve {sched}: worker crashes "
                                 f"{art['requests']['rejected_worker_crash']} "
                                 f"({crashes}): " + "; ".join(
                                     {str(r.error) for r in submitted
                                      if r.state == "rejected"}))
        viols = inv.validate(art)
        if viols:
            raise AssertionError(f"serve {sched}: artifact invalid: {viols}")
        # every served result against the engine scoring it alone
        n_held = 0
        for r in submitted:
            if r.state != "served":
                continue
            req = Request(kind=r.kind, values=r.values, mask=r.mask,
                          n_assets=r.n_assets)
            mb = svc.batcher.pad([req])
            alone = unpack_result(r.kind, svc.engine.score(r.kind, mb.values,
                                                           mb.mask), 0, r.n_assets)
            if isinstance(alone, dict):
                hold_scores(np.array(list(r.result.values())),
                            np.array(list(alone.values())),
                            f"serve {sched}: a served backtest", False)
            else:
                hold_scores(np.asarray(r.result), alone,
                            f"serve {sched}: a served {r.kind}", False)
            n_held += 1
        lat = art["latency_ms"]
        total_ms[sched] = lat["total"]
        cells[sched] = serve_metrics(art)
        log("serve", f"(b) {sched}: {art['value']} req/s achieved vs "
                     f"{art['offered']['offered_rps']} offered over {art['wall_s']} s; "
                     f"requests {json.dumps(art['requests'])}; invariants closed, "
                     f"0 fresh compiles, 0 worker crashes, artifact valid; "
                     f"{n_held} served results == the engine alone; launches "
                     f"{run_launches} | {smi}")
        log("serve", f"(b) {sched} latency ms {json.dumps(lat)}; per class " + json.dumps(
            {k: {"p50": b["latency_ms"]["p50"], "p95": b["latency_ms"]["p95"],
                 "p99": b["latency_ms"]["p99"], "budget_ms": b["budget_ms"],
                 "served": b["served"], "rejected_quota": b["rejected_quota"]}
             for k, b in art["classes"].items()}) + "; per endpoint " + json.dumps(
            {k: dict(b["latency_ms"], served=b["served"])
             for k, b in art["endpoints"].items()}))
        log("serve", f"(b) {sched} batches {json.dumps(art['batches'])}; cache hit "
                     f"rate {art['cache']['hit_rate']} ({art['cache']['hits']} of "
                     f"{art['cache']['lookups']}), stale hits "
                     f"{art['cache']['stale_hits']}; allocator over the serving "
                     f"window: segments {seg0} -> {st['segment.all.current']}, "
                     f"reserved bytes {res0} -> {st['reserved_bytes.all.current']}")
    if launches["decile_partial_sums"] < 1 or launches["cohort_partial_sums"]:
        raise AssertionError(f"serve: launches {launches}, expected K1 > 0, K2 0")

    # -- (c) the CLI ------------------------------------------------------------
    walls = {}
    for label, argv, want in (
            ("serve", ["serve", "--duration", "1", "--device", "cuda"],
             "self-probe: all endpoints served"),
            ("loadgen", ["loadgen", "--device", "cuda", "--out", out_dir,
                         "--run-id", "chip-smoke"], "artifact: ")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        walls[label] = time.perf_counter() - t0
        if rc != 0 or want not in buf.getvalue():
            raise AssertionError(f"serve cli {label}: exit {rc}\n{buf.getvalue()}")
        log("serve", f"(c) {' '.join(argv)}: exit 0 in {walls[label]:.2f} s host wall; "
                     + " / ".join(ln.strip() for ln in buf.getvalue().splitlines()
                                  if ln.startswith(("throughput", "latency", "  self-probe",
                                                    "in-window"))) + f" | {smi}")

    return {"launches": launches, "latency_ms": total_ms, "cells": cells,
            "k1_at": k1_at, "serve_shape": k1_shape,
            "serve_device_ms": d_ms, "serve_bound_ms": b_ms, "serve_bound_by": b_by}


# phase 12: the multi-process serving pool on the card.  Three workers
# (the JAX package's SERVE_POOL_r11.json fleet) share the one card, each
# a SignalService with a TorchEngine of its own, behind the hedging
# router in this process; profile "serve" as in phase 11
POOL_WORKERS = 3
# the reference's pool cell, SERVE_POOL_r11.json's configuration: its
# seed, its three endpoints, 70% interactive, 500 ms deadlines, hedging at
# 0.35 of the budget, w0 SIGKILLed 2 s in; its schedule's 26 s tail at
# 15 req/s cut to 6 s (the kill, the failover and the respawn all fall
# inside the first 10 s)
POOL_R11 = dict(schedule="2x30,2x60,6x15", seed=11,
                kinds=("momentum", "turnover", "backtest"),
                interactive_fraction=0.7, deadline_s=0.5)
POOL_HEDGE_FRACTION = 0.35
POOL_KILL_AFTER_S = 2.0
# the ceiling runs: interactive backtest traffic (no class quota to
# reject it) for 2 s at POOL_CEILING_FACTOR times the rate one worker
# sustains when every request is its own batch (1 / its mean backtest
# engine call in (c)); 3 s before the smoke's depth was cut
POOL_CEILING_S = 2
POOL_CEILING_FACTOR = 4


def pool_stats(sup) -> dict:
    """Each ready worker's ``stats`` reply, by pid (a replacement is a new
    process: its counts start at its own spawn)."""
    from csmom_tpu_torch.serve import proto

    out = {}
    for h in sup.ready_workers():
        obj, _ = proto.request_once(h.socket_path, {"op": "stats"}, timeout_s=10.0)
        out[obj["pid"]] = obj
    return out


def pool_deltas(before: dict, after: dict) -> dict:
    """Summed over the processes read both times: K1 and K2 launches,
    ``backtest`` engine calls and their wall, library builds and loads."""
    d = {"k1": 0, "k2": 0, "backtest_calls": 0, "backtest_ms": 0.0, "libraries": 0}
    for pid, a in after.items():
        b = before.get(pid)
        if b is None:
            continue
        d["k1"] += (a["kernel_launches"]["decile_partial_sums"]
                    - b["kernel_launches"]["decile_partial_sums"])
        d["k2"] += (a["kernel_launches"]["cohort_partial_sums"]
                    - b["kernel_launches"]["cohort_partial_sums"])
        d["backtest_calls"] += (a["batches"]["engine_calls"].get("backtest", 0)
                                - b["batches"]["engine_calls"].get("backtest", 0))
        d["backtest_ms"] += (a["batches"]["engine_ms"].get("backtest", 0.0)
                             - b["batches"]["engine_ms"].get("backtest", 0.0))
        d["libraries"] += a["libraries_built_or_loaded"] - b["libraries_built_or_loaded"]
    return d


def result_holder():
    """``hold_result(result, kind, values, mask, what)``: a served result
    against this process's own engine on the card scoring the request
    alone, padded to its bucket as a worker's batcher pads it (phases 12
    and 13)."""
    from csmom_tpu_torch.serve.batcher import Batcher
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.engine import TorchEngine, unpack_result
    from csmom_tpu_torch.serve.queue import Request

    spec = bucket_spec("serve")
    card = TorchEngine(device="cuda")
    card.warm(spec)
    batcher = Batcher(spec)

    def alone(kind, values, mask):
        mb = batcher.pad([Request(kind=kind, values=values, mask=mask,
                                  n_assets=values.shape[0])])
        return unpack_result(kind, card.score(kind, mb.values, mb.mask), 0,
                             values.shape[0])

    def hold_result(result, kind, values, mask, what):
        want = alone(kind, values, mask)
        if isinstance(want, dict):
            return hold_scores(np.array(list(result.values())),
                               np.array(list(want.values())), what, False)
        return hold_scores(np.asarray(result), want, what, False)

    return hold_result


def pool_phase(smi, out_dir) -> dict:
    """Phase 12: the pool on the card.  Returns the workers' kernel
    launches over the phase, read through their ``stats`` replies, and
    the ceiling runs' offered rate (phase 13 offers the same)."""
    import random as pyrandom
    import resource
    import shutil
    import threading

    import torch

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.cli.serve import _kill_w0_after
    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.serve import health
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig, run_pool_loadgen, synth_panel, write_artifact,
    )
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor, pick_transport
    from csmom_tpu_torch.serve.worker import RC_VERSION_SKEW

    hold_result = result_holder()

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    run_dir = tempfile.mkdtemp(prefix="csmom-pool-")
    transport = pick_transport(run_dir)
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    sup = PoolSupervisor(PoolConfig(
        n_workers=POOL_WORKERS, profile="serve", engine="torch", device="cuda",
        transport=transport, require_warm_cache=True), run_dir)
    launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    routers = []
    try:
        # -- (a) spawn and demonstrate ready ------------------------------
        t0 = time.perf_counter()
        sup.start()
        spawn_s = time.perf_counter() - t0
        free1, _ = torch.cuda.mem_get_info()
        want_version = health.aot_cache_version("serve")
        if sup.expect_cache_version != want_version:
            raise AssertionError("pool: the supervisor's cache version is not the "
                                 "parent's")
        for h in sup.handles:
            rep = h.ready_report or {}
            if (h.state != "ready" or rep.get("platform") != "gpu"
                    or rep.get("fresh_compiles") != 0
                    or rep.get("cache_version") != want_version):
                raise AssertionError(f"pool (a): {h.worker_id} {h.state}: {rep} "
                                     f"{h.reason}")
        walls = {h.worker_id: {"ready_wall_s": round(h.t_ready_s - h.t_spawned_s, 3),
                               **h.ready_report["walls"]} for h in sup.handles}
        log("pool", f"(a) {POOL_WORKERS} workers ready in {spawn_s:.2f} s over "
                    f"{transport} sockets (compute mode {mode}): platform gpu, "
                    f"fresh_compiles 0, cache version {want_version}; walls "
                    f"{json.dumps(walls)}; card memory free {free0 / 2**20:.0f} -> "
                    f"{free1 / 2**20:.0f} MiB of {total / 2**20:.0f} "
                    f"({(free0 - free1) / POOL_WORKERS / 2**20:.0f} MiB a worker) | {smi}")
        skew = subprocess.run(
            [sys.executable, "-m", "csmom_tpu_torch.serve.worker", "--socket",
             os.path.join(run_dir, "skew.sock"), "--expect-cache-version",
             "0" * 12], cwd=REPO, capture_output=True, text=True, timeout=300)
        if skew.returncode != RC_VERSION_SKEW or "skew" not in skew.stderr:
            raise AssertionError(f"pool (a): a skewed worker exited {skew.returncode}: "
                                 f"{skew.stderr[-500:]}")
        log("pool", f"(a) a worker expecting cache version {'0' * 12} exits "
                    f"{skew.returncode} (RC_VERSION_SKEW): "
                    f"{skew.stderr.strip().splitlines()[-1][:160]}")

        # -- (b) parity through the router --------------------------------
        # each group of B requests goes to one worker (a router over it),
        # so the worker's batcher can coalesce the group into one batch
        base0 = pool_stats(sup)
        rng = pyrandom.Random(20261017)
        n_held, i = 0, 0
        cfg_b = RouterConfig(profile="serve", default_deadline_s=10.0)
        by_worker = {h.worker_id: Router(lambda h=h: [h], cfg_b) for h in sup.ready_workers()}
        routers += by_worker.values()
        ids = sorted(by_worker)
        for kind in serve_endpoints():
            for B, A in SERVE_SHAPES:
                router = by_worker[ids[i % len(ids)]]
                i += 1
                group = []
                for b in range(B):
                    n = A - 3 if b == 0 else rng.randint(2 if A == 32 else 33, A)
                    v, m = synth_panel(rng, n, SERVE_MONTHS, kind)
                    group.append((v, m))
                reqs = [router.submit(kind, v, m) for v, m in group]
                for (v, m), req in zip(group, reqs):
                    if not req.wait(60.0) or req.state != "served":
                        raise AssertionError(f"pool (b) {kind} B={B} A={A}: "
                                             f"{req.state} {req.error}")
                    hold_result(req.result, kind, v, m,
                                f"pool (b) {kind} B={B} A={A} through the router")
                    n_held += 1
        base1 = pool_stats(sup)
        d = pool_deltas(base0, base1)
        if d["k1"] != d["backtest_calls"] or d["k1"] < 1 or d["k2"] or d["libraries"]:
            raise AssertionError(f"pool (b): the workers' K1 launches {d['k1']} != "
                                 f"their backtest batches {d['backtest_calls']} "
                                 f"(K2 {d['k2']}, libraries {d['libraries']})")
        hists = {s["worker_id"]: s["batches"]["size_hist"] for s in base1.values()}
        log("pool", f"(b) {n_held} requests (5 endpoints x 6 serve shapes, padded "
                    f"rows and assets) through the router == the smoke's engine "
                    f"scoring each alone (f32 {SERVE_F32}); the workers' K1 launches "
                    f"{d['k1']} == their backtest batches {d['backtest_calls']}, K2 0, "
                    f"0 libraries loaded; batch sizes by worker {json.dumps(hists)}")

        # -- (c) the reference's pool cell --------------------------------
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve", default_deadline_s=POOL_R11["deadline_s"],
            hedge_fraction=POOL_HEDGE_FRACTION), retry_after_fn=sup.retry_after_s)
        routers.append(router)
        submitted = []
        lock = threading.Lock()
        submit = router.submit

        def recording_submit(kind, values, mask, **kw):
            req = submit(kind, values, mask, **kw)
            with lock:
                submitted.append((kind, values, mask, req))
            return req

        router.submit = recording_submit
        load = LoadConfig(run_id="chip-r11", **POOL_R11)
        before = pool_stats(sup)
        art = run_pool_loadgen(router, sup, load,
                               concurrent=_kill_w0_after(sup, POOL_KILL_AFTER_S))
        after = pool_stats(sup)
        path = write_artifact(out_dir, art, prefix="GPU_SERVE_POOL")
        viols = inv.validate(art) + router.invariant_violations()
        for name, book in router.class_accounting().items():
            if book["served"] + book["rejected"] + book["expired"] != book["admitted"]:
                viols.append(f"class {name} books open: {book}")
        req_c = art["requests"]
        pool = art["pool"]
        if (viols or req_c["rejected_infra"] or pool["kills"] != 1
                or pool["restarts"] != 1 or pool["ready_workers_end"] != POOL_WORKERS
                or art["compile"]["in_window_fresh_compiles"] != 0):
            raise AssertionError(f"pool (c): {viols}; requests {req_c}; pool "
                                 f"{ {k: pool[k] for k in ('kills', 'restarts', 'ready_workers_end')} }; "
                                 f"fresh {art['compile']['in_window_fresh_compiles']!r}")
        n_c = 0
        for kind, v, m, req in submitted:
            if req.state == "served":
                hold_result(req.result, kind, v, m, f"pool (c) a served {kind}")
                n_c += 1
        respawn = [e for e in pool["events"]
                   if e["event"] == "ready" and e.get("generation") == 1]
        dc = pool_deltas(before, after)
        lat = art["latency_ms"]["total"]
        log("pool", f"(c) r11 {POOL_R11['schedule']} seed {POOL_R11['seed']}, "
                    f"{POOL_WORKERS} workers, hedge {POOL_HEDGE_FRACTION}, w0 SIGKILLed "
                    f"{POOL_KILL_AFTER_S} s in: {art['value']} req/s achieved vs "
                    f"{art['offered']['offered_rps']} offered over {art['wall_s']} s; "
                    f"p50 {lat['p50']} p95 {lat['p95']} p99 {lat['p99']} ms; "
                    f"requests {json.dumps(req_c)}; availability {art['availability']}, "
                    f"hedge rate {art['hedge']['rate']}, retries {req_c['retries']}, "
                    f"worker connection failures {req_c['worker_conn_failures']}; "
                    f"kills 1, restarts 1, {POOL_WORKERS} ready at the end, restart "
                    f"ready wall {respawn[0]['wall_s'] if respawn else None} s "
                    f"({json.dumps(respawn[0].get('walls') if respawn else None)}); "
                    f"books closed per class, 0 fresh compiles, artifact valid "
                    f"({path}); {n_c} served results == the "
                    f"engine alone | {smi}")

        # -- (d) the ceiling: 1 worker against 3 --------------------------
        if not dc["backtest_calls"]:
            raise AssertionError("pool (c): no backtest batch to take a rate from")
        batch_ms = dc["backtest_ms"] / dc["backtest_calls"]
        one = 1e3 / batch_ms
        rate = int(POOL_CEILING_FACTOR * one) + 1
        log("pool", f"(d) rate: a backtest engine call took {batch_ms:.3f} ms on "
                    f"average in (c) ({dc['backtest_calls']} calls), so one worker "
                    f"serving each request alone sustains {one:.1f} req/s; offering "
                    f"{POOL_CEILING_FACTOR}x that, {rate} req/s for {POOL_CEILING_S} s")
        ceiling = {}
        for n in (1, POOL_WORKERS):
            r_n = Router(lambda n=n: sup.ready_workers()[:n], RouterConfig(
                profile="serve", default_deadline_s=POOL_R11["deadline_s"],
                hedge_fraction=POOL_HEDGE_FRACTION), retry_after_fn=sup.retry_after_s)
            routers.append(r_n)
            stamps = []
            submit_n = r_n.submit

            def stamping_submit(*a, submit_n=submit_n, stamps=stamps, **kw):
                stamps.append(time.perf_counter())
                return submit_n(*a, **kw)

            r_n.submit = stamping_submit
            s0 = pool_stats(sup)
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            art_n = run_pool_loadgen(r_n, sup, LoadConfig(
                schedule=f"{POOL_CEILING_S}x{rate}", seed=12, kinds=("backtest",),
                class_mix=(("interactive", 1.0),),
                deadline_s=POOL_R11["deadline_s"], run_id=f"chip-ceiling-{n}"))
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            s1 = pool_stats(sup)
            dn = pool_deltas(s0, s1)
            cpu_s = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
            busy = {s1[pid]["worker_id"]: round(
                (s1[pid]["batches"]["engine_ms"].get("backtest", 0.0)
                 - s0[pid]["batches"]["engine_ms"].get("backtest", 0.0))
                / 1e3 / art_n["wall_s"], 3) for pid in s1 if pid in s0}
            if (r_n.invariant_violations() or inv.validate(art_n)
                    or dn["k1"] != dn["backtest_calls"]):
                raise AssertionError(f"pool (d) {n} worker(s): "
                                     f"{r_n.invariant_violations()} "
                                     f"{inv.validate(art_n)} {dn}")
            write_artifact(out_dir, art_n, prefix="GPU_SERVE_POOL")
            rq = art_n["requests"]
            ceiling[n] = art_n["value"]
            log("pool", f"(d) {n} worker(s): {art_n['value']} req/s achieved of "
                        f"{art_n['offered']['offered_rps']} offered over "
                        f"{art_n['wall_s']} s, offered_limited "
                        f"{art_n['offered_limited']}; p50 "
                        f"{art_n['latency_ms']['total']['p50']} p99 "
                        f"{art_n['latency_ms']['total']['p99']} ms; served "
                        f"{rq['served']}, rejected {rq['rejected']} (saturated "
                        f"{rq['rejected_saturated']}, infra {rq['rejected_infra']}), "
                        f"expired {rq['expired']}, hedged {rq['hedged']}; "
                        f"{dn['backtest_calls']} backtest batches "
                        f"({dn['backtest_ms'] / max(1, dn['backtest_calls']):.3f} ms "
                        f"each); engine-busy share of the wall by worker "
                        f"{json.dumps(busy)}; the arrivals of the "
                        f"{POOL_CEILING_S} s schedule submitted over "
                        f"{stamps[-1] - stamps[0]:.3f} s; this (router) process "
                        f"{cpu_s:.2f} s of CPU ({cpu_s / art_n['wall_s']:.2f} cores) "
                        f"| {smi}")
        log("pool", f"(d) ceiling: {ceiling[POOL_WORKERS]} req/s through "
                    f"{POOL_WORKERS} workers against {ceiling[1]} through 1 "
                    f"({ceiling[POOL_WORKERS] / max(ceiling[1], 1e-9):.2f}x)")

        # the workers' launches over the phase: every live process's count
        # since its spawn, plus the killed worker's last read before its
        # death (what it launched after that read died with it)
        final = pool_stats(sup)
        dead = {pid: s for pid, s in base1.items() if pid not in final}
        for s in list(final.values()) + list(dead.values()):
            for name in launches:
                launches[name] += s["kernel_launches"][name]
    finally:
        for r in routers:
            r.channels.close()
        sup.stop()
        shutil.rmtree(run_dir, ignore_errors=True)
    if any(h.proc.poll() is None for h in sup.handles):
        raise AssertionError("pool: a worker outlived the supervisor's stop")

    # -- the CLI, in subprocesses ------------------------------------------
    for label, argv, want in (
            ("serve", ["serve", "--workers", "2", "--duration", "1"],
             "self-probe: all endpoints served"),
            ("loadgen", ["loadgen", "--pool", "--workers", "2", "--schedule", "2x40",
                         "--kill-worker-after", "1", "--out", out_dir, "--run-id",
                         "chip-cli-pool"], "artifact: ")):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", *argv],
                           cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if p.returncode != 0 or want not in p.stdout:
            raise AssertionError(f"pool cli {label}: exit {p.returncode}\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        log("pool", f"(cli) {' '.join(argv)}: exit 0 in {wall:.2f} s; "
                    + " / ".join(ln.strip() for ln in p.stdout.splitlines()
                                 if ln.startswith(("throughput", "latency", "  self-probe",
                                                   "availability", "fleet", "in-window")))
                    + f" | {smi}")
    if launches["decile_partial_sums"] < 1 or launches["cohort_partial_sums"]:
        raise AssertionError(f"pool: worker launches {launches}, expected K1 > 0, K2 0")
    return {"launches": launches, "ceiling_rate": rate}


# phase 13: the serving fabric on the card.  The JAX package's r20 fabric
# (SERVE_FABRIC_r20.json): two router-replica processes over tcp in front
# of three torch workers sharing the card, the fabric client in this
# process; profile "serve" as in phases 11 and 12
FABRIC_ROUTERS = 2
FABRIC_WORKERS = 3
# SERVE_FABRIC_r20.json's own configuration: the bursty schedule, seed 0,
# the five endpoints, its class mix, panel reuse and one version bump,
# 500 ms deadlines
FABRIC_R20 = dict(schedule="0.5x8,0.3x240,0.5x8,0.3x300,0.5x10,0.3x260,0.4x8",
                  schedule_kind="bursty", seed=0,
                  class_mix=(("interactive", 0.45), ("standard", 0.15),
                             ("bulk", 0.4)),
                  reuse_fraction=0.35, version_bumps=1, deadline_s=0.5)
# one router and one worker SIGKILLed mid-burst, at the offsets of the
# reference's fabric capture command (--kill-router-after 1.0
# --kill-worker-after 1.6)
FABRIC_KILL_ROUTER_S = 1.0
FABRIC_KILL_WORKER_S = 1.6


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a live process (``/proc/<pid>/stat``)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def fabric_phase(smi, out_dir, ceiling_rate: int) -> dict:
    """Phase 13: the fabric on the card.  ``ceiling_rate`` is phase 12's
    ceiling offer, reused.  Returns the workers' kernel launches and
    ``backtest`` batches over the phase's serving windows, read through
    their ``stats`` replies (each process from its first read after it
    became ready, so warm-ups are not counted), and the r20 cell's
    total-latency percentiles (phase 15 runs the cell traced)."""
    import random as pyrandom
    import resource
    import shutil
    import threading

    import torch

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.serve import health
    from csmom_tpu_torch.serve.fabric import (
        FabricClient, RoutesPublisher, build_fabric, kill_mid_burst, stop_fabric,
        write_routes,
    )
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig, run_fabric_loadgen, synth_panel, write_artifact,
    )
    from csmom_tpu_torch.serve.supervisor import PoolConfig

    hold_result = result_holder()
    first: dict = {}   # pid -> the process's first stats reply
    last: dict = {}    # pid -> its latest

    def read_workers(wsup) -> dict:
        now = pool_stats(wsup)
        for pid, st in now.items():
            first.setdefault(pid, st)
            last[pid] = st
        return now

    run_dir = tempfile.mkdtemp(prefix="csmom-fabric-")
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    wsup = publisher = rsup = client = None
    try:
        # -- (a) three tiers ready ----------------------------------------
        t0 = time.perf_counter()
        wsup, publisher, rsup, client = build_fabric(
            PoolConfig(n_workers=FABRIC_WORKERS, profile="serve", engine="torch",
                       device="cuda", transport="tcp", require_warm_cache=True),
            PoolConfig(n_workers=FABRIC_ROUTERS, profile="serve", engine="stub",
                       transport="tcp"),
            run_dir, deadline_ms=1e3 * FABRIC_R20["deadline_s"],
            client_deadline_s=FABRIC_R20["deadline_s"])
        spawn_s = time.perf_counter() - t0
        free1, _ = torch.cuda.mem_get_info()
        want_version = health.aot_cache_version("serve")
        for h in wsup.handles:
            rep = h.ready_report or {}
            if (h.state != "ready" or rep.get("platform") != "gpu"
                    or rep.get("fresh_compiles") != 0
                    or rep.get("cache_version") != want_version):
                raise AssertionError(f"fabric (a): {h.worker_id} {h.state}: {rep} "
                                     f"{h.reason}")
        replicas = rsup.router_stats()
        if (len(replicas) != FABRIC_ROUTERS
                or any(r["state"] != "ready" or r.get("torch_loaded") is not False
                       or r.get("accounting") is None for r in replicas)):
            raise AssertionError(f"fabric (a): router replicas {replicas}")
        walls = {h.worker_id: round(h.t_ready_s - h.t_spawned_s, 3)
                 for h in rsup.handles + wsup.handles}
        log("fabric", f"(a) {FABRIC_ROUTERS} router replicas (stub engine, "
                      f"torch_loaded false) and {FABRIC_WORKERS} torch workers ready "
                      f"in {spawn_s:.2f} s over tcp: platform gpu, fresh_compiles 0, "
                      f"cache version {want_version}; spawn -> ready walls "
                      f"{json.dumps(walls)}; worker walls "
                      f"{json.dumps({h.worker_id: h.ready_report['walls'] for h in wsup.handles})}; "
                      f"card memory free {free0 / 2**20:.0f} -> {free1 / 2**20:.0f} "
                      f"MiB of {total / 2**20:.0f} | {smi}")

        # -- (b) parity through the fabric ---------------------------------
        # a client of its own: the measured client's books are (c)'s ledger
        probe = FabricClient(rsup.ready_workers, client.config)
        base0 = read_workers(wsup)
        rng = pyrandom.Random(20261018)
        n_held = 0
        try:
            for kind in serve_endpoints():
                for B, A in SERVE_SHAPES:
                    group = [synth_panel(rng, A - 3 if b == 0 else
                                         rng.randint(2 if A == 32 else 33, A),
                                         SERVE_MONTHS, kind) for b in range(B)]
                    reqs = [probe.submit(kind, v, m, deadline_s=10.0)
                            for v, m in group]
                    for (v, m), req in zip(group, reqs):
                        if not req.wait(60.0) or req.state != "served":
                            raise AssertionError(f"fabric (b) {kind} B={B} A={A}: "
                                                 f"{req.state} {req.error}")
                        hold_result(req.result, kind, v, m,
                                    f"fabric (b) {kind} B={B} A={A}")
                        n_held += 1
        finally:
            probe.close()
        d = pool_deltas(base0, read_workers(wsup))
        if d["k1"] != d["backtest_calls"] or d["k1"] < 1 or d["k2"] or d["libraries"]:
            raise AssertionError(f"fabric (b): the workers' K1 launches {d['k1']} != "
                                 f"their backtest batches {d['backtest_calls']} "
                                 f"(K2 {d['k2']}, libraries {d['libraries']})")
        log("fabric", f"(b) {n_held} requests (5 endpoints x 6 serve shapes) through "
                      f"client -> replica -> worker == the smoke's engine scoring "
                      f"each alone (f32 {SERVE_F32}); the workers' K1 launches "
                      f"{d['k1']} == their backtest batches {d['backtest_calls']}, "
                      f"K2 0, 0 libraries loaded")

        # -- (c) the reference's r20 cell ----------------------------------
        submitted = []
        lock = threading.Lock()
        submit = client.submit

        def recording_submit(kind, values, mask, **kw):
            req = submit(kind, values, mask, **kw)
            with lock:
                submitted.append((kind, values, mask, req))
            return req

        client.submit = recording_submit

        def double_kill():
            if not kill_mid_burst([(FABRIC_KILL_ROUTER_S, rsup, "router"),
                                   (FABRIC_KILL_WORKER_S, wsup, "worker")],
                                  settle_timeout_s=wsup.config.ready_timeout_s):
                raise AssertionError("fabric (c): a killed tier never demonstrated "
                                     "ready again")

        read_workers(wsup)
        art = run_fabric_loadgen(client, rsup, wsup, LoadConfig(
            run_id="chip-r20", **FABRIC_R20), concurrent=double_kill)
        read_workers(wsup)
        path = write_artifact(out_dir, art, prefix="GPU_SERVE_FABRIC")
        viols = inv.validate(art) + client.invariant_violations()
        by_class: dict = {}
        for _, _, _, req in submitted:
            book = by_class.setdefault(req.priority, {"admitted": 0, "served": 0,
                                                      "rejected": 0, "expired": 0})
            book["admitted"] += 1
            if req.state in ("served", "rejected", "expired"):
                book[req.state] += 1
        for name, book in by_class.items():
            if book["served"] + book["rejected"] + book["expired"] != book["admitted"]:
                viols.append(f"client class {name} books open: {book}")
        for r in art["routers"]["replicas"]:
            a = r.get("accounting")
            if a is None:
                viols.append(f"replica {r['router_id']} reported no books: {r}")
                continue
            if a["served"] + a["rejected"] + a["expired"] != a["admitted"]:
                viols.append(f"replica {r['router_id']} books open: {a}")
            viols += [f"replica {r['router_id']}: {v}" for v in r["invariant_violations"]]
            for name, book in r["classes"].items():
                if book["served"] + book["rejected"] + book["expired"] != book["admitted"]:
                    viols.append(f"replica {r['router_id']} class {name} open: {book}")
        req_c = art["requests"]
        tiers = {t: {k: art[t][k] for k in ("kills", "restarts", "ready_end")}
                 for t in ("routers", "workers")}
        if (viols or req_c["rejected_infra"] or art["availability"] != 1.0
                or tiers != {"routers": {"kills": 1, "restarts": 1,
                                         "ready_end": FABRIC_ROUTERS},
                             "workers": {"kills": 1, "restarts": 1,
                                         "ready_end": FABRIC_WORKERS}}
                or art["compile"]["in_window_fresh_compiles"] != 0
                or len(submitted) != req_c["admitted"]):
            raise AssertionError(f"fabric (c): {viols}; requests {req_c}; tiers "
                                 f"{tiers}; fresh "
                                 f"{art['compile']['in_window_fresh_compiles']!r}")
        n_c = 0
        for kind, v, m, req in submitted:
            if req.state == "served":
                hold_result(req.result, kind, v, m, f"fabric (c) a served {kind}")
                n_c += 1
        respawn = {t: [e.get("wall_s") for e in art[t]["events"]
                       if e["event"] == "ready" and e.get("generation") == 1]
                   for t in ("routers", "workers")}
        lat = r20_lat = art["latency_ms"]["total"]
        log("fabric", f"(c) r20 bursty seed 0, {FABRIC_ROUTERS} routers x "
                      f"{FABRIC_WORKERS} workers over tcp, r0 SIGKILLed "
                      f"{FABRIC_KILL_ROUTER_S} s and w0 {FABRIC_KILL_WORKER_S} s in: "
                      f"{art['value']} req/s achieved vs {art['offered']['offered_rps']} "
                      f"offered over {art['wall_s']} s; p50 {lat['p50']} p95 "
                      f"{lat['p95']} p99 {lat['p99']} ms; requests {json.dumps(req_c)}; "
                      f"by class {json.dumps(by_class)}; availability "
                      f"{art['availability']}, pool cache hit rate "
                      f"{art['cache']['pool_hit_rate']}, hedge rate "
                      f"{art['hedge']['rate']}; tiers {json.dumps(tiers)}, "
                      f"replacements ready in {json.dumps(respawn)} s; books closed "
                      f"per class and per replica, 0 fresh compiles, artifact valid "
                      f"({path}); {n_c} served results == the engine alone | {smi}")

        # -- (d) phase 12's ceiling behind two routers ---------------------
        # the routes file names one worker, then all three: the replicas
        # route from it (the publisher paused meanwhile)
        routes_path = os.path.join(run_dir, "routes.json")
        ceiling = {}
        for n in (1, FABRIC_WORKERS):
            publisher.stop()
            chosen = wsup.ready_workers()[:n]
            write_routes(routes_path, [(h.worker_id, h.socket_path) for h in chosen],
                         None, wsup.expect_cache_version)
            for h in rsup.ready_workers():
                if health.readiness(h.socket_path, timeout_s=5.0).get("workers") != n:
                    raise AssertionError(f"fabric (d): {h.worker_id} does not route "
                                         f"to {n} worker(s)")
            c_n = FabricClient(rsup.ready_workers, client.config)
            stamps = []
            submit_n = c_n.submit

            def stamping_submit(*a, submit_n=submit_n, stamps=stamps, **kw):
                stamps.append(time.perf_counter())
                return submit_n(*a, **kw)

            c_n.submit = stamping_submit
            s0 = read_workers(wsup)
            cpu0 = {h.worker_id: proc_cpu_s(h.proc.pid)
                    for h in rsup.handles + wsup.handles}
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            try:
                art_n = run_fabric_loadgen(c_n, rsup, wsup, LoadConfig(
                    schedule=f"{POOL_CEILING_S}x{ceiling_rate}", seed=12,
                    kinds=("backtest",), class_mix=(("interactive", 1.0),),
                    deadline_s=FABRIC_R20["deadline_s"],
                    run_id=f"chip-fabric-ceiling-{n}"))
            finally:
                c_n.close()
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu1 = {h.worker_id: proc_cpu_s(h.proc.pid)
                    for h in rsup.handles + wsup.handles}
            s1 = read_workers(wsup)
            dn = pool_deltas(s0, s1)
            wall = art_n["wall_s"]
            client_cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
            cores = {w: round((cpu1[w] - cpu0[w]) / wall, 2) for w in cpu0}
            # requests that reached a worker and expired in its queue
            queue_expired = {s1[pid]["worker_id"]: s1[pid]["accounting"]["expired"]
                             - s0[pid]["accounting"]["expired"]
                             for pid in s1 if pid in s0}
            busy = {s1[pid]["worker_id"]: round(
                (s1[pid]["batches"]["engine_ms"].get("backtest", 0.0)
                 - s0[pid]["batches"]["engine_ms"].get("backtest", 0.0))
                / 1e3 / wall, 3) for pid in s1 if pid in s0}
            if (c_n.invariant_violations() or inv.validate(art_n)
                    or dn["k1"] != dn["backtest_calls"]):
                raise AssertionError(f"fabric (d) {n} worker(s): "
                                     f"{c_n.invariant_violations()} "
                                     f"{inv.validate(art_n)} {dn}")
            write_artifact(out_dir, art_n, prefix="GPU_SERVE_FABRIC")
            rq = art_n["requests"]
            ceiling[n] = art_n["value"]
            log("fabric", f"(d) {FABRIC_ROUTERS} routers x {n} worker(s): "
                          f"{art_n['value']} req/s achieved of "
                          f"{art_n['offered']['offered_rps']} offered over {wall} s; "
                          f"p50 {art_n['latency_ms']['total']['p50']} p99 "
                          f"{art_n['latency_ms']['total']['p99']} ms; served "
                          f"{rq['served']} ({rq['served_cache_hits']} from a "
                          f"worker's cache), rejected {rq['rejected']} (infra "
                          f"{rq['rejected_infra']}), expired {rq['expired']}; "
                          f"{dn['backtest_calls']} backtest batches "
                          f"({dn['backtest_ms'] / max(1, dn['backtest_calls']):.3f} ms "
                          f"each); engine-busy share by worker {json.dumps(busy)}; "
                          f"expired in a worker's queue {json.dumps(queue_expired)}; "
                          f"router and worker processes {json.dumps(cores)} cores; "
                          f"the client (this process) {client_cpu:.2f} s of CPU "
                          f"({client_cpu / wall:.2f} cores), the {POOL_CEILING_S} s "
                          f"schedule submitted over {stamps[-1] - stamps[0]:.3f} s; "
                          f"the fabric's processes "
                          f"{sum(cores.values()) + client_cpu / wall:.2f} cores in "
                          f"all, of the {len(os.sched_getaffinity(0))} this process "
                          f"may run on | {smi}")
            publisher = RoutesPublisher(wsup, routes_path, interval_s=0.05).start()
        log("fabric", f"(d) ceiling behind {FABRIC_ROUTERS} routers: "
                      f"{ceiling[FABRIC_WORKERS]} req/s through {FABRIC_WORKERS} "
                      f"workers against {ceiling[1]} through 1 "
                      f"({ceiling[FABRIC_WORKERS] / max(ceiling[1], 1e-9):.2f}x), "
                      f"{ceiling_rate} req/s offered (phase 12's rate)")
    finally:
        stop_fabric(publisher, rsup, wsup)
        if client is not None:
            client.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    if wsup is not None and any(h.proc.poll() is None
                                for h in rsup.handles + wsup.handles):
        raise AssertionError("fabric: a process outlived the supervisors' stop")

    # -- (e) the CLI, in a subprocess --------------------------------------
    argv = ["loadgen", "--fabric", "--routers", "2", "--workers", "2", "--transport",
            "tcp", "--kill-router-after", "1", "--out", out_dir, "--run-id",
            "chip-cli-fabric"]
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", *argv],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    cli_path = os.path.join(out_dir, "GPU_SERVE_FABRIC_chip-cli-fabric.json")
    if (p.returncode != 0 or "artifact: " not in p.stdout
            or inv.validate_file(cli_path)):
        raise AssertionError(f"fabric cli: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    log("fabric", f"(cli) {' '.join(argv)}: exit 0 in {wall:.2f} s, artifact valid; "
                  + " / ".join(ln.strip() for ln in p.stdout.splitlines()
                               if ln.startswith(("fabric ready", "throughput",
                                                 "latency", "  self-probe",
                                                 "availability", "routers:",
                                                 "in-window")))
                  + f" | {smi}")

    launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    batches = 0
    for pid, st in last.items():
        for name in launches:
            launches[name] += (st["kernel_launches"][name]
                               - first[pid]["kernel_launches"][name])
        batches += (st["batches"]["engine_calls"].get("backtest", 0)
                    - first[pid]["batches"]["engine_calls"].get("backtest", 0))
    if (launches["decile_partial_sums"] != batches or batches < 1
            or launches["cohort_partial_sums"]):
        raise AssertionError(f"fabric: worker launches {launches} against "
                             f"{batches} backtest batches")
    return {"launches": launches, "backtest_batches": batches, "r20": r20_lat}


# phase 14: the fleet observatory and the elastic tier on the card.  The
# warm paths alone (a cold worker against one forked by the prefork
# parent), then the r20 fabric of phase 13 with the observatory armed,
# the same cell with a hot spare, the autoscaler and the prefork path
# (the reference's r21), the autoscaler moving under phase 12's ceiling
# offer, and the CLI
FLEET_SPARES = 1
# the autoscaling cell: three workers, room for one more; the high
# watermark is well under the default 200 because one client process is
# the whole offer and submits what its host lets it: ~400-550 req/s on
# the chip hosts of PR 11's ceiling runs, ~200-320 on another (the
# autoscaler's demand readings in PR 16's third chip run, whose 100 a
# worker was breached for under 1.5 s), so 60 a worker (180 over three)
FLEET_AUTOSCALE = dict(min_workers=3, max_workers=4, high_rps_per_worker=60.0)
FLEET_OFFER_S = 6       # phase 12's ceiling rate offered this long
FLEET_IDLE_S = 10       # then this long idle, for the drain
FLEET_BACKFILL_S = 60   # the longest wait for a backfill spare


class _Addr:
    """A routable worker row for a ``Router`` over one address."""

    def __init__(self, worker_id: str, socket_path: str):
        self.worker_id = worker_id
        self.socket_path = socket_path


def wait_until(pred, timeout_s: float, what: str, step_s: float = 0.05):
    give_up = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > give_up:
            raise AssertionError(f"fleet: timed out after {timeout_s} s: {what}")
        time.sleep(step_s)


def land_fleet(run_id, art, wsup, rsup, window, out_dir):
    """The cell's ``GPU_FLEET_<run>.json``, landed by the CLI's own
    ``_land_fleet`` after the fabric stopped (it validates the artifact,
    which must close every stream book with a reason, and disarms the
    observatory).  Returns ``(artifact, path)``."""
    from csmom_tpu_torch.cli.serve import _land_fleet

    if _land_fleet(run_id, art, out_dir, wsup, rsup, window):
        raise AssertionError(f"fleet {run_id}: the fleet artifact is invalid")
    path = os.path.join(out_dir, f"GPU_FLEET_{run_id}.json")
    with open(path) as f:
        return json.load(f), path


def fleet_phase(smi, out_dir, ceiling_rate: int) -> dict:
    """Phase 14: the fleet observatory and the elastic tier on the card.
    ``ceiling_rate`` is phase 12's ceiling offer, reused by (d).  Returns
    the K1 and K2 launches of every worker process of the phase (warm-ups
    included), each process's last ``stats`` read before it stopped or
    was killed."""
    import random as pyrandom
    import shutil
    import threading

    import torch

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.obs import fleet as obs_fleet
    from csmom_tpu_torch.ops import build
    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.serve import fleet as serve_fleet
    from csmom_tpu_torch.serve import health, proto
    from csmom_tpu_torch.serve.engine import KERNELS
    from csmom_tpu_torch.serve.fabric import build_fabric, kill_mid_burst, stop_fabric
    from csmom_tpu_torch.serve.fleet import FleetConfig
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig, run_fabric_loadgen, synth_panel, write_artifact,
    )
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.supervisor import PoolConfig
    from csmom_tpu_torch.utils.deadline import mono_now_s

    hold_result = result_holder()
    want_version = health.aot_cache_version("serve")
    latest: dict = {}   # pid -> the process's last stats reply

    def read(addrs) -> dict:
        now = {}
        for wid, addr in addrs:
            obj, _ = proto.request_once(addr, {"op": "stats"}, timeout_s=10.0)
            latest[obj["pid"]] = obj
            now[obj["pid"]] = obj
        return now

    def fleet_addrs(wsup):
        rows = [(h.worker_id, h.socket_path) for h in wsup.ready_workers()]
        if wsup.fleet is not None:
            rows += [(s.worker_id, s.socket_path) for s in wsup.fleet.spares
                     if s.state == "ready" and s.proc.poll() is None]
        return rows

    def fabric(run_dir, fleet_config=None, n_workers=FABRIC_WORKERS):
        return build_fabric(
            PoolConfig(n_workers=n_workers, profile="serve", engine="torch",
                       device="cuda", transport="tcp", require_warm_cache=True),
            PoolConfig(n_workers=FABRIC_ROUTERS, profile="serve", engine="stub",
                       transport="tcp"),
            run_dir, deadline_ms=1e3 * FABRIC_R20["deadline_s"],
            client_deadline_s=FABRIC_R20["deadline_s"], fleet_config=fleet_config)

    def r20(client, rsup, wsup, run_id, what):
        """Phase 13 (c)'s cell on this fabric: the client's books by
        class, every served result held to the engine alone; returns the
        artifact, its window and the victims' pids."""
        submitted = []
        lock = threading.Lock()
        submit = client.submit

        def recording_submit(kind, values, mask, **kw):
            req = submit(kind, values, mask, **kw)
            with lock:
                submitted.append((kind, values, mask, req))
            return req

        client.submit = recording_submit
        victims = {"router": rsup.handles[0].proc.pid,
                   "worker": wsup.handles[0].proc.pid}

        def double_kill():
            if not kill_mid_burst([(FABRIC_KILL_ROUTER_S, rsup, "router"),
                                   (FABRIC_KILL_WORKER_S, wsup, "worker")],
                                  settle_timeout_s=wsup.config.ready_timeout_s):
                raise AssertionError(f"{what}: a killed tier never demonstrated "
                                     "ready again")

        read(fleet_addrs(wsup))
        t_load0 = mono_now_s()
        art = run_fabric_loadgen(client, rsup, wsup, LoadConfig(
            run_id=run_id, **FABRIC_R20), concurrent=double_kill)
        read(fleet_addrs(wsup))
        client.submit = submit
        viols = inv.validate(art) + client.invariant_violations()
        by_class: dict = {}
        for _, _, _, req in submitted:
            book = by_class.setdefault(req.priority, {"admitted": 0, "served": 0,
                                                      "rejected": 0, "expired": 0})
            book["admitted"] += 1
            if req.state in ("served", "rejected", "expired"):
                book[req.state] += 1
        if (viols or art["availability"] != 1.0
                or art["compile"]["in_window_fresh_compiles"] != 0
                or len(submitted) != art["requests"]["admitted"]):
            raise AssertionError(f"{what}: {viols}; requests {art['requests']}; "
                                 f"fresh {art['compile']['in_window_fresh_compiles']!r}")
        n = 0
        for kind, v, m, req in submitted:
            if req.state == "served":
                hold_result(req.result, kind, v, m, f"{what}: a served {kind}")
                n += 1
        return art, (t_load0, t_load0 + art["wall_s"]), victims, by_class, n

    def check_demand(fleet_art, by_class, what):
        demand = fleet_art["demand"]["classes"]
        for name, book in by_class.items():
            got = demand.get(name, {})
            if (got.get("offered") != book["admitted"]
                    or got.get("admitted") != book["admitted"]
                    or got.get("served", 0) != book["served"]):
                raise AssertionError(f"{what}: class {name} demand {got} against "
                                     f"the client's book {book}")

    def severed(fleet_art, victims, what):
        procs = fleet_art["series"]["processes"]
        out = {}
        for tier, pid in victims.items():
            name = f"{tier}:{'r0' if tier == 'router' else 'w0'}@{pid}"
            reason = (procs.get(name) or {}).get("close_reason") or ""
            if not reason.startswith("stream severed"):
                raise AssertionError(f"{what}: {name} closed {reason!r}, not severed")
            out[name] = reason
        return out

    def thread_gates(events, what):
        """The prefork parent at one native thread, CUDA untouched, at its
        start and at every fork."""
        forks = [e for e in events if e["event"] in ("prefork_ready", "spare_spawn")]
        bad = [e for e in forks if e.get("native_threads", 1) != 1
               or e.get("cuda_initialized")]
        refused = [e for e in events if e["event"] in ("prefork_refused",
                                                       "prefork_failed")]
        spawns = [e for e in forks if e["event"] == "spare_spawn"]
        if bad or refused or not spawns or any(e["via"] != "prefork" for e in spawns):
            raise AssertionError(f"{what}: prefork events {forks} {refused}")
        return len(spawns)

    root = tempfile.mkdtemp(prefix="csmom-fleet-")
    out = {}
    procs = []          # (a)'s processes: the parent and the cold worker
    forked = []         # (a)'s forked worker's pid
    try:
        # -- (a) the warm paths, alone -----------------------------------
        t_a = time.perf_counter()
        run_a = os.path.join(root, "a")
        os.makedirs(run_a)
        env = {**os.environ,
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        p_addr = f"tcp:127.0.0.1:{proto.free_tcp_port()}"
        libs = [str(build.library_path(n)) for n in KERNELS]

        def popen(argv, name, extra_env=None):
            log_f = open(os.path.join(run_a, f"{name}.log"), "ab")
            try:
                p = subprocess.Popen([sys.executable, "-m", *argv], stdout=log_f,
                                     stderr=log_f, env={**env, **(extra_env or {})},
                                     cwd=REPO)
            finally:
                log_f.close()
            procs.append(p)
            return p

        def worker_argv(addr, wid):
            return ["--socket", addr, "--worker-id", wid, "--profile", "serve",
                    "--engine", "torch", "--device", "cuda",
                    "--expect-cache-version", want_version, "--require-warm-cache"]

        def ready(addr, what):
            wait_until(lambda: health.readiness(addr, timeout_s=2.0).get("ok"),
                       120.0, f"{what} ready", step_s=0.02)
            return health.readiness(addr, timeout_s=5.0)

        t0 = time.perf_counter()
        parent = popen(["csmom_tpu_torch.serve.fleet", "--socket", p_addr,
                        "--preimport", serve_fleet.PREFORK_IMPORTS["torch"],
                        "--prewarm", ",".join(libs)], "prefork",
                       serve_fleet.PREFORK_THREAD_ENV)

        def pinged():
            try:
                return proto.request_once(p_addr, {"op": "ping"},
                                          timeout_s=2.0)[0].get("state") == "ok"
            except (OSError, proto.ProtocolError):
                return False

        wait_until(pinged, 120.0, "the prefork parent answers ping")
        parent_s = time.perf_counter() - t0
        ping, _ = proto.request_once(p_addr, {"op": "ping"}, timeout_s=5.0)
        want_imports = serve_fleet.PREFORK_IMPORTS["torch"].split(",")
        if (ping["imported"] != want_imports or ping["cuda_initialized"] is not False
                or ping["native_threads"] != 1
                or ping["prewarmed_files"] != len(libs)):
            raise AssertionError(f"fleet (a): the prefork parent's ping {ping}")
        log("fleet", f"(a) prefork parent up in {parent_s:.2f} s: imported "
                     f"{ping['imported']}, cuda_initialized "
                     f"{ping['cuda_initialized']}, {ping['native_threads']} native "
                     f"thread, {ping['prewarmed_files']} kernel libraries "
                     f"({ping['prewarmed_bytes']} bytes) read into the page cache")
        walls = {}
        addrs = {}
        for path_kind in ("cold", "prefork"):
            addr = f"tcp:127.0.0.1:{proto.free_tcp_port()}"
            wid = f"{path_kind[0]}0"
            torch.cuda.synchronize()
            free0, total = torch.cuda.mem_get_info()
            t0 = time.perf_counter()
            if path_kind == "cold":
                popen(["csmom_tpu_torch.serve.worker", *worker_argv(addr, wid)], wid)
                fork = {}
            else:
                fork, _ = proto.request_once(p_addr, {
                    "op": "spawn", "argv": worker_argv(addr, wid),
                    "log_path": os.path.join(run_a, f"{wid}.log")}, timeout_s=10.0)
                if (fork.get("state") != "ok" or fork["native_threads"] != 1
                        or fork["cuda_initialized"] is not False):
                    raise AssertionError(f"fleet (a): spawn {fork}")
                child = serve_fleet._PreforkChild(int(fork["pid"]), p_addr)
                forked.append(child.pid)
            rep = ready(addr, f"the {path_kind} worker")
            wall = time.perf_counter() - t0
            free1, _ = torch.cuda.mem_get_info()
            if rep.get("platform") != "gpu" or rep.get("fresh_compiles") != 0:
                raise AssertionError(f"fleet (a) {path_kind}: {rep}")
            addrs[path_kind] = (wid, addr)
            walls[path_kind] = {"spawn_to_ready_s": round(wall, 3), **rep["walls"],
                                "card_mib": round((free0 - free1) / 2**20)}
            log("fleet", f"(a) {path_kind} worker ({'subprocess' if path_kind == 'cold' else 'forked by the parent, ' + json.dumps(fork)}): "
                         f"spawn -> ready {wall:.3f} s, worker-reported "
                         f"{json.dumps(rep['walls'])}, fresh_compiles 0, card "
                         f"memory {(free0 - free1) / 2**20:.0f} MiB | {smi}")
        base = read(addrs.values())
        n_held = 0
        rng = pyrandom.Random(20261019)
        for path_kind, (wid, addr) in addrs.items():
            router = Router(lambda wid=wid, addr=addr: [_Addr(wid, addr)],
                            RouterConfig(profile="serve", default_deadline_s=10.0))
            try:
                for kind in serve_endpoints():
                    for B, A in SERVE_SHAPES:
                        group = [synth_panel(rng, A - 3 if b == 0 else
                                             rng.randint(2 if A == 32 else 33, A),
                                             SERVE_MONTHS, kind) for b in range(B)]
                        reqs = [router.submit(kind, v, m) for v, m in group]
                        for (v, m), req in zip(group, reqs):
                            if not req.wait(60.0) or req.state != "served":
                                raise AssertionError(f"fleet (a) {path_kind} {kind} "
                                                     f"B={B} A={A}: {req.state} "
                                                     f"{req.error}")
                            hold_result(req.result, kind, v, m,
                                        f"fleet (a) {path_kind} {kind} B={B} A={A}")
                            n_held += 1
            finally:
                router.channels.close()
        d = pool_deltas(base, read(addrs.values()))
        if d["k1"] != d["backtest_calls"] or d["k1"] < 1 or d["k2"] or d["libraries"]:
            raise AssertionError(f"fleet (a): K1 {d['k1']} != backtest batches "
                                 f"{d['backtest_calls']} (K2 {d['k2']}, libraries "
                                 f"{d['libraries']})")
        for wid, addr in addrs.values():
            proto.request_once(addr, {"op": "stop"}, timeout_s=30.0)
        rc_child = child.wait(timeout=30.0)
        proto.request_once(p_addr, {"op": "shutdown"}, timeout_s=5.0)
        if (rc_child != 0 or parent.wait(timeout=30.0) != 0
                or os.path.exists(f"/proc/{child.pid}")):
            raise AssertionError(f"fleet (a): the forked worker exited {rc_child}, "
                                 f"the parent {parent.returncode}")
        for p in procs:
            p.wait(timeout=30.0)
        log("fleet", f"(a) both workers: {n_held} requests (5 endpoints x 6 serve "
                     f"shapes) == the smoke's engine alone (f32 {SERVE_F32}); K1 "
                     f"launches {d['k1']} == backtest batches {d['backtest_calls']}, "
                     f"K2 0, 0 libraries loaded; the forked worker stopped (exit 0), "
                     f"polled and reaped through the parent; walls "
                     f"{json.dumps(walls)}; (a) {time.perf_counter() - t_a:.1f} s")
        out["walls"] = walls

        # -- (b) r20 with the observatory armed -----------------------------
        t_b = time.perf_counter()
        obs_fleet.arm("chip-fleet-r20", transport="tcp")
        wsup = publisher = rsup = client = None
        try:
            wsup, publisher, rsup, client = fabric(os.path.join(root, "b"))
            art_b, window, victims, by_class, n_b = r20(client, rsup, wsup,
                                                        "chip-fleet-r20", "fleet (b)")
        except BaseException:
            obs_fleet.disarm("fleet (b) failed")
            raise
        finally:
            stop_fabric(publisher, rsup, wsup)
            if client is not None:
                client.close()
        write_artifact(out_dir, art_b, prefix="GPU_SERVE_FABRIC")
        fl_b, path_b = land_fleet("chip-fleet-r20", art_b, wsup, rsup, window, out_dir)
        books = fl_b["series"]["books"]
        cut = severed(fl_b, victims, "fleet (b)")
        if books["seq_gaps"] or art_b["extra"]["observatory_armed"] is not True:
            raise AssertionError(f"fleet (b): books {books}")
        check_demand(fl_b, by_class, "fleet (b)")
        lat = art_b["latency_ms"]["total"]
        cap = fl_b["capacity"]
        log("fleet", f"(b) r20 armed ({FABRIC_ROUTERS} routers x {FABRIC_WORKERS} "
                     f"workers over tcp, r0 and w0 SIGKILLed): {art_b['value']} req/s "
                     f"of {art_b['offered']['offered_rps']} offered; p50 {lat['p50']} "
                     f"p95 {lat['p95']} p99 {lat['p99']} ms; availability "
                     f"{art_b['availability']}; {n_b} served results == the engine "
                     f"alone; stream books {books['procs_opened']} opened = "
                     f"{books['procs_closed']} reason-closed, {books['frames']} "
                     f"frames, seq_gaps 0, {books['frames_dropped_by_emitters']} "
                     f"dropped; severed {json.dumps(cut)}; demand by class == the "
                     f"client's books {json.dumps(by_class)}; kill-window capacity "
                     f"loss {cap['kill_window_loss_frac']} over "
                     f"{json.dumps([(k['worker_id'], k['width_s']) for k in cap['kill_windows']])} "
                     f"s, steady-state {cap['steady_state_loss_frac']}; ready walls "
                     f"{fl_b['lifecycle']['ready_walls_s']} s; valid ({path_b}); "
                     f"(b) {time.perf_counter() - t_b:.1f} s | {smi}")
        out["r20"] = {"loss": cap["kill_window_loss_frac"], "p50": lat["p50"],
                      "p99": lat["p99"]}

        # -- (c) r21: a hot spare, the autoscaler, the prefork path ----------
        t_c = time.perf_counter()
        obs_fleet.arm("chip-fleet-r21", transport="tcp")
        wsup = publisher = rsup = client = None
        try:
            wsup, publisher, rsup, client = fabric(
                os.path.join(root, "c"), FleetConfig(
                    spares=FLEET_SPARES, autoscale=True, prefork=True,
                    min_workers=FABRIC_WORKERS, max_workers=FABRIC_WORKERS + 2))
            ctl = wsup.fleet
            if len(ctl.spares) != FLEET_SPARES:
                raise AssertionError(f"fleet (c): spares {ctl.spares}")
            spare0 = ctl.spares[0]
            spare0_wall = round(spare0.t_ready_s - spare0.t_spawned_s, 3)
            art_c, window, victims, by_class, n_c = r20(client, rsup, wsup,
                                                        "chip-fleet-r21", "fleet (c)")
            wait_until(lambda: any(s.state == "ready" for s in ctl.spares),
                       FLEET_BACKFILL_S, "the backfill spare ready")
            read(fleet_addrs(wsup))
            events_c = wsup.summary()["events"]
        except BaseException:
            obs_fleet.disarm("fleet (c) failed")
            raise
        finally:
            stop_fabric(publisher, rsup, wsup)
            if client is not None:
                client.close()
        write_artifact(out_dir, art_c, prefix="GPU_SERVE_FABRIC")
        fl_c, path_c = land_fleet("chip-fleet-r21", art_c, wsup, rsup, window, out_dir)
        el = fl_c["elastic"]
        spare_ids = set(el["spare_ids"])
        serving_ids = ({e["worker_id"] for e in fl_c["lifecycle"]["events"]}
                       | {k["worker_id"] for k in fl_c["capacity"]["kill_windows"]}
                       | {w["worker_id"] for w in art_c["workers"]["stats"]})
        promos = el["promotions"]
        quotas = [q["quota_rps"] for q in el["quota"]["applied"]]
        backfill = [e for e in events_c if e["event"] == "spare_ready"][1:]
        if (len(promos) != 1 or promos[0]["victim"] != "w0"
                or spare_ids & serving_ids
                or not backfill or backfill[0].get("fresh_compiles") != 0
                or any(not str(dd.get("reason") or "").strip()
                       for dd in el["decisions"])
                or any(not 8.0 <= q <= 64.0 for q in quotas)):
            raise AssertionError(f"fleet (c): promotions {promos}; spares "
                                 f"{spare_ids} in {serving_ids}; backfill "
                                 f"{backfill}; decisions {el['decisions']}; quotas "
                                 f"{quotas}")
        forks = thread_gates(events_c, "fleet (c)")
        severed(fl_c, {"router": victims["router"]}, "fleet (c)")
        check_demand(fl_c, by_class, "fleet (c)")
        lat = art_c["latency_ms"]["total"]
        cap = fl_c["capacity"]
        log("fleet", f"(c) r21 (1 hot spare, autoscaler, prefork): {art_c['value']} "
                     f"req/s of {art_c['offered']['offered_rps']} offered; p50 "
                     f"{lat['p50']} p95 {lat['p95']} p99 {lat['p99']} ms; availability "
                     f"{art_c['availability']}, 0 fresh compiles, {n_c} served results "
                     f"== the engine alone; spare s0 ready in {spare0_wall} s through "
                     f"the parent; promotion {json.dumps(promos[0])}; kill-window "
                     f"loss {cap['kill_window_loss_frac']} (b: "
                     f"{out['r20']['loss']}), spare reserve "
                     f"{cap['spare_reserve_worker_s']} worker-s; backfill "
                     f"{backfill[0]['worker_id']} ready in {backfill[0]['wall_s']} s "
                     f"({json.dumps(backfill[0].get('walls'))}); {forks} forks, each "
                     f"at 1 native thread with CUDA uninitialized in the parent; "
                     f"spare ids {sorted(spare_ids)} in no serving book; "
                     f"{len(el['decisions'])} reasoned decisions, quotas {quotas} "
                     f"within [8, 64]; demand by class == the client's books; valid "
                     f"({path_c}); (c) {time.perf_counter() - t_c:.1f} s | {smi}")
        out["r21"] = {"loss": cap["kill_window_loss_frac"],
                      "promotion_s": promos[0]["wall_s"], "spare_s": spare0_wall,
                      "backfill_s": backfill[0]["wall_s"]}

        # -- (d) the autoscaler moving --------------------------------------
        t_d = time.perf_counter()
        obs_fleet.arm("chip-fleet-autoscale", transport="tcp")
        wsup = publisher = rsup = client = None
        try:
            wsup, publisher, rsup, client = fabric(
                os.path.join(root, "d"), FleetConfig(autoscale=True, **FLEET_AUTOSCALE))
            ctl = wsup.fleet
            read(fleet_addrs(wsup))
            t_load0 = mono_now_s()
            art_d = run_fabric_loadgen(client, rsup, wsup, LoadConfig(
                schedule=f"{FLEET_OFFER_S}x{ceiling_rate}", seed=14,
                kinds=("backtest",), class_mix=(("interactive", 1.0),),
                deadline_s=FABRIC_R20["deadline_s"], run_id="chip-fleet-autoscale"))
            t_idle = time.perf_counter()
            read(fleet_addrs(wsup))

            def live():
                return [h for h in wsup.handles if h.state in ("ready", "starting")]

            while time.perf_counter() - t_idle < FLEET_IDLE_S:
                if len(wsup.handles) > FABRIC_WORKERS and \
                        len(live()) == FABRIC_WORKERS and \
                        any(dd["action"] == "scale_down" for dd in ctl.decisions):
                    break
                time.sleep(0.1)
            idle_s = time.perf_counter() - t_idle
            decisions = [dict(dd) for dd in ctl.decisions]
            events_d = wsup.summary()["events"]
            n_ready_end = len(live())
            n_slots = len(wsup.handles)
            read(fleet_addrs(wsup))
            if client.invariant_violations() or inv.validate(art_d):
                raise AssertionError(f"fleet (d): {client.invariant_violations()} "
                                     f"{inv.validate(art_d)}")
        except BaseException:
            obs_fleet.disarm("fleet (d) failed")
            raise
        finally:
            stop_fabric(publisher, rsup, wsup)
            if client is not None:
                client.close()
        write_artifact(out_dir, art_d, prefix="GPU_SERVE_FABRIC")
        fl_d, path_d = land_fleet("chip-fleet-autoscale", art_d, wsup, rsup,
                                  (t_load0, t_load0 + art_d["wall_s"]), out_dir)
        ups = [dd for dd in decisions if dd["action"] == "scale_up"]
        downs = [dd for dd in decisions if dd["action"] == "scale_down"]
        new_id = f"w{FABRIC_WORKERS}"
        new_ready = [e for e in events_d if e["event"] == "ready"
                     and e["worker_id"] == new_id]
        if (not ups or not new_ready or new_ready[0].get("fresh_compiles") != 0
                or n_slots > FLEET_AUTOSCALE["max_workers"]
                or any(not str(dd.get("reason") or "").strip() for dd in decisions)):
            raise AssertionError(f"fleet (d): decisions {decisions}; {new_id} ready "
                                 f"{new_ready}; {n_slots} slots")
        last = decisions[-1]
        log("fleet", f"(d) autoscaler ({FABRIC_WORKERS} workers, floor "
                     f"{FLEET_AUTOSCALE['min_workers']}, ceiling "
                     f"{FLEET_AUTOSCALE['max_workers']}, high watermark "
                     f"{FLEET_AUTOSCALE['high_rps_per_worker']:g} req/s a worker): "
                     f"{FLEET_OFFER_S} s of {ceiling_rate} req/s backtest offered, "
                     f"{art_d['value']} req/s served over {art_d['wall_s']} s; "
                     f"scale_up at {ups[0]['t_s']} s: {ups[0]['reason']} "
                     f"(reading {ups[0]['offered_rps']} req/s); {new_id} spawned by "
                     f"the supervisor (subprocess), ready in "
                     f"{new_ready[0]['wall_s']} s ({json.dumps(new_ready[0].get('walls'))}), "
                     f"fresh_compiles 0; after {idle_s:.1f} s idle "
                     + (f"scale_down at {downs[0]['t_s']} s ({downs[0]['reason']}), "
                        if downs else "no scale_down, ")
                     + f"{n_slots} slots over the run, {n_ready_end} ready or "
                     f"starting at the end (floor {FLEET_AUTOSCALE['min_workers']}"
                     f"{': back at the floor' if n_ready_end == FABRIC_WORKERS else ''}); "
                     f"last decision: {last['action']} ({last['reason']}); "
                     f"{len(decisions)} reasoned decisions; books closed; valid "
                     f"({path_d}); (d) {time.perf_counter() - t_d:.1f} s | {smi}")
        out["autoscale"] = {"up_t_s": ups[0]["t_s"], "new_ready_s": new_ready[0]["wall_s"],
                            "back_to_floor": n_ready_end == FABRIC_WORKERS}

        # -- (e) the CLI, in a subprocess -------------------------------------
        t_e = time.perf_counter()
        argv = ["loadgen", "--fabric", "--fleet", "--spares", "1", "--autoscale",
                "--prefork", "--workers", "2", "--transport", "tcp", "--schedule",
                "1x40", "--kill-worker-after", "0.5", "--out", out_dir, "--run-id",
                "chip-cli-fleet"]
        p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", *argv],
                           cwd=REPO, capture_output=True, text=True, timeout=600)
        serve_path = os.path.join(out_dir, "GPU_SERVE_FABRIC_chip-cli-fleet.json")
        fleet_path = os.path.join(out_dir, "GPU_FLEET_chip-cli-fleet.json")
        if (p.returncode != 0 or inv.validate_file(serve_path)
                or inv.validate_file(fleet_path)):
            raise AssertionError(f"fleet cli: exit {p.returncode}\n{p.stdout[-3000:]}"
                                 f"\n{p.stderr[-3000:]}")
        with open(serve_path) as f:
            cli_forks = thread_gates(json.load(f)["workers"]["events"], "fleet cli")
        with open(fleet_path) as f:
            cli_el = json.load(f)["elastic"]
        if len(cli_el["promotions"]) != 1:
            raise AssertionError(f"fleet cli: promotions {cli_el['promotions']}")
        show = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", "fleet",
                               "chip-cli-fleet", "--root", out_dir], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        if show.returncode != 0 or "worker-tier capacity account" not in show.stdout \
                or "stream books" not in show.stdout:
            raise AssertionError(f"fleet cli: `fleet` exit {show.returncode}\n"
                                 f"{show.stdout[-2000:]}\n{show.stderr[-2000:]}")
        log("fleet", f"(e) {' '.join(argv)}: exit 0 in "
                     f"{time.perf_counter() - t_e:.2f} s, both artifacts valid, "
                     f"{cli_forks} fork(s) at 1 native thread; "
                     + " / ".join(ln.strip() for ln in p.stdout.splitlines()
                                  if ln.startswith(("throughput", "latency",
                                                    "availability", "fleet books",
                                                    "fleet capacity", "elastic:")))
                     + f"; `fleet chip-cli-fleet` exit 0, "
                       f"{len(show.stdout.splitlines())} lines | {smi}")
    finally:
        obs_fleet.disarm("fleet phase over")
        shutil.rmtree(root, ignore_errors=True)
        for pid in forked:
            if os.path.exists(f"/proc/{pid}"):
                try:
                    os.kill(pid, 9)
                except ProcessLookupError:
                    pass
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10.0)

    launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    for st in latest.values():
        for name in launches:
            launches[name] += st["kernel_launches"][name]
    if launches["decile_partial_sums"] < 1 or launches["cohort_partial_sums"]:
        raise AssertionError(f"fleet: worker launches {launches}, expected K1 > 0, "
                             "K2 0")
    out["launches"] = launches
    out["processes"] = len(latest)
    return out


# phase 15: tracing and replay on the card.  Three traced serving cells
# (in-process, the JAX package's TRACE_r17.json pool and TRACE_r19.json
# fabric), each with the trace book armed once its tier is ready; the
# replay of REPLAY_r12.json and of a full session; and the CLI
TRACE_POOL_WORKERS = 2
# TRACE_r17.json's capture: loadgen --pool --workers 2 --schedule bursty
# --trace --kill-worker-after 2
TRACE_POOL_KILL_S = 2.0
# REPLAY_r12.json's configuration (its capacity == bars: no eviction);
# its tick, panel and version books are set by event time and the seed
REPLAY_R12 = dict(seed=12, n_assets=32, bars=96, capacity=96, serve_every_bars=6,
                  reconcile_every_bars=16, profile="serve")
# a full US session of one-minute bars over the largest serve bucket; the
# default capacity (3/4 of the log) wraps the ring
REPLAY_DAY = dict(seed=12, n_assets=128, bars=390, serve_every_bars=6,
                  reconcile_every_bars=16, profile="serve")
TRACE_STITCHED = ("route", "transport", "queue_wait", "dispatch", "finalize")


def armed_cost(cell: dict, lat: dict, off, what: str) -> str:
    """Armed minus disarmed p50/p99 of one cell, recorded in ``cell``;
    the text for its log line."""
    if off is None:
        return "armed - disarmed: not measured (the disarmed run did not run)"
    cell["cost_ms"] = {q: round(lat[q] - off[q], 3) for q in ("p50", "p99")}
    return (f"armed - disarmed: p50 {cell['cost_ms']['p50']:+.3f} ms, p99 "
            f"{cell['cost_ms']['p99']:+.3f} ms against {what} p50 {off['p50']} "
            f"p99 {off['p99']} ms")


def stage_table(tart) -> dict:
    """``{stage: [p50, p95, p99]}`` of a trace artifact, and the stage with
    the largest p99 (the one that sets the tail)."""
    rows = {k: [v["p50"], v["p95"], v["p99"]] for k, v in tart["stages"].items()}
    tail = max(rows, key=lambda k: rows[k][2] or 0.0) if rows else None
    return {"stages": rows, "tail": tail}


def trace_replay_phase(smi, out_dir, disarmed) -> dict:
    """Phase 15: tracing and replay on the card.  ``disarmed`` holds the
    total latency of the same cells run with tracing disarmed earlier in
    the call, ``{"inproc": phase 11's bursty, "fabric": phase 13's r20}``
    (None when the phase runs alone).
    Returns the K1/K2 launches of the traced runs (this process's and the
    workers', through their ``stats``) and of the replay windows, and
    each cell's figures."""
    import contextlib
    import io
    import shutil

    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.chaos.plan import PLAN_ENV
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.cli.serve import _kill_w0_after, _land_trace
    from csmom_tpu_torch.obs import trace as obs_trace
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.fabric import build_fabric, kill_mid_burst, stop_fabric
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig, resolve_schedule, run_fabric_loadgen, run_loadgen,
        run_pool_loadgen, write_artifact,
    )
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService
    from csmom_tpu_torch.serve.supervisor import (
        PoolConfig, PoolSupervisor, pick_transport,
    )
    from csmom_tpu_torch.stream.replay import (
        ReplayConfig, builtin_fault_plan, run_replay,
    )

    out = {}
    first: dict = {}   # pid -> a worker's first stats reply of the phase
    last: dict = {}    # pid -> its latest

    def read_workers(sup) -> dict:
        now = pool_stats(sup)
        for pid, st in now.items():
            first.setdefault(pid, st)
            last[pid] = st
        return now

    def land(book, run_id, art, what):
        if _land_trace(book, run_id, art, out_dir):
            raise AssertionError(f"{what}: the trace books are broken")
        path = os.path.join(out_dir, f"GPU_TRACE_{run_id}.json")
        with open(path) as f:
            tart = json.load(f)
        req, books = art["requests"], tart["books"]
        if (books["opened"] != req["admitted"] or books["complete"] != req["served"]
                or books["partial"] != req["rejected"] + req["expired"]
                or tart["reconcile"]["violations"]
                or tart["reconcile"]["max_abs_residual_ms"] > obs_trace.EPSILON_MS):
            raise AssertionError(f"{what}: books {books} against requests {req}; "
                                 f"reconcile {tart['reconcile']}")
        return tart, path

    schedule, schedule_kind, preset = resolve_schedule("bursty")
    t_phase = time.perf_counter()

    # -- (a) in-process: SignalService on the card, traced ------------------
    t_a = time.perf_counter()
    svc = SignalService(ServeConfig(profile="serve", engine="torch"))
    svc.start()
    kernels.reset_launches()
    book = obs_trace.arm_tracing(seed=0)
    try:
        art = run_loadgen(svc, LoadConfig(schedule=schedule, schedule_kind=schedule_kind,
                                          seed=0, run_id="chip-trace-inproc", **preset))
    except BaseException:
        obs_trace.disarm_tracing()
        raise
    k1 = kernels.decile_partial_sums.launches
    k2 = kernels.cohort_partial_sums.launches
    batches = svc.batch_stats()["engine_calls"].get("backtest", 0)
    write_artifact(out_dir, art, prefix="GPU_SERVE")
    tart, path = land(book, "chip-trace-inproc", art, "trace (a)")
    if (inv.validate(art) or art["compile"]["in_window_fresh_compiles"] != 0
            or k1 != batches or batches < 1 or k2):
        raise AssertionError(f"trace (a): {inv.validate(art)}; fresh "
                             f"{art['compile']['in_window_fresh_compiles']!r}; K1 {k1} "
                             f"against {batches} backtest batches, K2 {k2}")
    launches = {"decile_partial_sums": k1, "cohort_partial_sums": 0}
    st = stage_table(tart)
    lat = art["latency_ms"]["total"]
    out["inproc"] = {"p50": lat["p50"], "p99": lat["p99"], "tail": st["tail"]}
    cost = armed_cost(out["inproc"], lat, disarmed and disarmed["inproc"],
                      "phase 11's disarmed bursty")
    log("trace", f"(a) in-process bursty seed 0, traced: {art['value']} req/s of "
                 f"{art['offered']['offered_rps']} offered; p50 {lat['p50']} p95 "
                 f"{lat['p95']} p99 {lat['p99']} ms ({cost}); books {json.dumps(tart['books'])} "
                 f"== requests; reconcile {json.dumps(tart['reconcile'])}; stage "
                 f"p50/p95/p99 ms {json.dumps(st['stages'])}, the tail's stage "
                 f"{st['tail']}; padding {json.dumps({k: v['pad_fraction'] for k, v in tart['padding'].items()})}; "
                 f"K1 {k1} == backtest batches {batches}, K2 0; valid ({path}); "
                 f"(a) {time.perf_counter() - t_a:.1f} s | {smi}")

    # -- (b) TRACE_r17.json's pool: 2 torch workers, w0 SIGKILLed 2 s in ----
    t_b = time.perf_counter()
    run_dir = tempfile.mkdtemp(prefix="csmom-trace-pool-")
    sup = PoolSupervisor(PoolConfig(
        n_workers=TRACE_POOL_WORKERS, profile="serve", engine="torch", device="cuda",
        transport=pick_transport(run_dir), require_warm_cache=True), run_dir)
    router = book = None
    pool_preset = {"class_mix": preset.get("class_mix")}
    try:
        sup.start()
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve", default_deadline_s=0.5, hedge_fraction=POOL_HEDGE_FRACTION),
            retry_after_fn=sup.retry_after_s)
        before = read_workers(sup)
        book = obs_trace.arm_tracing(seed=0)
        art = run_pool_loadgen(router, sup, LoadConfig(
            schedule=schedule, schedule_kind=schedule_kind, seed=0, deadline_s=0.5,
            run_id="chip-trace-pool", **pool_preset),
            concurrent=_kill_w0_after(sup, TRACE_POOL_KILL_S))
        after = read_workers(sup)
    except BaseException:
        obs_trace.disarm_tracing()
        raise
    finally:
        sup.stop()
        if router is not None:
            router.channels.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    write_artifact(out_dir, art, prefix="GPU_SERVE_POOL")
    tart, path = land(book, "chip-trace-pool", art, "trace (b)")
    d = pool_deltas(before, after)
    conn = router.accounting()["worker_conn_failures"]
    orphans = tart["orphans"]
    pool = art["pool"]
    missing = [s for s in TRACE_STITCHED if s not in tart["stages"]]
    if (inv.validate(art) or router.invariant_violations() or missing
            or art["compile"]["in_window_fresh_compiles"] != 0
            or art["requests"]["rejected_infra"] or pool["kills"] != 1
            or orphans["count"] != conn
            or any(not r.startswith("w0:") for r in orphans["reasons"])
            or d["k1"] != d["backtest_calls"] or d["k2"] or d["libraries"]):
        raise AssertionError(f"trace (b): {inv.validate(art)} "
                             f"{router.invariant_violations()}; stitched stages "
                             f"missing {missing}; requests {art['requests']}; kills "
                             f"{pool['kills']}; orphans {orphans} against {conn} "
                             f"connection failures; workers {d}")
    st = stage_table(tart)
    lat = art["latency_ms"]["total"]
    out["pool"] = {"p50": lat["p50"], "p99": lat["p99"], "tail": st["tail"],
                   "orphans": orphans["count"]}
    log("trace", f"(b) r17 pool, {TRACE_POOL_WORKERS} torch workers (the reference "
                 f"ran jax-mesh workers, the multi-GPU layer), bursty seed 0, w0 "
                 f"SIGKILLed {TRACE_POOL_KILL_S} s in: {art['value']} req/s of "
                 f"{art['offered']['offered_rps']} offered; p50 {lat['p50']} p95 "
                 f"{lat['p95']} p99 {lat['p99']} ms; requests "
                 f"{json.dumps(art['requests'])}; books {json.dumps(tart['books'])}; "
                 f"orphan halves {json.dumps(orphans)} == the router's {conn} worker "
                 f"connection failures; reconcile {json.dumps(tart['reconcile'])}; "
                 f"stage p50/p95/p99 ms {json.dumps(st['stages'])}, the tail's stage "
                 f"{st['tail']}; the surviving workers' K1 {d['k1']} == their backtest "
                 f"batches {d['backtest_calls']}; valid ({path}); "
                 f"(b) {time.perf_counter() - t_b:.1f} s | {smi}")

    # -- (c) TRACE_r19.json's fabric: r20's cell with the books armed -------
    t_c = time.perf_counter()
    run_dir = tempfile.mkdtemp(prefix="csmom-trace-fabric-")
    wsup = publisher = rsup = client = book = None
    try:
        wsup, publisher, rsup, client = build_fabric(
            PoolConfig(n_workers=FABRIC_WORKERS, profile="serve", engine="torch",
                       device="cuda", transport="tcp", require_warm_cache=True),
            PoolConfig(n_workers=FABRIC_ROUTERS, profile="serve", engine="stub",
                       transport="tcp"),
            run_dir, deadline_ms=1e3 * FABRIC_R20["deadline_s"], trace=True,
            client_deadline_s=FABRIC_R20["deadline_s"])

        def double_kill():
            if not kill_mid_burst([(FABRIC_KILL_ROUTER_S, rsup, "router"),
                                   (FABRIC_KILL_WORKER_S, wsup, "worker")],
                                  settle_timeout_s=wsup.config.ready_timeout_s):
                raise AssertionError("trace (c): a killed tier never demonstrated "
                                     "ready again")

        before = read_workers(wsup)
        book = obs_trace.arm_tracing(seed=0)
        art = run_fabric_loadgen(client, rsup, wsup, LoadConfig(
            run_id="chip-trace-fabric", **FABRIC_R20), concurrent=double_kill)
        after = read_workers(wsup)
    except BaseException:
        obs_trace.disarm_tracing()
        raise
    finally:
        stop_fabric(publisher, rsup, wsup)
        if client is not None:
            client.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    write_artifact(out_dir, art, prefix="GPU_SERVE_FABRIC")
    tart, path = land(book, "chip-trace-fabric", art, "trace (c)")
    d = pool_deltas(before, after)
    orphans = tart["orphans"]
    conn = art["requests"]["router_conn_failures"]
    tiers = {t: {k: art[t][k] for k in ("kills", "restarts", "ready_end")}
             for t in ("routers", "workers")}
    replicas = {}
    viols = inv.validate(art)
    for r in art["routers"]["replicas"]:
        tr = r.get("trace")
        if r["state"] != "ready":
            continue
        if tr is None or r.get("torch_loaded") is not False:
            viols.append(f"replica {r['router_id']}: trace {tr}, torch_loaded "
                         f"{r.get('torch_loaded')}")
            continue
        b = tr["snapshot"]["books"]
        viols += [f"replica {r['router_id']}: {v}" for v in tr["invariant_violations"]]
        if b["opened"] != b["complete"] + b["partial"]:
            viols.append(f"replica {r['router_id']} trace books open: {b}")
        replicas[f"{r['router_id']}g{r['generation']}"] = {
            "books": b, "orphans": tr["snapshot"]["orphans"]["count"],
            "worker_conn_failures": r["accounting"]["worker_conn_failures"]}
    missing = [s for s in TRACE_STITCHED if s not in tart["stages"]]
    if (viols or missing or art["availability"] != 1.0
            or art["compile"]["in_window_fresh_compiles"] != 0
            or tiers["routers"]["kills"] != 1 or tiers["workers"]["kills"] != 1
            or orphans["count"] != conn
            or any(not r.startswith("r0:") for r in orphans["reasons"])
            or d["k1"] != d["backtest_calls"] or d["k2"] or d["libraries"]):
        raise AssertionError(f"trace (c): {viols}; stitched stages missing "
                             f"{missing}; requests {art['requests']}; tiers {tiers}; "
                             f"orphans {orphans} against {conn} router connection "
                             f"failures; workers {d}")
    st = stage_table(tart)
    lat = art["latency_ms"]["total"]
    out["fabric"] = {"p50": lat["p50"], "p99": lat["p99"], "tail": st["tail"],
                     "orphans": orphans["count"]}
    cost = armed_cost(out["fabric"], lat, disarmed and disarmed["fabric"],
                      "phase 13's disarmed r20")
    log("trace", f"(c) r19 fabric ({FABRIC_ROUTERS} traced routers x {FABRIC_WORKERS} "
                 f"workers over tcp, r0 SIGKILLed {FABRIC_KILL_ROUTER_S} s and w0 "
                 f"{FABRIC_KILL_WORKER_S} s in): {art['value']} req/s of "
                 f"{art['offered']['offered_rps']} offered; p50 {lat['p50']} p95 "
                 f"{lat['p95']} p99 {lat['p99']} ms ({cost}); requests "
                 f"{json.dumps(art['requests'])}; availability {art['availability']}; "
                 f"tiers {json.dumps(tiers)}; client books "
                 f"{json.dumps(tart['books'])}, every trace reason-closed; orphan "
                 f"halves {json.dumps(orphans)} == the client's {conn} router "
                 f"connection failures; replica books {json.dumps(replicas)}, torch "
                 f"never loaded; reconcile {json.dumps(tart['reconcile'])}; stage "
                 f"p50/p95/p99 ms {json.dumps(st['stages'])}, the tail's stage "
                 f"{st['tail']}; the surviving workers' K1 {d['k1']} == their backtest "
                 f"batches {d['backtest_calls']}; valid ({path}); "
                 f"(c) {time.perf_counter() - t_c:.1f} s | {smi}")
    for pid, st_last in last.items():
        for name in launches:
            launches[name] += (st_last["kernel_launches"][name]
                               - first[pid]["kernel_launches"][name])

    # -- (d) and (e) replay: REPLAY_r12.json's configuration and a session --
    with open(os.path.join(REPO, "REPLAY_r12.json")) as f:
        ref = json.load(f)
    warm_k1 = len(bucket_spec("serve").shapes())   # the warm-up's backtest shapes
    replay_launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    for label, run_id, kw in (("(d) r12", "chip-replay-r12", REPLAY_R12),
                              ("(e) day", "chip-replay-day", REPLAY_DAY)):
        t_r = time.perf_counter()
        cfg = ReplayConfig(run_id=run_id, engine="torch", **kw)
        saved = os.environ.get(PLAN_ENV)
        os.environ[PLAN_ENV] = builtin_fault_plan(cfg).to_toml()
        inject.reset()
        kernels.reset_launches()
        try:
            rep = run_replay(cfg)
        finally:
            if saved is None:
                os.environ.pop(PLAN_ENV, None)
            else:
                os.environ[PLAN_ENV] = saved
            inject.reset()
        k1 = kernels.decile_partial_sums.launches - warm_k1
        k2 = kernels.cohort_partial_sums.launches
        replay_launches["decile_partial_sums"] += k1
        replay_launches["cohort_partial_sums"] += k2
        path = write_artifact(out_dir, rep, prefix="GPU_REPLAY")
        rec = rep["reconcile"]
        viols = inv.validate(rep)
        if label.startswith("(d)"):
            for block in ("ticks", "panel", "versions"):
                if rep[block] != ref[block]:
                    viols.append(f"{block} {rep[block]} != REPLAY_r12.json's "
                                 f"{ref[block]}")
        elif not (rep["panel"]["evictions"] and rec["reanchors"]):
            viols.append(f"the ring never wrapped: panel {rep['panel']}, reconcile "
                         f"{rec}")
        if (viols or rec["drift_events"] or not rec["engine_checks"]
                or rep["compile"]["in_window_fresh_compiles"] != 0 or k1 or k2
                or rep["extra"]["platform"] != "gpu"):
            raise AssertionError(f"replay {label}: {viols}; reconcile {rec}; fresh "
                                 f"{rep['compile']['in_window_fresh_compiles']!r}; "
                                 f"window launches K1 {k1} K2 {k2}; platform "
                                 f"{rep['extra']['platform']}")
        out[run_id] = {"ticks_per_s": rep["value"], "staleness_ms": rep["staleness_ms"],
                       "reconcile": rec, "wall_s": rep["wall_s"]}
        log("replay", f"{label}: {rep['extra']['workload']}, capacity "
                      f"{rep['panel']['capacity']}, builtin chaos: {rep['value']} "
                      f"ticks/s over {rep['wall_s']} s; ticks {json.dumps(rep['ticks'])}; "
                      f"panel {json.dumps(rep['panel'])}; versions "
                      f"{json.dumps(rep['versions'])}"
                      + (" == REPLAY_r12.json's" if label.startswith("(d)") else "")
                      + f"; reconcile {json.dumps(rec)}"
                      + (f" (the reference's CPU engine_max_abs_diff "
                         f"{ref['reconcile']['engine_max_abs_diff']})"
                         if label.startswith("(d)") else "")
                      + f"; staleness ms {json.dumps(rep['staleness_ms'])}; serve "
                        f"{json.dumps(rep['serve'])}; 0 kernels built, window "
                        f"launches K1 0 K2 0 (warm-up K1 {warm_k1}); valid ({path}); "
                        f"{time.perf_counter() - t_r:.1f} s | {smi}")

    # -- (f) the CLI ---------------------------------------------------------
    t_f = time.perf_counter()
    argv = ["loadgen", "--trace", "--schedule", "bursty", "--out", out_dir,
            "--run-id", "chip-cli-trace"]
    p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    if (p.returncode != 0 or "trace artifact: " not in p.stdout
            or inv.validate_file(os.path.join(out_dir, "GPU_TRACE_chip-cli-trace.json"))):
        raise AssertionError(f"trace cli: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    log("trace", f"(f) {' '.join(argv)}: exit 0 in {time.perf_counter() - t_f:.2f} s; "
                 + " / ".join(ln.strip() for ln in p.stdout.splitlines()
                              if ln.startswith(("throughput", "latency", "trace books")))
                 + f" | {smi}")

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        return rc, buf.getvalue()

    rendered = {}
    for run_id in ("chip-trace-inproc", "chip-trace-pool", "chip-trace-fabric",
                   "chip-cli-trace"):
        a = run_cli(["trace", run_id, "--root", out_dir])
        b = run_cli(["trace", os.path.join(out_dir, f"GPU_TRACE_{run_id}.json")])
        if a[0] != 0 or a != b or "per-stage decomposition" not in a[1]:
            raise AssertionError(f"trace cli: `trace {run_id}` exit {a[0]}/{b[0]}, "
                                 f"renderings equal {a == b}\n{a[1][-2000:]}")
        rendered[run_id] = len(a[1].splitlines())
    t_r = time.perf_counter()
    rc, text = run_cli(["replay", "--chaos", "builtin", "--out-dir", out_dir,
                        "--run-id", "chip-cli-replay"])
    if (rc != 0 or "stale request(s) refused" not in text
            or inv.validate_file(os.path.join(out_dir, "GPU_REPLAY_chip-cli-replay.json"))):
        raise AssertionError(f"replay cli: exit {rc}\n{text[-3000:]}")
    replay_wall = time.perf_counter() - t_r
    rc1, listing = run_cli(["registry", "list"])
    rc2, endpoints = run_cli(["registry", "list", "--endpoints"])
    if (rc1 or rc2 or endpoints.split() != list(serve_endpoints())
            or "serve (5):" not in listing or "strategy (" not in listing):
        raise AssertionError(f"registry cli: exit {rc1}/{rc2}\n{listing}\n{endpoints}")
    swept = inv.validate_tree(out_dir, ("GPU_TRACE_*.json", "GPU_REPLAY_*.json"))
    if len(swept) < 7 or any(swept.values()):
        raise AssertionError(f"trace and replay artifacts: {swept}")
    log("trace", f"(f) `trace <run>` on {len(rendered)} artifacts, each rendered twice "
                 f"(by run id and by path) to the same text, lines {json.dumps(rendered)}; "
                 f"`replay --chaos builtin` exit 0 in {replay_wall:.2f} s ("
                 + " / ".join(ln.strip() for ln in text.splitlines()
                              if ln.startswith(("ticks:", "versions:", "throughput")))
                 + f"); `registry list` {len(listing.splitlines())} lines, "
                   f"`--endpoints` {endpoints.split()}; {len(swept)} GPU_TRACE_/"
                   f"GPU_REPLAY_ artifacts valid | {smi}")
    out["launches"] = launches
    out["replay_launches"] = replay_launches
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# phase 16: the warm-start and the examples on the card.  The profiles
# both warm-ups run (the bench and golden shapes, the serving grid, the
# replay's reconcile shapes) and the report namespace they write under
WARM_PROFILES = "bench-gpu,golden,serve,stream"
WARM_SUBDIR = "smoke"
# the golden-event leg's entries on the card: threshold plain and donated,
# hysteresis and the 32-wide batch (compile/manifest.py::golden_event_entries)
GOLDEN_EVENT_ENTRIES = 4
# the donated entries of WARM_PROFILES' manifests and the golden-event leg
# (bench-gpu's grid, the golden threshold engine), each warmed by two calls
# on inputs of their own
DONATED_ENTRIES = 2
# the four --data-dir examples, run on one synthetic 20-ticker directory
DATA_DIR_EXAMPLES = ("replicate_reference", "strategy_zoo", "cost_frontier",
                     "causal_scoring")
_NUMBER = re.compile(r"[-+]?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


def printed_equal(a: str, b: str, what: str) -> None:
    """Two printouts agree: the same words around their numbers, integers
    equal, and every other number within one unit of its last printed
    digit (so a rounding boundary between two devices' sums passes, and
    nothing more)."""
    na, nb = _NUMBER.findall(a), _NUMBER.findall(b)
    if _NUMBER.split(a) != _NUMBER.split(b) or len(na) != len(nb):
        raise AssertionError(f"{what}: the printouts differ in their words:\n"
                             f"{a}\n---\n{b}")
    for x, y in zip(na, nb):
        mant, _, exp = x.lower().partition("e")
        dec = len(mant.partition(".")[2])
        tol = 0.0 if not dec and not exp else 1.01 * 10.0 ** (int(exp or 0) - dec)
        if abs(float(x.replace(",", "")) - float(y.replace(",", ""))) > tol:
            raise AssertionError(f"{what}: {x} against {y} (limit {tol})")


def run_example(name: str, argv: list):
    """``csmom_tpu_torch.examples.<name>.main(argv)`` with its stdout
    captured: ``(stdout, AssertionError or None, wall s)``."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"csmom_tpu_torch.examples.{name}")
    buf, err = io.StringIO(), None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
    except AssertionError as e:  # a golden assert of the reference data
        err = e
    return buf.getvalue(), err, time.perf_counter() - t0


def run_warmup(cwd: str, tmpdir: str, profiles: str = WARM_PROFILES,
               subdir: str = WARM_SUBDIR) -> tuple:
    """``warmup --profiles PROFILES --strict`` in a process of its own
    whose package is the one under ``cwd`` (its kernel libraries in
    ``cwd/build/csmom_tpu_torch``): ``(report, stdout, wall s)``."""
    env = {**os.environ, "PYTHONPATH": cwd, "TMPDIR": tmpdir}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", "warmup",
                        "--profiles", profiles, "--strict",
                        "--cache-subdir", subdir],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"warmup in {cwd} exited {p.returncode}:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    path = os.path.join(cwd, "build", "csmom_tpu_torch", "warmup", subdir,
                        "warmup_report.json")
    with open(path) as f:
        return json.load(f), p.stdout, wall


def check_warm_report(report, want_entries: int, what: str) -> None:
    """A warm-up report lists every manifest entry and the golden-event
    entries, and its grid input build and golden-event leg both ran."""
    golden = sum(r.get("profile") == "golden-event" for r in report["entries"])
    donated = [r.get("donated_calls") for r in report["entries"]
               if ".donated@" in r["name"]]
    if donated != [2] * DONATED_ENTRIES:
        raise AssertionError(f"{what}: the donated entries' calls {donated}, "
                             f"want {DONATED_ENTRIES} entries of 2 consuming calls")
    if (report["n_entries"] != want_entries or golden != GOLDEN_EVENT_ENTRIES
            or not report["input_builders"].startswith("grid month panels built")
            or report["golden_event"] != "resolved from the golden input build"):
        raise AssertionError(
            f"{what}: {report['n_entries']} entries ({golden} golden-event), "
            f"want {want_entries} ({GOLDEN_EVENT_ENTRIES}); inputs: "
            f"{report['input_builders']}; golden event: {report['golden_event']}")


def warm_launches(report) -> dict:
    """The kernels' launches over a warm-up's entries (each record counts
    its own process's launches over its two calls)."""
    out = {"decile_partial_sums": 0, "cohort_partial_sums": 0, "rank_labels": 0}
    for r in report["entries"]:
        for k, v in r.get("launches", {}).items():
            out[k] += v
    return out


NORTH_STAR_REPS = 9


def north_star_grid_ms(dev) -> float:
    """What ``examples.north_star_grid --assets 3000 --years 60 --impl
    kernel`` times, at finer resolution than the 1 ms it prints: the
    median wall of one grid call whose mean spreads are fetched to the
    host, over ``NORTH_STAR_REPS`` synchronized reps after one untimed."""
    import statistics

    import torch

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import to_tensors
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.utils.profiling import fetch, wall

    # the example's own panel (seed 7, staggered listings) and call
    panel = synthetic_daily_panel(3000, 60 * 252, seed=7, listing_gaps=True)
    seg, ends = month_end_segments(panel.times)
    v, m = to_tensors(panel.values, panel.mask, device=dev, dtype=torch.float32)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    Js = Ks = np.array([3, 6, 9, 12])

    def grid_means():
        return fetch(jk_grid_backtest(pm, mm, Js, Ks, skip=1, mode="rank",
                                      impl="kernel").mean_spread)

    walls = [wall(grid_means, warmup=1 if i == 0 else 0)[1]
             for i in range(NORTH_STAR_REPS)]
    return statistics.median(walls) * 1e3


def warmup_phase(smi, assert_sums) -> dict:
    """Phase 16: the warm-start and the examples on the card.  Returns the
    phase's kernel launches, its numbers and its wall."""
    import shutil

    import torch

    from csmom_tpu_torch.backtest.monthly import formation_labels
    from csmom_tpu_torch.compile.aot import read_warmup_report
    from csmom_tpu_torch.compile.manifest import build_manifest
    from csmom_tpu_torch.examples._synthetic_data import write_data_dir
    from csmom_tpu_torch.ops import build, kernels
    from csmom_tpu_torch.ops.ranking import decile_assign_panel
    from csmom_tpu_torch.signals.momentum import (
        formation_listed_mask, momentum_dynamic, monthly_returns,
    )
    from csmom_tpu_torch.workloads import GRID_JS, GRID_SKIP

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory(prefix="csmom_warm_") as tmp:
        tmpdir = os.path.join(tmp, "tmp")
        os.makedirs(tmpdir)
        # (a) cold: a copy of the package whose build directory is empty
        pkg = os.path.join(tmp, "pkg")
        shutil.copytree(os.path.join(REPO, "csmom_tpu_torch"),
                        os.path.join(pkg, "csmom_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cold, _, cold_s = run_warmup(pkg, tmpdir)
        want_entries = GOLDEN_EVENT_ENTRIES + sum(
            len(build_manifest(p)) for p in WARM_PROFILES.split(","))
        check_warm_report(cold, want_entries, "warmup (a) cold")
        built = cold["totals"]["libraries_built"]
        if cold["n_errors"] or built != len(build.KERNELS):
            raise AssertionError(f"warmup (a) cold: {cold['n_errors']} errors, "
                                 f"{built} libraries built (want 0 and "
                                 f"{len(build.KERNELS)})")
        if sorted(r["name"] for r in cold["entries"] if not r["cache_hit"]) != sorted(
                r["name"] for r in cold["entries"] if r["libraries_built"]):
            raise AssertionError("warmup (a) cold: cache_hit disagrees with the builds")
        for r in cold["entries"]:
            mem = r["memory"]
            if not isinstance(mem, dict) or not isinstance(mem.get("peak_bytes"), int):
                raise AssertionError(f"warmup (a): {r['name']} has no memory peak: {mem}")
            log("warm", f"cold {r['name']}: peak {mem['peak_bytes']} B (args "
                        f"{mem['argument_size_in_bytes']}, out "
                        f"{mem['output_size_in_bytes']}, temp "
                        f"{mem['temp_size_in_bytes']}), build {r['build_s']:.3f} s, "
                        f"first call {r['first_call_s'] * 1e3:.3f} ms, warm call "
                        f"{r['warm_call_s'] * 1e3:.3f} ms, launches {r['launches']}")
        log("warm", f"(a) cold: {cold['n_entries']} entries, {built} libraries "
                    f"built, 0 errors; command wall {cold_s:.1f} s, report wall "
                    f"{cold['wall_s']} s; {cold['input_builders']}; golden event: "
                    f"{cold['golden_event']}; max peak {json.dumps(cold['memory'])} | {smi}")

        # (b) warm: the same in the tree, whose libraries phase 2 built
        warm, warm_out, warm_s = run_warmup(REPO, tmpdir)
        check_warm_report(warm, want_entries, "warmup (b) warm")
        n = warm["n_entries"]
        if (warm["n_errors"] or warm["n_cache_hits"] != n
                or warm["totals"]["libraries_built"] != 0
                or [r["name"] for r in warm["entries"]]
                != [r["name"] for r in cold["entries"]]):
            raise AssertionError(f"warmup (b) warm: {warm['n_cache_hits']} of {n} hit, "
                                 f"{warm['n_errors']} errors, "
                                 f"{warm['totals']['libraries_built']} built")
        if read_warmup_report(WARM_SUBDIR) != warm:
            raise AssertionError("warmup (b): the report read back differs")
        if f"{n} entries, {n} served from cache, 0 errors" not in warm_out:
            raise AssertionError("warmup (b): the CLI's summary line is missing")
        for r in warm["entries"]:
            log("warm", f"warm {r['name']}: peak {r['memory']['peak_bytes']} B, "
                        f"first call {r['first_call_s'] * 1e3:.3f} ms, warm call "
                        f"{r['warm_call_s'] * 1e3:.3f} ms")
        log("warm", f"(b) warm: {n} of {n} entries hit, 0 built; command wall "
                    f"{warm_s:.1f} s, report wall {warm['wall_s']} s | {smi}")
        launches = {k: v + warm_launches(warm)[k]
                    for k, v in warm_launches(cold).items()}
        if min(launches.values()) < 1:
            raise AssertionError(f"warmup: a kernel was not launched: {launches}")
        out.update(warmup_cold_s=cold_s, warmup_warm_s=warm_s,
                   warmup_max_peak_bytes=warm["memory"]["max_peak_bytes"],
                   warmup_launches=launches,
                   warmup_entries={r["name"]: {
                       "cold_first_call_ms": c["first_call_s"] * 1e3,
                       "warm_first_call_ms": r["first_call_s"] * 1e3,
                       "warm_call_ms": r["warm_call_s"] * 1e3,
                       "peak_bytes": r["memory"]["peak_bytes"]}
                       for c, r in zip(cold["entries"], warm["entries"])})

        # (c) each kernel against its plain version at one warmed shape, on
        # the warm-up's own inputs (seed 0)
        gpu = {e.name: e for e in build_manifest("bench-gpu")}
        grid_e = gpu["grid.jk16.rank.kernel@3000x696"]
        (p, m), _ = grid_e.materialize(dev, np.random.default_rng(0))
        ret, ret_valid = monthly_returns(p, m)
        mom, mv = momentum_dynamic(p, m, torch.tensor(GRID_JS, device=dev), GRID_SKIP)
        mv = mv & formation_listed_mask(m, GRID_SKIP)
        lab, _ = decile_assign_panel(torch.where(mv, mom, torch.nan), mv,
                                     n_bins=10, mode="rank")
        s2, c2 = kernels.cohort_partial_sums(ret, ret_valid, lab, 10, 12)
        p2, pc2 = kernels.cohort_partial_sums_plain(ret, ret_valid, lab, 10, 12)
        ab2, _ = kernels.cohort_partial_sums_plain(
            torch.where(ret_valid, torch.nan_to_num(ret), 0.0).abs(), ret_valid, lab, 10, 12)
        if not torch.equal(c2, pc2):
            raise AssertionError("warmup (c): K2 counts differ from plain")
        assert_sums(s2, p2, ab2, ret.dtype, "warmup (c): K2 sums at 3000x696")
        mon_e = {e.name: e for e in build_manifest("golden")}["monthly.spread@20x60"]
        (p, m), kw = mon_e.materialize(dev, np.random.default_rng(0))
        ret, ret_valid, labels = formation_labels(p, m, kw["lookback"], kw["skip"],
                                                  kw["n_bins"], kw["mode"])
        nxt = torch.roll(ret, -1, dims=1)
        nv = torch.roll(ret_valid, -1, dims=1)
        nv[:, -1] = False
        lab1 = torch.where(nv & (labels >= 0), labels, -1)
        r1 = torch.where(lab1 >= 0, torch.nan_to_num(nxt), 0.0)
        s1, c1 = kernels.decile_partial_sums(r1, lab1, 10)
        p1, pc1 = kernels.decile_partial_sums_plain(r1, lab1, 10)
        ab1, _ = kernels.decile_partial_sums_plain(r1.abs(), lab1, 10)
        if not torch.equal(c1, pc1):
            raise AssertionError("warmup (c): K1 counts differ from plain")
        assert_sums(s1, p1, ab1, r1.dtype, "warmup (c): K1 sums at 20x60 f64")
        out["warm_shape_errors"] = {"decile_partial_sums": (s1 - p1).abs().max().item(),
                                    "cohort_partial_sums": (s2 - p2).abs().max().item()}
        log("warm", f"(c) launches over (a)-(b) {launches}; at warmed shapes K1 "
                    f"[20, 60] f64 and K2 [4, 3000, 696] f32 equal their plain "
                    f"versions (max |err| {out['warm_shape_errors']})")

        # (d) and (e): the examples, launch counts read around them
        data = os.path.join(tmp, "data")
        write_data_dir(data)
        kernels.reset_launches()
        ns_argv = ["--assets", "3000", "--years", "60"]
        ns, err, ns_s = run_example("north_star_grid", ns_argv + ["--impl", "kernel"])
        k2_ns = kernels.cohort_partial_sums.launches
        default, err2, _ = run_example("north_star_grid", [])
        if err or err2 or k2_ns < 1 or "walk-forward" not in ns:
            raise AssertionError(f"examples (d): north_star_grid failed ({err}, "
                                 f"{err2}; K2 launches {k2_ns})")
        ns_plain, err4, _ = run_example("north_star_grid", ns_argv + ["--impl", "plain"])
        if err4:
            raise AssertionError(f"examples (d): the plain north-star run failed: {err4}")
        printed_equal("\n".join(ns.splitlines()[1:]),
                      "\n".join(ns_plain.splitlines()[1:]),
                      "examples (d): north_star_grid 3000x60 kernel against plain")
        cpu_run, err3, _ = run_example("north_star_grid", ["--device", "cpu"])
        if err3:
            raise AssertionError(f"examples (d): the CPU run failed: {err3}")
        printed_equal("\n".join(default.splitlines()[1:]),
                      "\n".join(cpu_run.splitlines()[1:]),
                      "examples (d): north_star_grid 512x15 cuda against cpu")
        log("examples", f"(d) north_star_grid 3000 x 60 yr, impl kernel: "
                        f"{ns.splitlines()[0]} (K2 launches {k2_ns}; script wall "
                        f"{ns_s:.1f} s); its table equals --impl plain's; its 512 x "
                        f"15 table on cuda equals --device cpu | {smi}")
        for line in ns.splitlines()[1:]:
            if line.strip():
                log("examples", f"north_star_grid 3000x60: {line}")
        pk, err, pk_s = run_example("pack_at_scale", [])
        if err or "bit-identical" not in pk:
            raise AssertionError(f"examples (e): pack_at_scale: {err}")
        log("examples", f"(e) pack_at_scale: {' | '.join(pk.splitlines())}")
        for name in DATA_DIR_EXAMPLES:
            got, gerr, g_s = run_example(name, ["--data-dir", data])
            want, werr, w_s = run_example(name, ["--data-dir", data, "--device", "cpu"])
            stop = "golden mean drifted" if name == "replicate_reference" else None
            if (str(gerr) if gerr else None) != stop or (str(werr) if werr else None) != stop:
                raise AssertionError(f"examples (e): {name} stopped on {gerr!r} "
                                     f"(cuda) and {werr!r} (cpu), expected {stop!r}")
            printed_equal(got, want, f"examples (e): {name} cuda against cpu")
            log("examples", f"(e) {name} on the synthetic data dir: cuda {g_s:.2f} s, "
                            f"cpu {w_s:.2f} s, printouts equal"
                            + (f", both stopped at {stop!r}" if stop else "")
                            + f": {' | '.join(got.splitlines()[:3])}")
        torch.cuda.synchronize()
        ex_launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                       "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        if min(ex_launches.values()) < 1:
            raise AssertionError(f"examples: a kernel was not launched: {ex_launches}")
        wall_ms = north_star_grid_ms(dev)
        log("examples", f"(d) the example's fetched 16-cell grid at 3000 x 60 yr, "
                        f"impl kernel: {wall_ms:.4f} ms (median of "
                        f"{NORTH_STAR_REPS} synchronized reps) | {smi}")
        out.update(examples_launches=ex_launches,
                   example_north_star_grid_ms=wall_ms)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# phase 17: the multi-GPU compute layer as logical shards of the one card
MESH_SHARDS = (1, 2, 4, 8)
MESH_REPS = 3            # timed calls after the checked one (median)
MESH_RIDGE_ROWS = 480    # the golden frame's first rows: the walk is serial
MESH_BOOT_SAMPLES = 1000
MESH_SUBDIR = "mesh"
# a shard stuck at a collective raises after this long, naming its mesh,
# well inside the smoke's limit (the library's default is 900 s)
MESH_BARRIER_TIMEOUT_S = 120.0
# the JAX package's own limits between its sharded and single-device
# event engines (tests/test_sequence_parallel.py) and online ridge
# (tests/test_online_ridge_sharded.py), f64.  Its 1e-12 on cash and
# portfolio value is relative to values that stay near the starting
# cash there; the golden inputs' cash passes near 0, so here the 1e-12
# is taken against the magnitudes the reordered sums add (the starting
# cash, the gross notional traded and the largest marked book)
EVENT_PNL_TOL = dict(rtol=1e-9, atol=1e-7)
EVENT_FLOAT_RTOL = 1e-12
EVENT_CASH0, EVENT_SIZE = 1_000_000.0, 50
_MESH_ENTRY = re.compile(r"\.g(\d+)a(\d+)$")


def hold_event(got, want, what: str, T0=None) -> None:
    """A sharded event result against the single-device one: integer
    state equal, floats within the JAX package's own limits; ``T0`` cuts
    padded minutes."""
    import torch

    def cut(x):
        return x[..., :T0] if T0 is not None else x

    for f in ("positions", "trade_side", "bar_mask"):
        if not torch.equal(cut(getattr(got, f)), getattr(want, f)):
            raise AssertionError(f"{what}: {f} differs")
    for f in ("n_trades", "n_buys", "n_sells"):
        if int(getattr(got, f)) != int(getattr(want, f)):
            raise AssertionError(f"{what}: {f} {int(getattr(got, f))} != "
                                 f"{int(getattr(want, f))}")
    torch.testing.assert_close(cut(got.pnl), want.pnl, **EVENT_PNL_TOL, msg=what)
    gross = EVENT_SIZE * float((want.exec_price.abs() * want.trade_side.abs()).sum())
    scale = {"cash": EVENT_CASH0 + gross}
    scale["portfolio_value"] = scale["cash"] + float(
        (want.portfolio_value - want.cash).abs().max())
    for f, sc in scale.items():
        torch.testing.assert_close(cut(getattr(got, f)), getattr(want, f), rtol=0,
                                   atol=EVENT_FLOAT_RTOL * sc, msg=f"{what}: {f}")
    for f in ("exec_price", "impact"):
        torch.testing.assert_close(cut(getattr(got, f)) if f == "exec_price"
                                   else got.impact, getattr(want, f),
                                   rtol=EVENT_FLOAT_RTOL, atol=0, msg=f"{what}: {f}")
    for f in ("total_pnl", "net_notional"):
        if abs(float(getattr(got, f)) - float(getattr(want, f))) >= 1e-6:
            raise AssertionError(f"{what}: {f}")


def mesh_phase(smi, pm, mm, mres, grids) -> dict:
    """Phase 17: the sharded engines on logical shards of ``cuda:0`` at
    the north star (``pm``/``mm`` f32 with phase 5's single-device monthly
    ``mres`` and ``grids``), the event engines and the online ridge in
    f64, and the ``bench-mesh`` warm-up.  Returns the launches of (a)-(d),
    the walls by item and shard count, and the phase's wall."""
    import statistics

    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.bootstrap import block_bootstrap
    from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
    from csmom_tpu_torch.backtest.event import event_backtest, hysteresis_event_backtest
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.config import RunConfig
    from csmom_tpu_torch.models import online_ridge_scores
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.parallel import (
        sharded_banded_backtest, sharded_block_bootstrap, sharded_event_backtest,
        sharded_jk_grid_backtest, sharded_monthly_spread_backtest,
        time_sharded_event_backtest, time_sharded_hysteresis_backtest,
        time_sharded_online_ridge_scores,
    )
    from csmom_tpu_torch.parallel import compat
    from csmom_tpu_torch.parallel.event import sharded_hysteresis_backtest
    from csmom_tpu_torch.parallel.event_time import pad_time
    from csmom_tpu_torch.parallel.mesh import Mesh, make_mesh
    from csmom_tpu_torch.signals.intraday import (
        compact_minutes, minute_features, next_row_return,
    )
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS, GRID_SKIP, golden_event_inputs

    t_phase = time.perf_counter()
    compat.BARRIER_TIMEOUT_S = MESH_BARRIER_TIMEOUT_S
    dev = pm.device
    total = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    walls = {}

    def mesh(n, g=1, names=("grid", "assets")):
        return make_mesh([dev] * n, grid_axis=g, axis_names=names)

    def median_ms(fn, reps=MESH_REPS):
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    def checked(fn, want_k1, want_k2, what):
        """One call with its launches counted, then ``MESH_REPS`` timed
        ones: ``(result, median synchronized wall ms)``."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = (kernels.decile_partial_sums.launches,
               kernels.cohort_partial_sums.launches)
        if got != (want_k1, want_k2):
            raise AssertionError(f"{what}: launches K1 {got[0]}, K2 {got[1]}; "
                                 f"want {want_k1}, {want_k2}")
        total["decile_partial_sums"] += got[0]
        total["cohort_partial_sums"] += got[1]
        return out, median_ms(fn)

    def hold_spread(spread, valid, want, want_valid, what):
        if not torch.equal(valid, want_valid):
            raise AssertionError(f"{what}: validity differs")
        err = (spread - want).abs()[valid].max().item() if bool(valid.any()) else 0.0
        if not err <= SPREAD_ATOL:
            raise AssertionError(f"{what}: spread error {err} over {SPREAD_ATOL}")
        return err

    # -- (a) the monthly engine at 1, 2, 4, 8 asset shards ------------------
    w = {"single": median_ms(lambda: monthly_spread_backtest(
        pm, mm, lookback=12, skip=1, mode="qcut"))}
    errs = {}
    ref8 = {}   # the one-process 8-shard results phase 19 is held to
    for n in MESH_SHARDS:
        (spread, valid, *_), w[n] = checked(
            lambda n=n: sharded_monthly_spread_backtest(pm, mm, mesh(n), lookback=12,
                                                        skip=1, mode="qcut"),
            n, 0, f"mesh (a) {n} shards")
        errs[n] = hold_spread(spread, valid, mres.spread, mres.spread_valid,
                              f"mesh (a) {n} shards")
        if n == 8:
            ref8["monthly"] = (spread, valid)
    walls["monthly_qcut_J12"] = w
    log("mesh", f"(a) sharded monthly, qcut J=12, {tuple(pm.shape)} f32: K1 once a "
                f"shard; max |spread - single| {errs}; walls ms (median of "
                f"{MESH_REPS}; logical shards of one card) {json.dumps(w)} | {smi}")

    # -- (b) the 16-cell grid at impl kernel, and rank_hist -----------------
    w, errs = {}, {}
    for mode in ("rank", "qcut"):
        w[f"single_{mode}"] = median_ms(lambda mode=mode: jk_grid_backtest(
            pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP, mode=mode))
        for g, a in ((1, 8), (2, 4)):
            res, w[f"{mode}_g{g}a{a}"] = checked(
                lambda g=g, a=a, mode=mode: sharded_jk_grid_backtest(
                    pm, mm, GRID_JS, GRID_KS, mesh(g * a, g), skip=GRID_SKIP,
                    mode=mode, impl="kernel"),
                0, g * a, f"mesh (b) {mode} {g}x{a}")
            errs[f"{mode}_g{g}a{a}"] = hold_spread(
                res.spreads, res.spread_valid, grids[mode].spreads,
                grids[mode].spread_valid, f"mesh (b) {mode} {g}x{a}")
    res, w["rank_hist_a4"] = checked(
        lambda: sharded_jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mesh(4),
                                         skip=GRID_SKIP, mode="rank_hist",
                                         impl="kernel"),
        0, 4, "mesh (b) rank_hist 4")
    errs["rank_hist_a4"] = hold_spread(res.spreads, res.spread_valid,
                                       grids["rank"].spreads,
                                       grids["rank"].spread_valid,
                                       "mesh (b) rank_hist 4")
    walls["grid16"] = w
    log("mesh", f"(b) sharded 16-cell grid, impl kernel, f32: K2 once a (grid, "
                f"asset) shard pair; max |spread - single| {errs}; walls ms "
                f"(median of {MESH_REPS}; logical shards of one card) "
                f"{json.dumps(w)} | {smi}")

    # -- (c) the banded engine and the bootstrap on 4 shards ----------------
    w = {}
    band = banded_monthly_backtest(pm, mm, lookback=12, skip=1, mode="qcut", band=1)
    w["banded_single"] = median_ms(lambda: banded_monthly_backtest(
        pm, mm, lookback=12, skip=1, mode="qcut", band=1))
    (spread, valid, *_), w["banded_4"] = checked(
        lambda: sharded_banded_backtest(pm, mm, mesh(4), lookback=12, skip=1,
                                        mode="qcut", band=1),
        0, 0, "mesh (c) banded")
    err_band = hold_spread(spread, valid, band.spread, band.spread_valid,
                           "mesh (c) banded")
    (spread, valid, *_), w["banded_8"] = checked(
        lambda: sharded_banded_backtest(pm, mm, mesh(8), lookback=12, skip=1,
                                        mode="qcut", band=1),
        0, 0, "mesh (c) banded 8")
    err_band = max(err_band, hold_spread(spread, valid, band.spread, band.spread_valid,
                                         "mesh (c) banded 8"))
    ref8["banded"] = (spread, valid)
    key = random.PRNGKey(0)
    boot = block_bootstrap(mres.spread, mres.spread_valid, key,
                           n_samples=MESH_BOOT_SAMPLES)
    w["bootstrap_single"] = median_ms(lambda: block_bootstrap(
        mres.spread, mres.spread_valid, key, n_samples=MESH_BOOT_SAMPLES))
    sboot, w["bootstrap_4"] = checked(
        lambda: sharded_block_bootstrap(mres.spread, mres.spread_valid, key,
                                        mesh(4), n_samples=MESH_BOOT_SAMPLES),
        0, 0, "mesh (c) bootstrap")
    err_boot = 0.0
    for f in ("mean_samples", "sharpe_samples", "mean_ci", "sharpe_ci"):
        d = (getattr(sboot, f) - getattr(boot, f)).abs().max().item()
        err_boot = max(err_boot, d)
        if not d <= SPREAD_ATOL:
            raise AssertionError(f"mesh (c) bootstrap: {f} off by {d}")
    walls["banded_bootstrap"] = w
    log("mesh", f"(c) sharded banded (band 1) on 4 and 8 shards and bootstrap "
                f"({MESH_BOOT_SAMPLES} resamples) on 4 shards: max |spread - single| "
                f"{err_band}, max "
                f"|bootstrap - single| {err_boot}; walls ms {json.dumps(w)} | {smi}")

    # -- (d) the event engines and the online ridge, f64 ---------------------
    w = {}
    price, valid, score, adv, vol, _ = golden_event_inputs(torch.float64, device=dev)
    A, T = price.shape
    for order in ("market", "limit"):
        kw = {"order_type": "limit", "fill_key": key} if order == "limit" else {}
        want = event_backtest(price, valid, score, adv, vol, **kw)
        w[f"single_{order}"] = median_ms(
            lambda kw=kw: event_backtest(price, valid, score, adv, vol, **kw))
        got, w[f"assets4_{order}"] = checked(
            lambda kw=kw: sharded_event_backtest(price, valid, score, adv, vol,
                                                 mesh(4), **kw),
            0, 0, f"mesh (d) asset-sharded {order}")
        hold_event(got, want, f"mesh (d) asset-sharded {order}")
    hyst = dict(threshold_hi=1e-4, threshold_lo=2e-5)
    got, w["assets4_hysteresis"] = checked(
        lambda: sharded_hysteresis_backtest(price, valid, score, adv, vol, mesh(4),
                                            **hyst),
        0, 0, "mesh (d) asset-sharded hysteresis")
    hold_event(got, hysteresis_event_backtest(price, valid, score, adv, vol, **hyst),
               "mesh (d) asset-sharded hysteresis")
    # the time axis in 4 blocks (padded with non-event minutes), and 2 x 2
    pp, vp, sp, T0 = pad_time(*(x.cpu().numpy() for x in (price, valid, score)), 4)
    padded = [torch.as_tensor(x, device=dev) for x in (pp, vp, sp)]
    layouts = {"time4": (mesh(4, 1, ("assets", "time")), None, padded, T0),
               "assets2_time2": (mesh(4, 2, ("assets", "time")), "assets",
                                 [price, valid, score], None)}
    for latency in (0, 3):
        want = event_backtest(price, valid, score, adv, vol, latency_bars=latency)
        for name, (m, axis, (p_, v_, s_), cut) in layouts.items():
            got, w[f"{name}_lat{latency}"] = checked(
                lambda m=m, axis=axis, p_=p_, v_=v_, s_=s_, latency=latency:
                time_sharded_event_backtest(p_, v_, s_, adv, vol, m, asset_axis=axis,
                                            latency_bars=latency),
                0, 0, f"mesh (d) time-sharded {name} latency {latency}")
            hold_event(got, want, f"mesh (d) time-sharded {name} latency {latency}",
                       T0=cut)
    want = hysteresis_event_backtest(price, valid, score, adv, vol, **hyst)
    for name, (m, axis, (p_, v_, s_), cut) in layouts.items():
        got, w[f"{name}_hysteresis"] = checked(
            lambda m=m, axis=axis, p_=p_, v_=v_, s_=s_:
            time_sharded_hysteresis_backtest(p_, v_, s_, adv, vol, m, asset_axis=axis,
                                             **hyst),
            0, 0, f"mesh (d) time-sharded hysteresis {name}")
        hold_event(got, want, f"mesh (d) time-sharded hysteresis {name}", T0=cut)
    # the online ridge on the golden frame's first rows, f64, one call each
    icfg = RunConfig().intraday
    compact = compact_minutes(golden_minute_frame()[0])
    cp = torch.as_tensor(compact.price, dtype=torch.float64).to(dev)
    cv = torch.as_tensor(compact.volume, dtype=torch.float64).to(dev)
    feats, fv = minute_features(cp, cv, torch.as_tensor(compact.row_valid).to(dev),
                                window=icfg.window_minutes)
    y, yv = next_row_return(cp, fv)
    R = min(MESH_RIDGE_ROWS, feats.shape[1])
    feats, y, yv = (x[:, :R].contiguous() for x in (feats, y, yv))
    kw = dict(n_splits=icfg.n_splits, alpha=icfg.alpha)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = online_ridge_scores(feats, y, yv, **kw)
    torch.cuda.synchronize()
    w["ridge_single"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit = time_sharded_online_ridge_scores(feats, y, yv, Mesh([dev] * 4, ("time",)),
                                           **kw)
    torch.cuda.synchronize()
    w["ridge_time4"] = (time.perf_counter() - t0) * 1e3
    torch.testing.assert_close(fit.scores, walk.scores, rtol=1e-8, atol=1e-12,
                               equal_nan=True, msg="mesh (d) online ridge scores")
    torch.testing.assert_close(fit.cv_mse, walk.cv_mse, rtol=1e-8, atol=0,
                               msg="mesh (d) online ridge cv_mse")
    torch.testing.assert_close(fit.coef, walk.coef, rtol=1e-7, atol=1e-12,
                               msg="mesh (d) online ridge coef")
    if int(fit.n_train) != int(walk.n_train):
        raise AssertionError("mesh (d) online ridge: n_train differs")
    walls["event_ridge"] = w
    log("mesh", f"(d) golden event inputs {A}x{T} f64: asset-sharded (4) market, "
                f"limit and hysteresis; time-sharded (time=4, padded to "
                f"{pp.shape[1]}; assets=2 x time=2) at latency 0 and 3 and the "
                f"hysteresis engine: integer state exact, floats within the JAX "
                f"package's limits; online ridge {feats.shape[0]}x{R} f64 on 4 "
                f"time shards within rtol 1e-8; walls ms {json.dumps(w)} | {smi}")

    # -- (e) the bench-mesh warm-up in a process of its own ------------------
    with tempfile.TemporaryDirectory(prefix="csmom_mesh_") as tmp:
        report, _, warm_s = run_warmup(REPO, tmp, profiles="bench-mesh",
                                       subdir=MESH_SUBDIR)
    entries = [r for r in report["entries"] if r["name"].startswith("mesh.grid.")]
    if report["n_errors"] or len(entries) != 2:
        raise AssertionError(f"mesh (e) bench-mesh: {report['n_errors']} errors, "
                             f"entries {[r['name'] for r in entries]}")
    # two calls an entry, K2 once a (grid, asset) shard pair a call
    want_k2 = sum(2 * int(g) * int(a) for g, a in
                  (_MESH_ENTRY.search(r["name"]).groups() for r in entries))
    mesh_k2 = sum(r.get("launches", {}).get("cohort_partial_sums", 0) for r in entries)
    if mesh_k2 != want_k2:
        raise AssertionError(f"mesh (e) bench-mesh: K2 {mesh_k2}, want {want_k2}")
    log("mesh", f"(e) warmup --profiles bench-mesh --strict: {report['n_entries']} "
                f"entries ({[r['name'] for r in entries]} and the golden-event "
                f"leg), 0 errors, {warm_s:.1f} s of command; K2 {mesh_k2} over the "
                f"mesh entries' two calls each; warm calls ms "
                f"{[round(r['warm_call_s'] * 1e3, 3) for r in entries]} | {smi}")
    return {"launches": total, "walls": walls, "warmup_s": warm_s,
            "wall_s": time.perf_counter() - t_phase, "ref8": ref8}


# phase 19: the lint sweep, and meshes over two processes on the one card
MULTIHOST_TIMEOUT_S = 300.0   # the two processes' limit; killed past it
MULTIHOST_BUDGET_S = 60.0     # the phase's wall, checked
# packages a sweep must leave unimported: torch, jax and the JAX package
LINT_FORBIDDEN = ("torch.", "jax.", "csmom_tpu.")


def bit_equal(a, b) -> bool:
    """Same dtype, shape and bytes (NaN payloads included)."""
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def lint_multihost_phase(smi, pm, mm, ref8) -> dict:
    """Phase 19: (a) the port's lint sweep in a process of its own, clean
    and torch-free; (b) two controller processes of 4 logical shards of
    ``cuda:0`` each, over gloo, run the sharded monthly (qcut, J=12) and
    banded engines on phase 5's north-star panel (``pm``/``mm``, f32, read
    from a file), bit-equal to phase 17's one-process 8-shard results
    ``ref8``, K1 once per asset shard, and the 96 x 72 f64 dry run at its
    tolerances; (c) joined at world size 1, the monthly engine on 8 shards
    equals ``ref8``'s.  Returns the launches of (b)'s north-star legs and
    the walls."""
    import torch

    from csmom_tpu_torch.parallel import multihost_dryrun as mh
    from csmom_tpu_torch.parallel.collectives import sharded_monthly_spread_backtest
    from csmom_tpu_torch.parallel.mesh import (
        backend, distributed_init, distributed_shutdown, make_mesh, mesh_topology,
    )

    t_phase = time.perf_counter()
    walls = {}

    # -- (a) the lint sweep --------------------------------------------------
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "csmom_tpu_torch.cli", "lint",
         "--project", "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    walls["lint_s"] = round(time.perf_counter() - t0, 2)
    if p.returncode != 0:
        raise AssertionError(f"lint (a): exit {p.returncode}\n{p.stdout[-3000:]}"
                             f"\n{p.stderr[-3000:]}")
    rep = json.loads(p.stdout)
    if not rep["ok"] or rep["findings"] or rep["files_scanned"] <= 100:
        raise AssertionError(f"lint (a): {len(rep['findings'])} findings over "
                             f"{rep['files_scanned']} files: {rep['findings'][:3]}")
    imported = {ln.rsplit("|", 1)[-1].strip() for ln in p.stderr.splitlines()
                if ln.startswith("import time:")}
    bad = sorted(m for m in imported if (m + ".").startswith(LINT_FORBIDDEN))
    if bad or "csmom_tpu_torch.analysis.rules" not in imported:
        raise AssertionError(f"lint (a): the sweep imported {bad[:5]}")
    log("lint", f"(a) lint --project --format json: 0 findings over "
                f"{rep['files_scanned']} files, {len(rep['suppressed'])} suppressed "
                f"by pragma ({sorted({f['rule'] for f in rep['suppressed']})}), "
                f"rules {rep['rules']}; {len(imported)} modules imported, none of "
                f"torch, jax or the JAX package; {walls['lint_s']} s of command")

    # -- (b) two controller processes on the one card ------------------------
    with tempfile.TemporaryDirectory(prefix="csmom_multihost_") as tmp:
        panel = os.path.join(tmp, "panel.npz")
        np.savez(panel, prices=pm.cpu().numpy(), mask=mm.cpu().numpy())
        t0 = time.perf_counter()
        records = mh.launch(device="cuda:0", save=tmp, panel=panel,
                            timeout=MULTIHOST_TIMEOUT_S)
        walls["two_process_s"] = round(time.perf_counter() - t0, 2)
        saved = [dict(np.load(os.path.join(tmp, f"rank{r}_panel.npz")))
                 for r in range(mh.N_PROC)]
    line = mh.summary(records, "cuda:0")
    if line["value"] != 1.0:
        raise AssertionError(f"multihost (b): the 96x72 f64 dry run failed: "
                             f"{json.dumps(line)}")
    for rec in records:
        if (rec["backend"], rec["panel_monthly_launches"],
                rec["panel_banded_launches"]) != ("gloo", 4, 0):
            raise AssertionError(f"multihost (b): process {rec['rank']}: backend "
                                 f"{rec['backend']}, K1 {rec['panel_monthly_launches']} "
                                 f"monthly / {rec['panel_banded_launches']} banded; "
                                 "want gloo, 4 and 0")
        if rec["topology"]["assets"] != {"size": 8, "crosses_hosts": True,
                                         "backend": "gloo"}:
            raise AssertionError(f"multihost (b): topology {rec['topology']}")
    want = {"spread": ref8["monthly"][0], "valid": ref8["monthly"][1],
            "b_spread": ref8["banded"][0], "b_valid": ref8["banded"][1]}
    for r, got in enumerate(saved):
        for key, t in want.items():
            if not bit_equal(got[key], t.cpu().numpy()):
                raise AssertionError(f"multihost (b): process {r}'s {key} is not "
                                     "bit-equal to phase 17's 8-shard result")
    launches = {"decile_partial_sums": sum(rec["panel_monthly_launches"]
                                           + rec["panel_banded_launches"]
                                           for rec in records),
                "cohort_partial_sums": 0}
    if launches["decile_partial_sums"] != 8:
        raise AssertionError(f"multihost (b): K1 {launches}, want 8")
    log("multihost", f"(b) 2 processes x 4 logical shards of cuda:0 over "
                     f"{records[0]['backend']}: north star {tuple(pm.shape)} f32 "
                     f"monthly (qcut, J=12) and banded (band 1) bit-equal to phase "
                     f"17's one-process 8-shard results in both processes; K1 "
                     f"{[rec['panel_monthly_launches'] for rec in records]} by process "
                     f"(monthly), banded 0; 96x72 f64 dry run: "
                     f"{json.dumps({k: line['extra'][k] for k in ('monthly_equal', 'banded_equal', 'online_ridge_equal', 'gathered_equal')})}; "
                     f"walls s: north star monthly "
                     f"{[rec['panel_monthly_wall_s'] for rec in records]}, banded "
                     f"{[rec['panel_banded_wall_s'] for rec in records]}, f64 monthly "
                     f"{records[0]['monthly_wall_s']}, banded {records[0]['banded_wall_s']}, "
                     f"ridge {records[0]['online_ridge_wall_s']}; the processes "
                     f"{walls['two_process_s']} s | {smi}")
    log("multihost", f"dry-run line {json.dumps(line)}")

    # -- (c) world size 1 ----------------------------------------------------
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dev = pm.device
    t0 = time.perf_counter()
    if not distributed_init(f"127.0.0.1:{port}", 1, 0, devices=[dev] * 8):
        raise AssertionError("multihost (c): distributed_init did not join")
    try:
        joined_backend = backend()
        mesh = make_mesh(axis_names=("grid", "assets"))
        topo = mesh_topology(mesh)
        spread, valid, *_ = sharded_monthly_spread_backtest(pm, mm, mesh, lookback=12,
                                                            skip=1, mode="qcut")
        torch.cuda.synchronize()
    finally:
        distributed_shutdown()
    walls["world1_s"] = round(time.perf_counter() - t0, 2)
    if mesh.size != 8 or topo["assets"]["crosses_hosts"]:
        raise AssertionError(f"multihost (c): mesh {mesh}, topology {topo}")
    if not (bit_equal(spread.cpu().numpy(), ref8["monthly"][0].cpu().numpy())
            and bit_equal(valid.cpu().numpy(), ref8["monthly"][1].cpu().numpy())):
        raise AssertionError("multihost (c): world size 1 changed the monthly result")
    walls["phase_s"] = round(time.perf_counter() - t_phase, 2)
    log("multihost", f"(c) distributed_init at world size 1 ({joined_backend}): the "
                     f"8-shard monthly engine bit-equal to phase 17's; "
                     f"{walls['world1_s']} s | {smi}")
    if walls["phase_s"] > MULTIHOST_BUDGET_S:
        raise AssertionError(f"phase 19 took {walls['phase_s']} s, over its "
                             f"{MULTIHOST_BUDGET_S} s")
    return {"launches": launches, "walls": walls, "wall_s": walls["phase_s"]}


# phase 20: the rehearsal of the serving tiers, the replay and the warm-up
# (python -m csmom_tpu_torch.cli rehearse), then its timeline
REHEARSE_TIMEOUT_S = 600.0
REHEARSE_BUDGET_S = 180.0     # the phase's wall, checked
REHEARSE_FAST = 16            # the fast tier's scenarios
_ROW = re.compile(r"^\s+\[(PASS|FAIL)\] (\S+)\s+\(([\w-]+),\s+([\d.]+)s\)$")
_HEAL_WALLS = re.compile(r"pass 1 \(fault-free\) ([\d.]+)s, pass 2 \(cache "
                         r"corrupted\) ([\d.]+)s")


def tree_digests(root: str) -> dict:
    """``{relative path: sha256}`` of every file under ``root``."""
    import hashlib

    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def clean_env(**extra) -> dict:
    """This process's environment without the ``CSMOM_*`` contracts that
    earlier phases may have left exported (a telemetry stream and its run
    id, a fault plan, the fleet aggregator's address), with the checkout
    on ``PYTHONPATH`` and ``extra`` set."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("CSMOM_")}
    return {**env, "PYTHONPATH": REPO, **extra}


def run_rehearse(args, tel_dir: str, cwd: str):
    """``python -m csmom_tpu_torch.cli rehearse ARGS`` in a process of its
    own, its sidecar to ``tel_dir``; returns the process and its rows
    ``{name: (status, pipeline, wall s)}``."""
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "rehearse", *args],
        cwd=cwd, capture_output=True, text=True, timeout=REHEARSE_TIMEOUT_S,
        env=clean_env(CSMOM_TELEMETRY_DIR=tel_dir))
    rows = {m.group(2): (m.group(1), m.group(3), float(m.group(4)))
            for m in map(_ROW.match, p.stdout.splitlines()) if m}
    return p, rows


# the child of phase 20 (a): the sandbox's rebuilt K1 and K2 (CSMOM_JIT_CACHE
# set by the caller) against their plain versions at the panel shapes the
# scenario warmed them at (K1: profile smoke's monthly entries; K2: its
# grid's, which the scenario also warms through K2), loaded as they are
# (no build, no heal)
_HEALED_CHECK = """
import json, sys
import numpy as np, torch
from csmom_tpu_torch.compile.manifest import build_manifest
from csmom_tpu_torch.ops import build, kernels
rtol, atol = float(sys.argv[1]), float(sys.argv[2])
dev = torch.device("cuda")
rng = np.random.default_rng(20)
shapes = {}
for e in build_manifest("smoke"):
    key = ("decile_partial_sums" if "decile_partial_sums" in e.kernels
           else "cohort_partial_sums" if e.name.startswith("grid.jk16.") else None)
    if key and key not in shapes:
        args, _ = e.materialize(torch.device("cpu"), rng)
        shapes[key] = tuple(args[0].shape)
A1, M1 = shapes["decile_partial_sums"]
A2, M2 = shapes["cohort_partial_sums"]
B, H = 10, 12
lab1 = rng.integers(-1, B, size=(A1, M1)).astype(np.int32)
ret1 = np.where(lab1 >= 0, rng.normal(0, 0.1, size=(A1, M1)), 0.0)
lab1, ret1 = torch.tensor(lab1, device=dev), torch.tensor(ret1, dtype=torch.float32, device=dev)
s, c = kernels.decile_partial_sums(ret1, lab1, B)
ps, pc = kernels.decile_partial_sums_plain(ret1, lab1, B)
ab, _ = kernels.decile_partial_sums_plain(ret1.abs(), lab1, B)
lab2 = torch.tensor(rng.integers(-1, B, size=(4, A2, M2)).astype(np.int32), device=dev)
valid = rng.random((A2, M2)) > 0.2
ret2 = torch.tensor(np.where(valid, rng.normal(0, 0.1, size=(A2, M2)), np.nan),
                    dtype=torch.float32, device=dev)
valid = torch.tensor(valid, device=dev)
s2, c2 = kernels.cohort_partial_sums(ret2, valid, lab2, B, H)
p2, pc2 = kernels.cohort_partial_sums_plain(ret2, valid, lab2, B, H)
ab2, _ = kernels.cohort_partial_sums_plain(torch.where(valid, ret2, 0.0).abs(), valid, lab2, B, H)
torch.cuda.synchronize()
print(json.dumps({
    "shapes": {k: list(v) for k, v in shapes.items()},
    "libraries": [str(build.library_path(k)) for k in shapes],
    "built": build.libraries_built(), "healed": build.libraries_healed(),
    "intact": all(build.intact(build.library_path(k)) for k in shapes),
    "launches": {"decile_partial_sums": kernels.decile_partial_sums.launches,
                 "cohort_partial_sums": kernels.cohort_partial_sums.launches},
    "counts_equal": bool(torch.equal(c, pc) and torch.equal(c2, pc2)),
    "within": bool(((s - ps).abs() <= atol + rtol * ab).all()
                   and ((s2 - p2).abs() <= atol + rtol * ab2).all()),
    "max_abs_err": {"decile_partial_sums": (s - ps).abs().max().item(),
                    "cohort_partial_sums": (s2 - p2).abs().max().item()}}))
"""


def rehearse_phase(smi) -> dict:
    """Phase 20: (a) ``rehearse --only corrupt-aot-cache`` on the card in a
    process of its own: both kernel libraries built into the scenario's
    sandbox, every file there corrupted, the warm-up healed (at least one
    entry ``self_healed``, no error, K1 and K2 launched from the rebuilt
    libraries); those libraries, loaded as they are, equal their plain
    versions at the warmed shapes; the repository's own build directory
    byte for byte unchanged; (b) ``rehearse --fast`` (13 of 13 green) and
    ``rehearse --only fabric`` (3 of 3), each scenario's wall logged; (c)
    ``timeline rehearse_fast --json`` over (b)'s sidecar: valid, one
    ``rehearse.row`` span a scenario.  Returns pass 2's launches and the
    walls."""
    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.obs import timeline as tl
    from csmom_tpu_torch.ops import build

    t_phase = time.perf_counter()
    walls = {}
    repo_build = str(build.BUILD_DIR)
    before = tree_digests(repo_build)
    # short sandbox paths: the stub tiers bind unix sockets under them
    with tempfile.TemporaryDirectory(prefix="csmom_rh_") as tmp:
        tel = os.path.join(tmp, "tel")
        # -- (a) the heal --------------------------------------------------
        box = os.path.join(tmp, "heal")
        t0 = time.perf_counter()
        p, rows = run_rehearse(["--only", "corrupt-aot-cache", "--sandbox", box,
                                "--keep"], tel, tmp)
        walls["heal_s"] = round(time.perf_counter() - t0, 2)
        if p.returncode != 0 or "1/1 scenarios green" not in p.stdout:
            raise AssertionError(f"rehearse (a): exit {p.returncode}\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        scen = os.path.join(box, "corrupt-aot-cache")
        summaries = []
        for n in (1, 2):
            with open(os.path.join(scen, f"pass{n}.out")) as f:
                summaries.append(inv.trailing_json(f.read()))
        first, healed = summaries
        m = _HEAL_WALLS.search(p.stdout)
        walls["pass1_s"], walls["pass2_s"] = float(m.group(1)), float(m.group(2))
        launches = healed["launches"]
        if (healed["platform"] != "gpu" or healed["n_errors"]
                or healed["n_self_healed"] < 1 or min(launches.values()) < 1
                or first["n_errors"] or first["n_self_healed"]):
            raise AssertionError(f"rehearse (a): pass 1 {json.dumps(first)}, "
                                 f"pass 2 {json.dumps(healed)}")
        c = subprocess.run(
            [sys.executable, "-c", _HEALED_CHECK, str(F32_RTOL), str(F32_ATOL)],
            cwd=tmp, capture_output=True, text=True, timeout=300,
            env=clean_env(CSMOM_JIT_CACHE=os.path.join(scen, "jit-cache")))
        if c.returncode != 0:
            raise AssertionError(f"rehearse (a): the healed libraries' check "
                                 f"exit {c.returncode}\n{c.stderr[-3000:]}")
        held = json.loads(c.stdout.strip().splitlines()[-1])
        if (held["built"] or held["healed"] or not held["intact"]
                or not held["counts_equal"] or not held["within"]
                or min(held["launches"].values()) < 1
                or not all(lib.startswith(scen) for lib in held["libraries"])):
            raise AssertionError(f"rehearse (a): the healed libraries: "
                                 f"{json.dumps(held)}")
        log("rehearse", f"(a) corrupt-aot-cache: pass 1 built the libraries in "
                        f"the sandbox ({walls['pass1_s']} s, {first['value']} "
                        f"entries), pass 2 found every file corrupted and healed "
                        f"{healed['n_self_healed']} entries ({walls['pass2_s']} s, "
                        f"{healed['n_errors']} errors, launches {launches}); the "
                        f"rebuilt K1 and K2 loaded as they are equal their plain "
                        f"versions at the warmed shapes {held['shapes']} (counts "
                        f"equal, f32 sums within {F32_RTOL} x sum|x| + {F32_ATOL}; "
                        f"max |err| {held['max_abs_err']}); the scenario "
                        f"{rows['corrupt-aot-cache'][2]} s, the command "
                        f"{walls['heal_s']} s | {smi}")

        # -- (b) the stub tiers ---------------------------------------------
        scen_walls = {}
        for label, args, want in (
                ("fast", ["--fast"], f"{REHEARSE_FAST}/{REHEARSE_FAST} scenarios green"),
                ("fabric", ["--only", "fabric"], "3/3 scenarios green")):
            t0 = time.perf_counter()
            p, rows = run_rehearse([*args, "--sandbox", os.path.join(tmp, label)],
                                   tel, tmp)
            walls[f"{label}_s"] = round(time.perf_counter() - t0, 2)
            if p.returncode != 0 or want not in p.stdout:
                raise AssertionError(f"rehearse (b) {label}: exit {p.returncode}\n"
                                     f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            scen_walls.update({name: wall for name, (_, _, wall) in rows.items()})
            log("rehearse", f"(b) rehearse {' '.join(args)}: {want}; the command "
                            f"{walls[f'{label}_s']} s; scenario walls s "
                            f"{json.dumps({n: w for n, (_, _, w) in rows.items()})} | {smi}")
        walls["scenarios_s"] = scen_walls

        # -- (c) the timeline --------------------------------------------------
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "csmom_tpu_torch.cli", "timeline",
             "rehearse_fast", "--json"], cwd=tmp, capture_output=True, text=True,
            timeout=120, env=clean_env(CSMOM_TELEMETRY_DIR=tel))
        walls["timeline_s"] = round(time.perf_counter() - t0, 2)
        if p.returncode != 0:
            raise AssertionError(f"timeline (c): exit {p.returncode}\n{p.stderr[-3000:]}")
        side = json.loads(p.stdout)
        t0 = time.perf_counter()
        text = tl.render(side)
        walls["timeline_render_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        spans = {a["name"]: a["count"] for a in side["spans"]}
        bad = inv.validate(side)
        if bad or spans.get("rehearse.row") != REHEARSE_FAST or not os.path.isfile(
                os.path.join(tel, "GPU_TELEMETRY_rehearse_fast.json")) or \
                "run rehearse_fast" not in text:
            raise AssertionError(f"timeline (c): {bad}, rows {spans.get('rehearse.row')}")
        log("rehearse", f"(c) timeline rehearse_fast --json: a valid "
                        f"GPU_TELEMETRY_rehearse_fast.json, {spans['rehearse.row']} "
                        f"rehearse.row spans, wall {side['wall_s']} s, phases "
                        f"{json.dumps({ph['name']: ph['dur_s'] for ph in side['phases']})}; "
                        f"{walls['timeline_s']} s of command, render "
                        f"{walls['timeline_render_ms']} ms in this process")
    after = tree_digests(repo_build)
    if after != before:
        changed = sorted(k for k in set(before) | set(after)
                         if before.get(k) != after.get(k))
        raise AssertionError(f"rehearse: the repository's build directory changed: "
                             f"{changed[:10]}")
    walls["phase_s"] = round(time.perf_counter() - t_phase, 2)
    log("rehearse", f"the repository's {len(before)} build files unchanged; phase "
                    f"walls s {json.dumps({k: v for k, v in walls.items() if k != 'scenarios_s'})} | {smi}")
    if walls["phase_s"] > REHEARSE_BUDGET_S:
        raise AssertionError(f"phase 20 took {walls['phase_s']} s, over its "
                             f"{REHEARSE_BUDGET_S} s")
    return {"launches": launches, "walls": walls, "wall_s": walls["phase_s"]}


# phase 21: the perf ledger on the card.  Phase 11's service runs are
# named chip-<schedule> and carry no round id, so the ledger would skip
# them: this phase lands round-named runs of its own
LEDGER_SCHEDULE = "2x40"    # phase 11's first schedule (80 arrivals)
LEDGER_BUDGET_S = 45.0      # the phase's wall, checked
LEDGER_CI_RTOL = 1e-12      # the card's f64 CIs against the CPU's
LEDGER_INJECT = 3.0         # the reference test's BAD_SAMPLES factor


def inject_latency(art: dict, factor: float, run_id: str) -> dict:
    """A copy of serve artifact ``art`` as run ``run_id`` with every
    latency percentile (global, per class, per endpoint) and every
    latency sample multiplied by ``factor``."""
    out = json.loads(json.dumps(art))
    out["run_id"] = run_id
    books = list(out["latency_ms"].values()) + [
        b["latency_ms"] for block in ("classes", "endpoints")
        for b in out.get(block, {}).values()]
    for book in books:
        for q, v in book.items():
            if isinstance(v, (int, float)):
                book[q] = v * factor
    out["extra"]["samples"] = {k: [v * factor for v in vals]
                               for k, vals in out["extra"]["samples"].items()}
    return out


def _ci_close(a: float, b: float) -> bool:
    return abs(a - b) <= LEDGER_CI_RTOL * abs(b)


def ledger_phase(smi) -> dict:
    """Phase 21: (a) two service runs on the card (profile ``serve``,
    phase 11's ``2x40``, seed 0) landed as ``GPU_SERVE_r01.json`` and
    ``GPU_SERVE_r02.json``, both valid, K1 launched by their ``backtest``
    micro-batches; (b) ``ledger show`` over them: ``serve_p99_ms`` rows
    for both runs, platform ``gpu``, with samples, no problem; (c)
    ``ledger diff r01 r02 --device cuda``: a verdict for every comparable
    key, each CI computed on the card equal to ``regress.compare(...,
    device="cpu")``'s within ``LEDGER_CI_RTOL`` and the verdict the
    same; (d) r02 with every latency x3 as ``GPU_SERVE_r03.json``: the
    gate on the card exits 1 with a FAIL line for ``serve_p99_ms``; (e) r01
    and an exact copy as r04: the gate exits 0 with no FAIL line; (f) (d)'s
    gate through the command line in a process of its own exits 1; (g)
    ``roadmap`` splices a file with the port's markers and refuses a copy
    of ROADMAP.md, leaving it unchanged.  Returns the service runs'
    launches and the walls."""
    import argparse
    import contextlib
    import io
    import shutil
    import zlib

    import torch

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.cli import ledger as cli_ledger
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.obs import ledger as ld
    from csmom_tpu_torch.obs import regress
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig,
        resolve_schedule,
        run_loadgen,
        write_artifact,
    )
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    t_phase = time.perf_counter()
    walls = {}

    def run_cli(label, argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(argv)
        walls[label] = round(time.perf_counter() - t0, 3)
        return rc, out.getvalue(), err.getvalue()

    with tempfile.TemporaryDirectory(prefix="csmom_ledger_") as tmp:
        runs, same = os.path.join(tmp, "runs"), os.path.join(tmp, "same")
        # -- (a) two real runs: the main path, counts from 0 at the first
        # service's start to the end of the second run ---------------------
        schedule, schedule_kind, preset = resolve_schedule(LEDGER_SCHEDULE)
        arts, paths = {}, {}
        kernels.reset_launches()
        for run_id in ("r01", "r02"):
            t0 = time.perf_counter()
            svc = SignalService(ServeConfig(profile="serve", engine="torch"))
            svc.start()
            art = run_loadgen(svc, LoadConfig(schedule=schedule,
                                              schedule_kind=schedule_kind,
                                              seed=0, run_id=run_id, **preset))
            walls[f"run_{run_id}_s"] = round(time.perf_counter() - t0, 3)
            bad = inv.validate(art) + svc.invariant_violations()
            if (bad or art["extra"]["platform"] != "gpu"
                    or art["compile"]["in_window_fresh_compiles"] != 0):
                raise AssertionError(f"ledger (a) {run_id}: {bad}, platform "
                                     f"{art['extra']['platform']}, fresh "
                                     f"compiles {art['compile']}")
            arts[run_id], paths[run_id] = art, write_artifact(runs, art)
        torch.cuda.synchronize()
        launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                    "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        if launches["decile_partial_sums"] < 1 or launches["cohort_partial_sums"]:
            raise AssertionError(f"ledger (a): launches {launches}, expected K1 "
                                 f"> 0 and K2 0")
        log("ledger", f"(a) GPU_SERVE_r01.json and GPU_SERVE_r02.json ({LEDGER_SCHEDULE}, "
                      f"seed 0): valid, "
                      + "; ".join(f"{r} {a['value']} req/s, p99 "
                                  f"{a['latency_ms']['total']['p99']} ms, "
                                  f"{walls[f'run_{r}_s']} s with the start-up"
                                  for r, a in arts.items())
                      + f"; launches {launches} | {smi}")

        # -- (b) show ---------------------------------------------------------
        rc, out, err = run_cli("show_s", ["ledger", "show", "--root", runs])
        L = ld.load(runs)
        p99 = [r for r in L.rows if r.metric == "serve_p99_ms"]
        if (rc != 0 or L.problems or sorted(r.run for r in p99) != ["r01", "r02"]
                or not all(r.platform == "gpu" and r.samples for r in p99)
                or "serve_p99_ms" not in out):
            raise AssertionError(f"ledger (b): exit {rc}, problems {L.problems}, "
                                 f"p99 rows {p99}\n{out}{err}")
        log("ledger", f"(b) show: {len(L.rows)} rows, serve_p99_ms on "
                      f"{[(r.run, r.platform, len(r.samples)) for r in p99]}, "
                      f"no problem, {walls['show_s']} s")

        # -- (c) diff on the card, every CI held against the CPU's -------------
        rc, out, err = run_cli("diff_s", ["ledger", "diff", "r01", "r02",
                                          "--root", runs, "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"ledger (c): diff exit {rc}\n{out}{err}")
        args = argparse.Namespace(device="cuda", min_rel=regress.DEFAULT_MIN_REL,
                                  suspect_rel=regress.DEFAULT_SUSPECT_REL,
                                  mem_tol=regress.DEFAULT_MEM_TOL)
        printed = [ln for ln in out.splitlines() if ln.startswith("[")]
        verdicts, times = {}, {"cuda_ms": [], "cpu_ms": []}
        for _, _, pair in cli_ledger.diff_pairs(L, "r01", "r02"):
            if pair is None:
                continue
            ref, cand = pair
            t0 = time.perf_counter()
            card = cli_ledger._verdict_for(cand, ref, args)
            torch.cuda.synchronize()
            t_card = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            host = regress.compare(
                cand.value, ref.value, cand_samples=cand.samples,
                ref_samples=ref.samples, direction=cand.direction,
                seed=zlib.crc32(repr(cand.key()).encode()) & 0xFFFF,
                device="cpu")
            t_host = (time.perf_counter() - t0) * 1e3
            for side in ("candidate", "reference"):
                a, b = card[side], host[side]
                if "lo" in b and not all(_ci_close(a[k], b[k])
                                         for k in ("point", "lo", "hi")):
                    raise AssertionError(f"ledger (c) {cand.metric} {side}: card "
                                         f"{a} vs cpu {b}")
            line = [ln for ln in printed if f"] {cand.metric}  (" in ln]
            if card["verdict"] != host["verdict"] or len(line) != 1 \
                    or f"  {card['verdict']}  " not in line[0]:
                raise AssertionError(f"ledger (c) {cand.metric}: card "
                                     f"{card['verdict']}, cpu {host['verdict']}, "
                                     f"printed {line}")
            verdicts[cand.metric] = card["verdict"]
            if card["basis"] == "bootstrap-ci":
                times["cuda_ms"].append(t_card)
                times["cpu_ms"].append(t_host)
        if not verdicts or len(printed) != len(verdicts) + sum(
                ln.startswith("[skip]") for ln in printed):
            raise AssertionError(f"ledger (c): verdicts {verdicts}\n{out}")
        boot = {k: round(float(np.median(v)), 3) for k, v in times.items()}
        log("ledger", f"(c) diff r01 r02 --device cuda: {len(verdicts)} keys, every "
                      f"CI on the card == the CPU's within rtol {LEDGER_CI_RTOL}, "
                      f"verdicts equal: {json.dumps(verdicts)}; "
                      f"{len(times['cuda_ms'])} bootstrapped keys, median ms a "
                      f"key (two bootstraps) card {boot['cuda_ms']} vs cpu "
                      f"{boot['cpu_ms']}; the command {walls['diff_s']} s | {smi}")

        # -- (d) an injected x3 regression ---------------------------------------
        write_artifact(runs, inject_latency(arts["r02"], LEDGER_INJECT, "r03"))
        rc, out, err = run_cli("gate_s", ["ledger", "gate", "--offline", "--root",
                                          runs, "--device", "cuda"])
        fails = [ln for ln in out.splitlines() if ln.startswith("[FAIL]")]
        if (rc != 1 or "GATE FAILED" not in err
                or not any(ln.startswith("[FAIL] serve_p99_ms  (") for ln in fails)):
            raise AssertionError(f"ledger (d): gate exit {rc}\n{out}{err}")
        log("ledger", f"(d) r03 = r02 x{LEDGER_INJECT}: gate --offline --device cuda "
                      f"exit 1 in {walls['gate_s']} s, {len(fails)} FAIL lines: "
                      + " / ".join(ln.split("  ")[0][7:] for ln in fails)
                      + f" | {smi}")

        # -- (e) an identical copy ------------------------------------------------
        os.makedirs(same)
        for name in ("GPU_SERVE_r01.json", "GPU_SERVE_r04.json"):
            shutil.copy(paths["r01"], os.path.join(same, name))
        rc, out, err = run_cli("gate_same_s", ["ledger", "gate", "--offline",
                                               "--root", same, "--device", "cuda"])
        if rc != 0 or "[FAIL]" in out or "gate PASSED" not in out:
            raise AssertionError(f"ledger (e): gate exit {rc}\n{out}{err}")
        n_same = sum(ln.startswith("[") for ln in out.splitlines())
        log("ledger", f"(e) r04 = a copy of r01: gate exit 0, no FAIL line, "
                      f"{n_same} keys checked, {walls['gate_same_s']} s")

        # -- (f) the command line ----------------------------------------------------
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "csmom_tpu_torch.cli", "ledger", "gate",
             "--offline", "--root", runs, "--device", "cuda"],
            cwd=tmp, capture_output=True, text=True, timeout=120, env=clean_env())
        walls["gate_cli_s"] = round(time.perf_counter() - t0, 3)
        if p.returncode != 1 or "[FAIL] serve_p99_ms  (" not in p.stdout:
            raise AssertionError(f"ledger (f): exit {p.returncode}\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        log("ledger", f"(f) python -m csmom_tpu_torch.cli ledger gate --offline "
                      f"--device cuda over (d): exit 1, FAIL serve_p99_ms; "
                      f"{walls['gate_cli_s']} s with the process start")

        # -- (g) roadmap ------------------------------------------------------------
        doc = os.path.join(tmp, "TRAJECTORY.md")
        with open(doc, "w") as f:
            f.write(f"# H100\n\n{cli_ledger.ROADMAP_BEGIN}\nstale\n"
                    f"{cli_ledger.ROADMAP_END}\n")
        rc, _, err = run_cli("roadmap_s", ["ledger", "roadmap", "--root", runs,
                                           "--roadmap", doc, "--write"])
        with open(doc) as f:
            text = f.read()
        if rc != 0 or "stale" in text or "`GPU_SERVE_r03.json`" not in text:
            raise AssertionError(f"ledger (g): roadmap exit {rc}\n{err}\n{text[:2000]}")
        copy = os.path.join(tmp, "ROADMAP.md")
        shutil.copy(os.path.join(REPO, "ROADMAP.md"), copy)
        with open(copy, "rb") as f:
            before = f.read()
        rc, _, err = run_cli("roadmap_refused_s", ["ledger", "roadmap", "--root",
                                                   runs, "--roadmap", copy,
                                                   "--write"])
        with open(copy, "rb") as f:
            after = f.read()
        if rc != 1 or after != before or "markers missing" not in err:
            raise AssertionError(f"ledger (g): ROADMAP.md copy exit {rc}, "
                                 f"unchanged {after == before}\n{err}")
        log("ledger", f"(g) roadmap --write spliced {text.count('#### ')} tables "
                      f"between the port's markers; a copy of ROADMAP.md refused "
                      f"(exit 1) and byte for byte unchanged")
    walls["phase_s"] = round(time.perf_counter() - t_phase, 2)
    log("ledger", f"walls s {json.dumps(walls)} | {smi}")
    if walls["phase_s"] > LEDGER_BUDGET_S:
        raise AssertionError(f"phase 21 took {walls['phase_s']} s, over its "
                             f"{LEDGER_BUDGET_S} s")
    return {"launches": launches, "walls": walls, "verdicts": verdicts,
            "bootstrap_ms": boot, "wall_s": walls["phase_s"]}


# phase 22: bench and the capture tier on the card.  (a) one real run of
# `bench --device cuda` at the full workload, its records in a temporary
# directory; (b) the ledger over them; (c) the capture tier's scenarios
BENCH_ROUND = "r22"
BENCH_RUN_BUDGET_S = 600      # CSMOM_BENCH_BUDGET of (a)'s run: a cap
BENCH_PHASE_BUDGET_S = 150.0  # the phase's wall, checked
BENCH_HBM_FRACTION_MAX = 1.05
HEADLINE_MAX = 1600
# the legs (a) must measure, by their record keys (the pallas key times
# the kernel impl, K2)
BENCH_MEASURED = ("grid16_rank_s", "grid16_rank_matmul_s", "grid16_rank_pallas_s",
                  "grid16_rank_matmul_bf16_s", "grid16_rank_full_s",
                  "grid16_rank_matmul_full_s", "grid16_rank_full_sharded_s")
BENCH_KERNEL_REPS = 6         # the kernel leg's calls: the first and 5 timed
# (c): the mini and shell tiers and a bench child; the supervisor's
# kill-child-mid-compile runs on the CPU in tier-1 (the phase's 150 s)
CAPTURE_SCENARIOS = ("expire-deadline-between-rows", "hang-mid-row",
                     "stdout-interleave", "clock-skew", "sigkill-mid-row",
                     "land-short-write", "expire-deadline-mid-row")


def bench_phase(smi) -> dict:
    """Phase 22: (a) ``python -m csmom_tpu_torch.cli bench --device cuda``
    in a process of its own at the full workload (``CSMOM_ROUND=r22``,
    ``CSMOM_BENCH_BUDGET=600``, its records in a temporary directory):
    exit 0, one headline line of at most 1600 characters passing
    ``validate_headline_text``, ``GPU_BENCH_FULL_r22.json`` and its
    telemetry sidecar valid, platform ``gpu`` and nvidia-smi's device
    name, ``golden_ok``, every leg of ``BENCH_MEASURED`` a measured float,
    ``grid_hbm_fraction`` at most 1.05, the histrank comparison measured,
    the warm-up child not needed (the libraries are built) or run without
    error, K2 launched by the child at least the kernel leg's calls; (b)
    ``ledger show`` over (a)'s directory: ``grid16_rank_s`` rows on
    platform ``gpu``, no problem; (c) ``rehearse --device cuda`` over
    ``CAPTURE_SCENARIOS``, all green.  Returns the
    child's launches, the record's legs and the walls."""
    import contextlib
    import io

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.obs import ledger as ld

    t_phase = time.perf_counter()
    walls = {}
    name = smi.split(",")[0].strip()
    with tempfile.TemporaryDirectory(prefix="csmom_bench_") as tmp:
        # -- (a) one real run ------------------------------------------------
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "csmom_tpu_torch.cli", "bench", "--device", "cuda"],
            cwd=tmp, capture_output=True, text=True, timeout=BENCH_RUN_BUDGET_S + 120,
            env=clean_env(CSMOM_BENCH_FULL_DIR=tmp, CSMOM_ROUND=BENCH_ROUND,
                          CSMOM_BENCH_BUDGET=str(BENCH_RUN_BUDGET_S)))
        walls["bench_s"] = round(time.perf_counter() - t0, 2)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench (a): exit {p.returncode}, {len(lines)} JSON "
                                 f"lines\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        head = json.loads(lines[0])
        bad = inv.validate_headline_text(p.stdout)
        if bad or len(lines[0]) > HEADLINE_MAX:
            raise AssertionError(f"bench (a): headline {len(lines[0])} chars, {bad}")
        full_name = f"GPU_BENCH_FULL_{BENCH_ROUND}.json"
        side_name = f"GPU_TELEMETRY_{BENCH_ROUND}.json"
        records = {}
        for fname in (full_name, side_name):
            path = os.path.join(tmp, fname)
            if not os.path.isfile(path):
                raise AssertionError(f"bench (a): {fname} did not land; "
                                     f"{sorted(os.listdir(tmp))}")
            with open(path) as f:
                records[fname] = json.load(f)
            bad = inv.validate(records[fname])
            if bad:
                raise AssertionError(f"bench (a): {fname}: {bad}")
        full = records[full_name]
        ex = full["extra"]
        legs = {k: ex.get(k) for k in BENCH_MEASURED}
        unmeasured = {k: v for k, v in legs.items()
                      if not isinstance(v, float) or v <= 0}
        hbm = ex.get("grid_hbm_fraction")
        launches = ex.get("kernel_launches") or {}
        if (head["extra"].get("full_record") != full_name
                or ex.get("platform") != "gpu" or ex.get("device_kind") != name
                or head["extra"].get("device_kind") != name
                or ex.get("golden_ok") is not True
                or not isinstance(full.get("value"), float) or full["value"] <= 0
                or head["value"] != full["value"] or unmeasured
                or not isinstance(hbm, float) or hbm > BENCH_HBM_FRACTION_MAX
                or ex.get("telemetry_sidecar") != side_name
                or launches.get("cohort_partial_sums", 0) < BENCH_KERNEL_REPS):
            raise AssertionError(
                f"bench (a): value {full.get('value')}, platform {ex.get('platform')}, "
                f"device {ex.get('device_kind')!r} (nvidia-smi {name!r}), golden "
                f"{ex.get('golden_ok')} ({ex.get('golden_trades')} trades), unmeasured "
                f"{unmeasured}, hbm fraction {hbm}, launches {launches}, sidecar "
                f"{ex.get('telemetry_sidecar')}, errors {ex.get('attempt_errors')}")
        log("bench", f"(a) bench --device cuda: exit 0 in {walls['bench_s']} s; "
                     f"headline {len(lines[0])} chars: {full['value']} {full['unit']} "
                     f"(x{full['vs_baseline']}), {ex['workload']}, golden_ok "
                     f"({ex['golden_trades']} trades); legs s {json.dumps(legs)}; "
                     f"grid_hbm_fraction {hbm}, {ex['grid_achieved_gbps']} GB/s; "
                     f"event {ex['event_backtest_wall_s']} s, batched "
                     f"{ex['event_batched_per_run_s']} s a run; pack ingest "
                     f"{ex['pack_ingest_s']} s; sharded "
                     f"{ex['grid_full_sharded_workload']}, efficiency "
                     f"{ex['mesh_scaling_efficiency']}; compile totals "
                     f"{json.dumps({k: v for k, v in ex['compile_totals'].items() if k != 'note'})}; "
                     f"child launches {launches} | {smi}")
        hr = ex.get("histrank_vs_allgather")
        warm = ex.get("warmup_child")
        log("bench", f"(a) histrank {json.dumps({k: hr[k] for k in ('allgather_wall_s', 'rank_hist_wall_s', 'workload')} if isinstance(hr, dict) else hr)}; "
                     f"warm-up child {json.dumps({k: warm[k] for k in ('value', 'n_cache_hits', 'n_errors', 'wall_s')} if isinstance(warm, dict) else warm)}; "
                     f"probes {json.dumps(ex['probes'])}; compile legs "
                     f"{json.dumps(ex['compile_legs'])}")
        # the libraries are built in phase 2, so the warm-up child has
        # nothing to build; had it run, it must have warmed without error
        if not isinstance(hr, dict) or (warm["n_errors"] if isinstance(warm, dict)
                                        else not warm.startswith("not needed:")):
            raise AssertionError(f"bench (a): histrank {hr}, warm-up {warm}")

        # -- (b) the ledger over (a)'s records ---------------------------------
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["ledger", "show", "--root", tmp])
        walls["show_s"] = round(time.perf_counter() - t0, 3)
        L = ld.load(tmp)
        rank_rows = [r for r in L.rows if r.metric == "grid16_rank_s"]
        if (rc != 0 or L.problems or not rank_rows
                or not all(r.platform == "gpu" for r in rank_rows)
                or "grid16_rank_s" not in out.getvalue()):
            raise AssertionError(f"bench (b): show exit {rc}, problems {L.problems}, "
                                 f"rows {rank_rows}\n{out.getvalue()}{err.getvalue()}")
        log("bench", f"(b) ledger show: {len(L.rows)} rows, grid16_rank_s "
                     f"{[(r.run, r.platform, r.value, len(r.samples)) for r in rank_rows]}, "
                     f"no problem, {walls['show_s']} s")

        # -- (c) the capture tier on the card ------------------------------------
        args = ["--device", "cuda", "--sandbox", os.path.join(tmp, "rh")]
        for scen in CAPTURE_SCENARIOS:
            args += ["--only", scen]
        t0 = time.perf_counter()
        p, rows = run_rehearse(args, os.path.join(tmp, "tel"), tmp)
        walls["capture_s"] = round(time.perf_counter() - t0, 2)
        want = f"{len(CAPTURE_SCENARIOS)}/{len(CAPTURE_SCENARIOS)} scenarios green"
        if p.returncode != 0 or want not in p.stdout or set(rows) != set(CAPTURE_SCENARIOS):
            raise AssertionError(f"bench (c): exit {p.returncode}\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        walls["scenarios_s"] = {n: w for n, (_, _, w) in rows.items()}
        log("bench", f"(c) rehearse --device cuda over the capture tier: {want}; "
                     f"the command {walls['capture_s']} s; scenario walls s "
                     f"{json.dumps(walls['scenarios_s'])} | {smi}")
    walls["phase_s"] = round(time.perf_counter() - t_phase, 2)
    log("bench", f"phase walls s {json.dumps({k: v for k, v in walls.items() if k != 'scenarios_s'})} | {smi}")
    if walls["phase_s"] > BENCH_PHASE_BUDGET_S:
        raise AssertionError(f"phase 22 took {walls['phase_s']} s, over its "
                             f"{BENCH_PHASE_BUDGET_S} s")
    return {"launches": {"decile_partial_sums": launches.get("decile_partial_sums", 0),
                         "cohort_partial_sums": launches["cohort_partial_sums"]},
            "legs": legs, "walls": walls, "wall_s": walls["phase_s"]}


# phase 23: buffer donation on the card.  Each donated surface against its
# plain call on the same inputs, in this process (no subprocess, no
# profiler trace): outputs bit-equal, the caller's tensors consumed (empty),
# and the allocator's peak over the call, read once the inputs are
# resident, no higher for the donated call than for the plain one.
DONATION_BUDGET_S = 20.0      # the phase's wall, checked
# (b)'s synthetic minute panel: assets x (trading days x minutes a day)
DONATION_MINUTES = (512, 60 * 390)
DONATION_SEED = 23


def donation_phase(smi, pm, mm) -> dict:
    """Phase 23: (a) ``jk_grid_backtest(..., donate_panels=True)`` on
    phase 5's north-star month-end panel ``pm, mm`` (``[3000, 696]`` f32,
    rank mode, ``impl="kernel"``: K2 as often as in the plain call), then
    ``grid_net_of_costs(..., donate_panels=True)`` on that grid; (b)
    ``event_backtest_donated`` and ``hysteresis_event_backtest(...,
    donate_panels=True)`` on a seeded ``[512, 23,400]`` f32 minute panel
    (512 assets x 60 days x 390 minutes); (c) the ``backtest`` serve
    engine's ``spec.donated(...)`` scorer at the largest bucket of profile
    ``serve`` (K1 once); (d) a read after donation: each consumed tensor
    reads as empty on the card, and a plain call on fresh copies of (b)'s
    inputs, made after the donated calls, is bit-equal to (b)'s plain
    call.  For every surface: outputs bit-equal to the plain call's, the
    caller's tensors consumed, both peaks on a ``[donation]`` line, the
    donated one at most the plain one.  Returns the phase's launches,
    the peaks and its wall."""
    import dataclasses

    import torch

    from csmom_tpu_torch.backtest.event import (
        event_backtest, event_backtest_donated, hysteresis_event_backtest,
    )
    from csmom_tpu_torch.backtest.grid import grid_net_of_costs, jk_grid_backtest
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.registry import get_engine
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.engine import serve_entry_fn
    from csmom_tpu_torch.serve.service import ServeConfig
    from csmom_tpu_torch.utils.donation import is_deleted
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS, GRID_SKIP

    t_phase = time.perf_counter()
    dev = pm.device
    kernels.reset_launches()
    peaks = {}

    def leaves(x):
        if torch.is_tensor(x):
            return [x]
        if dataclasses.is_dataclass(x):
            return [v for f in dataclasses.fields(x)
                    for v in leaves(getattr(x, f.name))]
        return []

    # same-width integer views: bit-equal floats, NaN payloads included
    bits = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.float16: torch.int16, torch.bfloat16: torch.int16,
            torch.bool: torch.uint8}

    def bit_equal(a, b) -> bool:
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) > 0 and all(
            x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.view(bits.get(x.dtype, x.dtype)),
                            y.view(bits.get(y.dtype, y.dtype)))
            for x, y in zip(la, lb))

    def k_counts():
        return {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}

    def measured(call, inputs):
        """``call(*inputs)`` with ``inputs`` resident: ``(out, peak bytes
        above the allocation at the call, launches)``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k0 = k_counts()
        out = call(*inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return out, peak, {k: v - k0[k] for k, v in k_counts().items()}

    def compare(name, plain_fn, donated_fn, masters, launches_want=None):
        """One surface: a plain call and a donated one, each on fresh
        copies of ``masters`` made before its peak is read."""
        plain, p_peak, p_k = measured(plain_fn, [t.clone() for t in masters])
        copies = [t.clone() for t in masters]
        nbytes = sum(t.numel() * t.element_size() for t in copies)
        got, d_peak, d_k = measured(donated_fn, copies)
        if not bit_equal(got, plain):
            raise AssertionError(f"donation ({name}): the donated call's "
                                 "outputs differ from the plain call's")
        if not all(is_deleted(t) and t.numel() == 0 for t in copies):
            raise AssertionError(f"donation ({name}): the caller's tensors "
                                 "were not consumed")
        if d_k != p_k or (launches_want is not None and d_k != launches_want):
            raise AssertionError(f"donation ({name}): launches {d_k}, the plain "
                                 f"call's {p_k}, want {launches_want}")
        if d_peak > p_peak:
            raise AssertionError(f"donation ({name}): the donated peak {d_peak} B "
                                 f"exceeds the plain call's {p_peak} B")
        peaks[name] = {"plain_peak_bytes": p_peak, "donated_peak_bytes": d_peak,
                       "saved_bytes": p_peak - d_peak, "consumed_bytes": nbytes,
                       "launches": d_k}
        log("donation", f"({name}) peak over the call: plain {p_peak} B, donated "
                        f"{d_peak} B, difference {p_peak - d_peak} B; consumed "
                        f"{nbytes} B; outputs bit-equal; launches {d_k} | {smi}")
        return plain, got

    # (a) the grid on phase 5's north-star panel, and its netting pass
    grid_kw = dict(skip=GRID_SKIP, mode="rank", impl="kernel")
    g_plain, _ = compare(
        "a grid", lambda p, m: jk_grid_backtest(p, m, GRID_JS, GRID_KS, **grid_kw),
        lambda p, m: jk_grid_backtest(p, m, GRID_JS, GRID_KS, donate_panels=True,
                                      **grid_kw),
        [pm, mm])
    if peaks["a grid"]["launches"]["cohort_partial_sums"] < 1:
        raise AssertionError("donation (a): K2 was not launched")
    compare("a grid_net_of_costs",
            lambda p, m: grid_net_of_costs(p, m, g_plain, half_spread=0.0005),
            lambda p, m: grid_net_of_costs(p, m, g_plain, half_spread=0.0005,
                                           donate_panels=True),
            [pm, mm])

    # (b) the event engines on a seeded minute panel, made on the card
    A, T = DONATION_MINUTES
    gen = torch.Generator(device=dev).manual_seed(DONATION_SEED)
    steps = torch.randn((A, T), generator=gen, device=dev) * 1e-3
    valid = torch.rand((A, T), generator=gen, device=dev) > 0.2
    price = torch.where(valid, 100.0 * torch.exp(torch.cumsum(steps, dim=1)),
                        torch.nan)
    score = torch.where(valid, torch.randn((A, T), generator=gen, device=dev) * 1e-4,
                        torch.nan)
    del steps
    adv = torch.full((A,), 1e6, device=dev)
    vol = torch.full((A,), 0.02, device=dev)
    masters = [price, valid, score]
    ev_plain, _ = compare(
        "b event_backtest_donated",
        lambda p, v, s: event_backtest(p, v, s, adv, vol),
        lambda p, v, s: event_backtest_donated(p, v, s, adv, vol), masters)
    hy = dict(threshold_hi=1e-4, threshold_lo=2e-5)
    compare("b hysteresis_event_backtest",
            lambda p, v, s: hysteresis_event_backtest(p, v, s, adv, vol, **hy),
            lambda p, v, s: hysteresis_event_backtest(p, v, s, adv, vol,
                                                      donate_panels=True, **hy),
            masters)

    # (c) the serve scorer at the largest bucket of profile "serve"
    cfg = ServeConfig()
    B, A_s, M_s = max(bucket_spec("serve").shapes())
    vals = 100.0 * torch.exp(torch.cumsum(
        torch.randn((B, A_s, M_s), generator=gen, device=dev) * 0.05, dim=-1))
    vmask = torch.rand((B, A_s, M_s), generator=gen, device=dev) > 0.05
    params = dict(lookback=cfg.lookback, skip=cfg.skip, n_bins=cfg.n_bins,
                  mode=cfg.mode)
    compare(f"c serve backtest b{B}@{A_s}x{M_s}",
            serve_entry_fn("backtest", cfg.lookback, cfg.skip, cfg.n_bins, cfg.mode),
            get_engine("backtest", kind="serve").donated(**params),
            [vals.to(torch.float32), vmask],
            launches_want={"decile_partial_sums": 1, "cohort_partial_sums": 0})

    # (d) a read after donation, and the plain engine on fresh copies
    gone = [t.clone() for t in masters]
    event_backtest_donated(*gone, adv, vol)
    torch.cuda.synchronize()
    if any(t.numel() != 0 or float(t.sum()) != 0.0 for t in gone):
        raise AssertionError("donation (d): a consumed tensor does not read as empty")
    again = event_backtest(*[t.clone() for t in masters], adv, vol)
    if not bit_equal(again, ev_plain):
        raise AssertionError("donation (d): a plain call after the donated ones "
                             "differs from (b)'s plain call")
    log("donation", "(d) consumed tensors read as empty (numel 0, sum 0); a plain "
                    "call on fresh copies after the donated calls is bit-equal to "
                    f"(b)'s | {smi}")

    launches = k_counts()
    wall = round(time.perf_counter() - t_phase, 2)
    log("donation", f"phase wall {wall} s; launches {launches}; peaks "
                    f"{json.dumps(peaks)} | {smi}")
    if wall > DONATION_BUDGET_S:
        raise AssertionError(f"phase 23 took {wall} s, over its "
                             f"{DONATION_BUDGET_S} s")
    return {"launches": launches, "peaks": peaks, "wall_s": wall}


# phase 18: the mesh serving engine on the card, every mesh logical shards
# of cuda:0.  (a) SERVE_MESH_r15.json's configuration: the bursty schedule
# (seed 0, 240 arrivals), the five endpoints, its class mix, panel reuse and
# version bump, profile "serve" f32, on 8 devices
MESH_SERVE_DEVICES = 8
MESH_SERVE_REPS = 9          # synchronized dispatch walls, median
MESH_SERVE_SUBDIR = "mesh-serve"
# (d) two mesh workers pinned to 4 logical shards of cuda:0 each (the form
# auto_mesh(n, device="cuda:0") takes), a 5 s burst shaped like bursty's
MESH_POOL = dict(workers=2, devices_per_worker=4, device="cuda:0",
                 schedule="0.5x8,1x200,0.5x10,1.5x240,1x20,0.5x8", seed=18)


def serve_mesh_phase(smi, out_dir, assert_sums, inproc) -> dict:
    """Phase 18: the mesh serving engine on logical shards of ``cuda:0``.
    ``inproc`` is phase 11's result: its single-device bursty headline,
    printed beside (a)'s, and K1's device time at ``[128, 60]`` and
    ``[128, 480]`` (timed there, before any service ran).  Returns (a)'s
    launch counts (the service's warm-up and serving window) and the
    phase's wall; it takes no profiler trace."""
    import shutil
    import statistics

    import torch

    from csmom_tpu_torch.chaos import invariants as inv
    from csmom_tpu_torch.mesh.pinning import shards_for
    from csmom_tpu_torch.mesh.rules import P, named_mesh, serve_axis_for
    from csmom_tpu_torch.mesh.variants import sharded_serve_entry_fn
    from csmom_tpu_torch.obs import trace as obs_trace
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.parallel.compat import shard_map
    from csmom_tpu_torch.registry import serve_endpoints
    from csmom_tpu_torch.serve import health
    from csmom_tpu_torch.serve.buckets import bucket_spec
    from csmom_tpu_torch.serve.engine import TorchEngine, serve_entry_fn, unpack_result
    from csmom_tpu_torch.serve.loadgen import (
        LoadConfig, resolve_schedule, run_loadgen, run_pool_loadgen, write_artifact,
    )
    from csmom_tpu_torch.serve.queue import Request
    from csmom_tpu_torch.serve.router import Router, RouterConfig
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService
    from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    spec = bucket_spec("serve")
    kinds = serve_endpoints()
    rng = np.random.default_rng(18)
    with open(os.path.join(REPO, "SERVE_MESH_r15.json")) as f:
        ref = json.load(f)
    ref_mesh = {k: v for k, v in ref["extra"]["mesh"].items() if k != "scaling"}
    schedule, schedule_kind, preset = resolve_schedule("bursty")
    if (schedule, ref["offered"]["n_arrivals"]) != (ref["offered"]["schedule"], 240):
        raise AssertionError("serve mesh: the bursty schedule is not SERVE_MESH_r15's")
    devices = (dev,) * MESH_SERVE_DEVICES

    def launched():
        return {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}

    single = TorchEngine(device=dev)
    single.warm(spec)

    # -- (a) serve_mesh_r15 -----------------------------------------------------
    def cell(run_id, armed):
        """One service on the mesh under the bursty schedule: its artifact,
        requests, backtest batch sizes, launches (warm-up, window) and,
        armed, its closed traces."""
        kernels.reset_launches()
        svc = SignalService(ServeConfig(profile="serve", engine="torch-mesh",
                                        devices=devices))
        svc.start()
        torch.cuda.synchronize()
        warm_launches = launched()
        score = svc.engine.score
        batches = []

        def recording_score(kind, values, mask):
            batches.append((kind, values.shape[0], values.shape[1]))
            return score(kind, values, mask)

        svc.engine.score = recording_score
        submitted = []
        submit = svc.submit

        def recording_submit(*a, **kw):
            req = submit(*a, **kw)
            submitted.append(req)
            return req

        svc.submit = recording_submit
        closed = []
        book = obs_trace.arm_tracing(seed=0) if armed else None
        if book is not None:
            record = book.record
            book.record = lambda ctx: (closed.append(ctx), record(ctx))[1]
        try:
            art = run_loadgen(svc, LoadConfig(schedule=schedule, schedule_kind=schedule_kind,
                                              seed=0, run_id=run_id, **preset))
        finally:
            if book is not None:
                obs_trace.disarm_tracing()
        torch.cuda.synchronize()
        total = launched()
        return svc, art, submitted, batches, warm_launches, total, closed, book

    svc, art, submitted, batches, warm_l, total_l, _, _ = cell("r15", armed=False)
    warm = svc.warm_report
    art_mesh = {k: v for k, v in art["extra"]["mesh"].items() if k != "scaling"}
    if warm["n_shapes_warmed"] != 30 or warm["mesh"] != ref_mesh or art_mesh != ref_mesh:
        raise AssertionError(f"serve mesh (a): warm report {warm['n_shapes_warmed']} "
                             f"shapes, mesh {warm['mesh']} against SERVE_MESH_r15's "
                             f"{ref_mesh} (artifact's {art_mesh})")
    # K1 once a batch shard: the warm-up's backtest shapes, then the window's
    want_warm = sum(shards_for(B, MESH_SERVE_DEVICES) for B, _, _ in spec.shapes())
    bt = [B for kind, B, _ in batches if kind == "backtest"]
    want_window = sum(shards_for(B, MESH_SERVE_DEVICES) for B in bt)
    window_k1 = total_l["decile_partial_sums"] - warm_l["decile_partial_sums"]
    if (warm_l != {"decile_partial_sums": want_warm, "cohort_partial_sums": 0}
            or window_k1 != want_window or total_l["cohort_partial_sums"]):
        raise AssertionError(f"serve mesh (a): launches warm {warm_l} (K1 want "
                             f"{want_warm}), window K1 {window_k1} against "
                             f"sum shards_for(B, 8) = {want_window} over {len(bt)} "
                             f"backtest batches {bt}")
    viols = svc.invariant_violations() + inv.validate(art)
    for name, b in art["classes"].items():
        if b["served"] + b["rejected"] + b["expired"] != b["admitted"]:
            viols.append(f"class {name} books open: {b}")
    for name, b in art["endpoints"].items():
        if b["served"] + b["rejected"] + b["expired"] != b["submitted"]:
            viols.append(f"endpoint {name} books open: {b}")
    if viols or art["compile"]["in_window_fresh_compiles"] != 0 \
            or art["requests"]["rejected_worker_crash"]:
        raise AssertionError(f"serve mesh (a): {viols}; fresh "
                             f"{art['compile']['in_window_fresh_compiles']!r}; "
                             f"requests {art['requests']}")
    path = write_artifact(out_dir, art, prefix="GPU_SERVE_MESH")
    if os.path.basename(path) != "GPU_SERVE_MESH_r15.json" or inv.validate_file(path):
        raise AssertionError(f"serve mesh (a): {path}: {inv.validate_file(path)}")
    # every served result against the single-device engine scoring it alone
    bits = {k: {"served": 0, "bit_equal": 0, "max_abs_diff": 0.0} for k in kinds}
    for r in submitted:
        if r.state != "served":
            continue
        mb = svc.batcher.pad([Request(kind=r.kind, values=r.values, mask=r.mask,
                                      n_assets=r.n_assets)])
        alone = unpack_result(r.kind, single.score(r.kind, mb.values, mb.mask), 0,
                              r.n_assets)
        got = (np.array(list(r.result.values())) if isinstance(alone, dict)
               else np.asarray(r.result))
        want = np.array(list(alone.values())) if isinstance(alone, dict) else alone
        err = hold_scores(got, want, f"serve mesh (a): a served {r.kind}", False)
        b = bits[r.kind]
        b["served"] += 1
        b["bit_equal"] += int(got.tobytes() == want.tobytes())
        b["max_abs_diff"] = max(b["max_abs_diff"], err)
    lat = art["latency_ms"]["total"]
    head = serve_metrics(art)
    log("serve-mesh", f"(a) serve_mesh_r15: bursty seed 0 ({len(submitted)} arrivals) on "
                      f"{MESH_SERVE_DEVICES} logical shards of {dev}: {art['value']} req/s "
                      f"achieved vs {art['offered']['offered_rps']} offered over "
                      f"{art['wall_s']} s; p50 {lat['p50']} p95 {lat['p95']} p99 "
                      f"{lat['p99']} ms; requests {json.dumps(art['requests'])}; warm "
                      f"report 30 shapes, its mesh block == SERVE_MESH_r15's shard for "
                      f"shard; books closed per class and endpoint; 0 built in the "
                      f"window; K1 warm-up {warm_l['decile_partial_sums']} + window "
                      f"{window_k1} = sum shards_for(B, 8) over {len(bt)} backtest "
                      f"batches; artifact valid ({path}) | {smi}")
    log("serve-mesh", f"(a) every served result vs the single-device engine alone, "
                      f"within {SERVE_F32}, by endpoint: {json.dumps(bits)}")
    log("serve-mesh", f"(a) headline, the JAX ledger's names: mesh d8 "
                      f"{json.dumps(head)}; phase 11's single-device bursty, same "
                      f"process {json.dumps(inproc['cells']['bursty'])}")
    eng = svc.engine

    # the same cell traced: each dispatch carries the mesh's size and split
    _, art_t, _, _, _, _, closed, book = cell("r15-traced", armed=True)
    n_mesh = 0
    for ctx in closed:
        if ctx.outcome != "served" or "dispatch" not in dict(ctx.marks):
            continue
        B, A = (int(x) for x in ctx.attrs["bucket"].split("x"))
        want = (MESH_SERVE_DEVICES, shards_for(
            B if serve_axis_for(ctx.endpoint) == "batch" else A, MESH_SERVE_DEVICES))
        got = (ctx.attrs.get("mesh_devices"), ctx.attrs.get("mesh_shards"))
        if got != want:
            raise AssertionError(f"serve mesh (a) traced: {ctx.endpoint} bucket "
                                 f"{B}x{A} dispatch attrs {got}, want {want}")
        n_mesh += 1
    if not n_mesh or book.invariant_violations() or inv.validate(art_t):
        raise AssertionError(f"serve mesh (a) traced: {n_mesh} dispatched traces; "
                             f"{book.invariant_violations()} {inv.validate(art_t)}")
    log("serve-mesh", f"(a) traced repeat: {n_mesh} dispatched traces of "
                      f"{len(closed)} each carry mesh_devices 8 and the shard count "
                      f"of their bucket; trace books closed; p99 "
                      f"{art_t['latency_ms']['total']['p99']} ms armed | {smi}")

    # -- (b) the scaling probe and one backtest dispatch by shard count ----------
    probe = eng.scaling_probe(spec)
    log("serve-mesh", f"(b) scaling probe (host to host, best of 5): {json.dumps(probe)} "
                      f"| {smi}")
    v, m, _ = serve_batch(rng, "backtest", 8, 128, np.float32)
    vt, mt = torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)
    one = serve_entry_fn("backtest", 12, 1, 10, "rank")
    ref8 = one(vt, mt)
    walls = {}
    for d in (1, 4, 8):
        entry = sharded_serve_entry_fn("backtest", 12, 1, 10, "rank", devices=[dev] * d)
        forms = {"serial": entry}
        if d > 1:  # the same shards, one thread each (shard_map's default)
            spec_b = P("batch", None, None)
            forms["threads"] = shard_map(one, mesh=named_mesh("batch", d, [dev] * d),
                                         in_specs=(spec_b, spec_b),
                                         out_specs=P("batch", None))
        for form, fn in forms.items():
            out = fn(vt, mt)
            kernels.reset_launches()
            fn(vt, mt)
            torch.cuda.synchronize()
            k1 = kernels.decile_partial_sums.launches
            if k1 != shards_for(8, d):
                raise AssertionError(f"serve mesh (b) d{d} {form}: K1 {k1} a dispatch")
            hold_scores(out.cpu().numpy(), ref8.cpu().numpy(),
                        f"serve mesh (b) backtest d{d} {form}", False)
            ws = []
            for _ in range(MESH_SERVE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(vt, mt)
                torch.cuda.synchronize()
                ws.append((time.perf_counter() - t0) * 1e3)
            walls[f"d{d}_{form}"] = statistics.median(ws)
    log("serve-mesh", f"(b) one backtest B=8 A=128 dispatch (inputs on the card), "
                      f"synchronized wall ms, median of {MESH_SERVE_REPS}: "
                      f"{json.dumps(walls)}; K1 launches a dispatch 1 / 4 / 8 | {smi}")
    # the sharded scorers against the single-device one on the same batch
    eq = {}
    for kind in kinds:
        v, m, _ = serve_batch(rng, kind, 8, 128, np.float32)
        vt, mt = torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)
        got = sharded_serve_entry_fn(kind, 12, 1, 10, "rank",
                                     devices=devices)(vt, mt).cpu().numpy()
        want = serve_entry_fn(kind, 12, 1, 10, "rank")(vt, mt).cpu().numpy()
        err = hold_scores(got, want, f"serve mesh (b) {kind} d8 vs one device", False)
        eq[kind] = {"bit_equal": got.tobytes() == want.tobytes(), "max_abs_diff": err}
    log("serve-mesh", f"(b) each endpoint's d8 scorer vs the single-device scorer on "
                      f"one B=8 A=128 batch, within {SERVE_F32}: {json.dumps(eq)}")
    # K1 against its plain version at a d8 batch shard's shape
    v, m, _ = serve_batch(rng, "backtest", 1, 128, np.float32)
    r, lab, _ = k1_inputs_of(single, v, m)
    s_, c_ = kernels.decile_partial_sums(r, lab, 10)
    ps, pc = kernels.decile_partial_sums_plain(r, lab, 10)
    absum, _ = kernels.decile_partial_sums_plain(r.abs(), lab, 10)
    torch.cuda.synchronize()
    if list(r.shape) != [128, 60] or not torch.equal(c_, pc):
        raise AssertionError(f"serve mesh K1 {list(r.shape)}: counts differ")
    assert_sums(s_, ps, absum, r.dtype, f"serve mesh K1 {list(r.shape)}")
    log("serve-mesh", f"(b) K1 == plain at a d8 batch shard's shape [128, 60] (max "
                      f"|err| {(s_ - ps).abs().max().item()}); K1 device time, timed "
                      f"in phase 11 (d) before any service ran: {json.dumps(inproc['k1_at'])} "
                      f"| {smi}")
    # -- (c) the serve-mesh warm-up and loadgen --mesh, processes of their own ----
    tmp = tempfile.mkdtemp(prefix="csmom_smw_")
    try:
        report, _, warm_s = run_warmup(REPO, tmp, profiles="serve-mesh",
                                       subdir=MESH_SERVE_SUBDIR)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    entries = {r["name"]: r for r in report["entries"]
               if r["name"].startswith("mesh.serve.")}
    want_names = health.expected_entry_names("serve", mesh_devices=torch.cuda.device_count())
    bad = [n for n, r in entries.items() if r.get("error")
           or not (r.get("cache_hit") or r.get("libraries_built"))]
    if report["n_errors"] or set(entries) != want_names or bad:
        raise AssertionError(f"serve mesh (c) warm-up: {report['n_errors']} errors; "
                             f"entries {sorted(entries)} against {sorted(want_names)}; "
                             f"neither hit nor built {bad}")
    wl = warm_launches({"entries": list(entries.values())})
    log("serve-mesh", f"(c) warmup --profiles serve-mesh --strict: {len(entries)} mesh "
                      f"entries (== the health check's names at "
                      f"d{torch.cuda.device_count()}), all cache hits or built, 0 "
                      f"errors, report read back; {warm_s:.1f} s of command; their "
                      f"launches {wl} | {smi}")
    argv = ["loadgen", "--mesh", "--smoke", "--out", out_dir, "--run-id",
            "chip-mesh-smoke"]
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "csmom_tpu_torch.cli", *argv],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO})
    lg_s = time.perf_counter() - t0
    lg_path = os.path.join(out_dir, "GPU_SERVE_MESH_chip-mesh-smoke.json")
    if p.returncode != 0 or not os.path.exists(lg_path) or inv.validate_file(lg_path):
        raise AssertionError(f"serve mesh (c) {' '.join(argv)}: exit {p.returncode}\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    log("serve-mesh", f"(c) {' '.join(argv[:3])}: exit 0 in {lg_s:.1f} s, artifact valid; "
                      + " / ".join(ln.strip() for ln in p.stdout.splitlines()
                                   if ln.startswith(("  mesh:", "throughput",
                                                     "in-window"))) + f" | {smi}")

    # -- (d) a pinned pool: two mesh workers, 4 logical shards of cuda:0 each ----
    run_dir = tempfile.mkdtemp(prefix="csmom_smp_")
    sup = PoolSupervisor(PoolConfig(
        n_workers=MESH_POOL["workers"], profile="serve", engine="torch-mesh",
        device=MESH_POOL["device"], devices_per_worker=MESH_POOL["devices_per_worker"],
        require_warm_cache=True, ready_timeout_s=180.0), run_dir)
    router = None
    try:
        t0 = time.perf_counter()
        sup.start()
        spawn_s = time.perf_counter() - t0
        dpw = MESH_POOL["devices_per_worker"]
        for h in sup.handles:
            rep = h.ready_report or {}
            if (h.device_slice != f"{h.slot * dpw}:{dpw}"
                    or rep.get("device_slice") != h.device_slice
                    or (rep.get("warm") or {}).get("mesh", {}).get("devices") != dpw
                    or rep.get("fresh_compiles") != 0 or rep.get("platform") != "gpu"):
                raise AssertionError(f"serve mesh (d) {h.worker_id}: slice "
                                     f"{h.device_slice}, ready report {rep}")
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve", default_deadline_s=0.5, hedge_fraction=0.35),
            retry_after_fn=sup.retry_after_s)
        art_p = run_pool_loadgen(router, sup, LoadConfig(
            schedule=MESH_POOL["schedule"], seed=MESH_POOL["seed"],
            class_mix=preset["class_mix"], deadline_s=0.5, run_id="chip-mesh-pool"))
        viols = inv.validate(art_p) + router.invariant_violations()
        for name, b in router.class_accounting().items():
            if b["served"] + b["rejected"] + b["expired"] != b["admitted"]:
                viols.append(f"class {name} books open: {b}")
        stats = sup.worker_stats()
        pool_launches = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
        for w in stats:
            for k in pool_launches:
                pool_launches[k] += (w.get("kernel_launches") or {}).get(k, 0)
        if (viols or art_p["requests"]["rejected_infra"]
                or art_p["compile"]["in_window_fresh_compiles"] != 0):
            raise AssertionError(f"serve mesh (d): {viols}; requests "
                                 f"{art_p['requests']}; fresh "
                                 f"{art_p['compile']['in_window_fresh_compiles']!r}")
        write_artifact(out_dir, art_p, prefix="GPU_SERVE_POOL")
    finally:
        if router is not None:
            router.channels.close()
        sup.stop()
        shutil.rmtree(run_dir, ignore_errors=True)
    if any(h.proc.poll() is None for h in sup.handles):
        raise AssertionError("serve mesh (d): a worker outlived the supervisor's stop")
    lat_p = art_p["latency_ms"]["total"]
    log("serve-mesh", f"(d) pinned pool: {MESH_POOL['workers']} torch-mesh workers on "
                      f"slices {[h.device_slice for h in sup.handles]} of "
                      f"{MESH_POOL['device']} (d{dpw} each, ready in {spawn_s:.1f} s), "
                      f"{MESH_POOL['schedule']} seed {MESH_POOL['seed']}: "
                      f"{art_p['value']} req/s over {art_p['wall_s']} s, p50 "
                      f"{lat_p['p50']} p99 {lat_p['p99']} ms; requests "
                      f"{json.dumps(art_p['requests'])}; books closed across "
                      f"processes, rejected_infra 0, 0 built in the window; the "
                      f"workers' launches {pool_launches} | {smi}")
    return {"launches": total_l, "wall_s": time.perf_counter() - t_phase}


# (name fragment, HBM bytes/s, f32 FLOP/s outside the tensor cores): the
# vendor data sheets' figures; the first fragment found in the device
# name wins
CARDS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", None, 67e12),  # HBM rate: utils.profiling.PEAK_HBM_GBPS
)

# The first versions of K1 (one thread per month over asset chunks) and
# K2 (one thread per (j, month, 4 horizons) over asset chunks), each with
# a second pass over the chunk partials, since replaced: their device time
# at the main-path shape, f32, by phases.time_kernels on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md, section 6).  Recorded figures, printed
# beside this run's times on log lines and never in the kernels line,
# whose numbers are all measured by the run that prints them.
K1_FIRST_VERSION_DEVICE_MS = 0.0288
K2_FIRST_VERSION_DEVICE_MS = 0.408012

# f64: the JAX package's own tolerance between its kernel forms
F64_TOL = dict(rtol=1e-10, atol=1e-13)
# f32: 24-bit significands (u = 6e-8).  Two summations of n <= ~600 terms
# in different orders differ by about sqrt(n)*u*sum|x| and at worst by
# n*u*sum|x|, so the relative tolerance is taken against sum|x| (a sum
# can cancel to ~0 while its rounding error cannot): |a-b| <= 1e-6 +
# 1e-5 * sum|x|.
F32_RTOL, F32_ATOL = 1e-5, 1e-6
# f32 spreads: differences of member means of monthly returns (|r| ~ 0.1),
# each mean off by at most ~n*u*mean|r| ~ 2e-6; 1e-5 leaves room for the
# K-cohort average on top
SPREAD_ATOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# each phase's wall, in the order the phases ran (the [smoke] lines)
PHASE_WALLS: dict = {}


def phase_done(n: int, name: str, t0: float) -> float:
    """Log phase ``n``'s wall since ``t0`` on a ``[smoke] phase`` line and
    keep it; returns the clock for the next phase."""
    now = time.perf_counter()
    PHASE_WALLS[f"{n} {name}"] = round(now - t0, 1)
    log("smoke", f"phase {n} {name} {now - t0:.1f} s")
    return now


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--out", help="keep the artifacts of phases 12-15 (pool, "
                                  "fabric, fleet, trace and replay) in this "
                                  "directory (default: a temporary one)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.bootstrap import block_bootstrap_grid
    from csmom_tpu_torch.analytics.stats import nw_t_stat
    from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
    from csmom_tpu_torch.backtest.grid import (
        _cohort_partial_sums, grid_break_even_bps, grid_net_from_unit,
        grid_net_of_costs, jk_grid_backtest,
    )
    from csmom_tpu_torch.backtest.monthly import (
        monthly_spread_backtest, sector_neutral_backtest,
    )
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.ops import build, kernels
    from csmom_tpu_torch.ops.ranking import _rank_labels, decile_assign_panel
    from csmom_tpu_torch.phases import REPS, time_call, time_kernels
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import Panel, to_tensors
    from csmom_tpu_torch.utils.profiling import PEAK_HBM_GBPS, count_dispatches
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.signals.momentum import (
        formation_listed_mask, momentum_dynamic, monthly_returns,
    )
    from csmom_tpu_torch.workloads import (
        GRID_JS, GRID_KS, GRID_SKIP, NORTH_STAR_GRID, north_star_month_panel,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    # -- 1. device ---------------------------------------------------------
    t_smoke = t_p = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    bw, f32_peak = next(((b, f) for frag, b, f in CARDS if frag in kind),
                        (None, None))
    if bw is None and kind in PEAK_HBM_GBPS:
        bw = PEAK_HBM_GBPS[kind] * 1e9
    if bw is None or f32_peak is None:
        raise RuntimeError(f"no memory/compute peak known for {kind!r}")
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"
                  f" | peaks {bw / 1e12:.2f} TB/s, f32 {f32_peak / 1e12:.0f} TFLOP/s")
    t_p = phase_done(1, "device", t_p)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    log("build", f"{len(logs)} kernel(s) compiled in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("build", f"{name}: {line.strip()}")
    t_p = phase_done(2, "build", t_p)

    # -- helpers ---------------------------------------------------------------
    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def assert_sums(got, want, absum, dtype, what):
        if dtype == torch.float64:
            torch.testing.assert_close(got, want, **F64_TOL, msg=what)
        else:
            err = (got - want).abs()
            lim = F32_ATOL + F32_RTOL * absum
            if not bool((err <= lim).all()):
                raise AssertionError(f"{what}: max err {err.max().item()} over "
                                     f"its f32 limit")

    def bound(nbytes, ops):
        """The least time for the work: bytes over the memory rate or
        operations over the f32 peak, whichever is longer."""
        b_ms, o_ms = nbytes / bw * 1e3, ops / f32_peak * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    def k1_case(a, m, n_bins, dtype, all_invalid=False, wild=False):
        # wild: labels from -3 to B+2, so some are >= B or < -1 (no bin)
        lo, hi = (-3, n_bins + 3) if wild else (-1, n_bins)
        labels = rng.integers(lo, hi, size=(a, m)).astype(np.int32)
        valid = (rng.random((a, m)) > 0.2) & (not all_invalid)
        labels = np.where(valid, labels, -1).astype(np.int32)
        member = (labels >= 0) & (labels < n_bins)
        ret = np.where(member, rng.normal(0.0, 0.1, size=(a, m)), 0.0)
        return t(ret, dtype), t(labels)

    def check_k1(ret, labels, n_bins, what):
        s, c = kernels.decile_partial_sums(ret, labels, n_bins)
        again = kernels.decile_partial_sums(ret, labels, n_bins)
        ps, pc = kernels.decile_partial_sums_plain(ret, labels, n_bins)
        absum, _ = kernels.decile_partial_sums_plain(ret.abs(), labels, n_bins)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"{what}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"{what}: counts differ")
        assert_sums(s, ps, absum, ret.dtype, what)
        return (s - ps).abs().max().item() if s.numel() else 0.0

    def k2_case(nj, a, m, n_bins, dtype, extremes=False):
        labels = rng.integers(-1, n_bins, size=(nj, a, m)).astype(np.int32)
        if extremes:  # every lane a member of side 0 or side 1
            labels = np.where(labels % 2 == 0, 0, n_bins - 1).astype(np.int32)
        valid = rng.random((a, m)) > 0.25
        ret = np.where(valid, rng.normal(0.0, 0.1, size=(a, m)), np.nan)
        return t(ret, dtype), t(valid), t(labels)

    def k3_case(shape, dtype, ties=False):
        x = rng.normal(size=shape)
        if ties:
            x = np.round(x * 4) / 4
        valid = rng.random(shape) < 0.85
        return t(np.where(valid, x, np.nan), dtype), t(valid)

    def check_k3(x, valid, n_bins, what):
        got = kernels.rank_labels(x, valid, n_bins)
        again = kernels.rank_labels(x, valid, n_bins)
        want = kernels.rank_labels_plain(x, valid, n_bins)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            if not torch.equal(g, a):
                raise AssertionError(f"{what}: two launches differ")
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: K3 differs from its plain version "
                                     f"in {int((g != w).sum())} places")

    def check_k2(ret, valid, labels, n_bins, H, what):
        s, c = kernels.cohort_partial_sums(ret, valid, labels, n_bins, H)
        again = kernels.cohort_partial_sums(ret, valid, labels, n_bins, H)
        ps, pc = kernels.cohort_partial_sums_plain(ret, valid, labels, n_bins, H)
        absum, _ = kernels.cohort_partial_sums_plain(
            torch.where(valid, ret, 0.0).abs(), valid, labels, n_bins, H)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"{what}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"{what}: counts differ")
        assert_sums(s, ps, absum, ret.dtype, what)
        return (s - ps).abs().max().item() if s.numel() else 0.0

    # -- 3. kernels against their plain versions --------------------------------
    n_checks = 0
    for dtype in (torch.float64, torch.float32):
        # K1's tiling: clusters of 8 asset slices (A < 8 leaves ranks
        # empty), month tiles of lanes x V, 16-byte loads only where M % V
        # == 0 (M odd or = 2 mod 4 takes scalar loads), up to 16 bins a
        # block, more in bin groups (B = 20, 33)
        for a, m, nb in [(16, 24, 10), (256, 128, 10), (300, 130, 10),
                         (37, 7, 10), (50, 40, 3), (511, 257, 10),
                         (300, 130, 20), (64, 30, 1), (3000, 696, 10),
                         (40, 33, 10), (50, 30, 10), (20, 5, 10), (30, 1, 10),
                         (5, 40, 10), (1, 64, 10), (1, 1, 1), (100, 60, 5),
                         (120, 48, 3), (90, 36, 33), (3001, 697, 10)]:
            check_k1(*k1_case(a, m, nb, dtype), nb, f"K1 {a}x{m} B={nb} {dtype}")
            n_checks += 1
        check_k1(*k1_case(20, 16, 5, dtype, all_invalid=True), 5,
                 f"K1 all-invalid {dtype}")
        for a, m, nb in [(300, 130, 10), (64, 40, 5), (33, 24, 3), (50, 44, 20)]:
            check_k1(*k1_case(a, m, nb, dtype, wild=True), nb,
                     f"K1 labels >= B and < -1 {a}x{m} B={nb} {dtype}")
        # storage one element off 16-byte alignment: scalar loads at M = 696
        ret, labels = k1_case(64, 696, 10, dtype)
        ret_off = torch.empty(ret.numel() + 1, dtype=dtype, device=dev)[1:].view(64, 696)
        lab_off = torch.empty(labels.numel() + 1, dtype=torch.int32, device=dev)[1:].view(64, 696)
        ret_off.copy_(ret)
        lab_off.copy_(labels)
        check_k1(ret_off, lab_off, 10, f"K1 misaligned storage {dtype}")
        # K2's tiling: 32-month tiles, clusters of 8 asset slices (A < 8
        # leaves ranks empty), J groups, chunks of 16 horizons (H=128 is
        # the shared-memory worst case), ragged months and assets
        for nj, a, m, h, nb in [(1, 37, 50, 6, 5), (1, 130, 300, 12, 5),
                                (1, 64, 20, 12, 5), (1, 24, 5, 8, 5),
                                (3, 40, 200, 128, 10), (2, 33, 60, 7, 1),
                                (4, 3000, 696, 12, 10), (1, 1, 1, 1, 10),
                                (1, 5, 33, 12, 10), (5, 7, 31, 12, 10),
                                (4, 3001, 697, 12, 10), (2, 40, 200, 128, 10),
                                (3, 50, 45, 17, 10)]:
            check_k2(*k2_case(nj, a, m, nb, dtype), nb, h,
                     f"K2 {nj}x{a}x{m} H={h} B={nb} {dtype}")
            n_checks += 1
        check_k2(*k2_case(2, 300, 130, 10, dtype, extremes=True), 10, 12,
                 f"K2 every label 0 or B-1 {dtype}")
        # valid +-inf returns go through nan_to_num (largest finite value)
        ret, valid, labels = k2_case(1, 16, 12, 4, dtype)
        ret[0, 5], ret[1, 7] = float("inf"), float("-inf")
        valid[0, 5] = valid[1, 7] = True
        s, _ = kernels.cohort_partial_sums(ret, valid, labels, 4, 4)
        ps, _ = kernels.cohort_partial_sums_plain(ret, valid, labels, 4, 4)
        torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-6, equal_nan=True)
        # K3's plans (1 to 8192 lanes a row), ties, B from 1 to 33
        kernels.reset_launches()
        k3_calls = 0
        for shape, nb in [((4, 3000, 696), 10), ((128, 480), 10), ((1, 40), 10),
                          ((127, 33), 3), ((129, 7), 2), ((513, 9), 5),
                          ((1025, 5), 33), ((2049, 4), 10), ((3073, 3), 10),
                          ((4097, 3), 10), ((8192, 20), 10), ((3, 5), 1)]:
            for ties in (False, True):
                check_k3(*k3_case(shape, dtype, ties), nb,
                         f"K3 {shape} B={nb} ties={ties} {dtype}")
                k3_calls += 2
                n_checks += 1
        # valid lanes at +-0, +-inf and NaNs of every kind, the largest
        # payload's key equal to the all-ones pad and invalid key
        if dtype == torch.float64:
            sp = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                           0x7FFFFFFFFFFFFFFF, 0x7FF0000000000001, 0,
                           0x8000000000000000, 0x7FF0000000000000,
                           0xFFF0000000000000], np.uint64).view(np.float64)
        else:
            sp = np.array([0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0x7F800001, 0,
                           0x80000000, 0x7F800000, 0xFF800000],
                          np.uint32).view(np.float32)
        pick = rng.integers(0, len(sp) + 4, size=(300, 40))
        x = np.where(pick < len(sp), sp[np.minimum(pick, len(sp) - 1)],
                     rng.normal(size=(300, 40)).astype(sp.dtype))
        valid = rng.random((300, 40)) < 0.9
        valid[:, 3] = False
        check_k3(t(x, dtype), t(valid), 10, f"K3 special values {dtype}")
        # a stride-0 lead (the sector path's expand), a transposed panel
        x, valid = k3_case((3000, 60), dtype)
        check_k3(x.expand(5, 3000, 60), valid & t(rng.random((5, 3000, 60)) < 0.5),
                 10, f"K3 stride-0 lead {dtype}")
        check_k3(t(rng.normal(size=(60, 3000)), dtype).t(), valid, 10,
                 f"K3 transposed panel {dtype}")
        k3_calls += 6
        got = (kernels.rank_labels.launches, kernels.rank_labels.wide_rows)
        if got != (k3_calls, 0):
            raise AssertionError(f"K3 launches, wide rows {got}, expected "
                                 f"({k3_calls}, 0)")
        # a row wider than K3's plans takes the plain sort, counted by rows
        check_k3(*k3_case((8193, 3), dtype), 10, f"K3 8193 lanes {dtype}")
        got = (kernels.rank_labels.launches, kernels.rank_labels.wide_rows)
        if got != (k3_calls, 2 * 3):
            raise AssertionError(f"K3 past its widest plan: launches, wide rows "
                                 f"{got}, expected ({k3_calls}, 6)")
    try:
        kernels.cohort_partial_sums(*k2_case(1, 8, 16, 10, torch.float32), 10, 129)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 accepted max_hold > 128")
    a_over = kernels.MAX_ASSETS + 1  # more than 16-bit counts of 8 slices hold
    try:
        kernels.cohort_partial_sums(*k2_case(1, a_over, 1, 10, torch.float32), 10, 12)
    except ValueError:
        pass
    else:
        raise AssertionError(f"K2 accepted A = {a_over} assets")
    torch.cuda.synchronize()
    log("kernels", f"K1, K2 and K3 equal their plain versions, and repeat bit for "
                   f"bit, in {n_checks} f64/f32 shape cases (+ all-invalid, "
                   "labels outside [-1, B), misaligned storage, inf, H > 128 "
                   "and A > MAX_ASSETS refusals; K3's special values, stride-0 "
                   "lead, transposed panel and rows past its widest plan)")
    # K3 timed at the grid's ranking shape and the serve shape, L2 flushed;
    # plain: the sort path it replaces, transposes included; library: that
    # path's torch.sort and boundary gathers on rows made beforehand.
    # device_ms by CUDA events, with no profiler trace: each rep times the
    # flush and the call against the flush alone, in turns; the flush's
    # device time covers the wrapper's host work, so no idle gap enters
    # the difference
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def event_device_ms(fn):
        for _ in range(3):
            fn()
        both, alone = [], []
        for _ in range(REPS):
            for out, call in ((both, True), (alone, False)):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                flush.zero_()
                if call:
                    fn()
                end.record()
                torch.cuda.synchronize()
                out.append(start.elapsed_time(end))
        return statistics.median(both) - statistics.median(alone)

    k3_times = {}
    for dtype in (torch.float32, torch.float64):
        for label, shape in (("main", (4, 3000, 696)), ("serve", (128, 480))):
            x, valid = k3_case(shape, dtype)
            xr = x.transpose(-1, -2).reshape(-1, shape[-2]).contiguous()
            vr = valid.transpose(-1, -2).reshape(-1, shape[-2]).contiguous()
            nbytes = x.numel() * (x.element_size() + 1 + 4) + xr.shape[0] * 4
            b_ms, b_by = bound(nbytes, 0)
            kernels.reset_launches()
            device_ms = event_device_ms(lambda: kernels.rank_labels(x, valid, 10))
            per_call = kernels.rank_labels.launches / (3 + REPS)
            k3_times[f"{label} {str(dtype)[6:]}"] = {
                "shape": list(shape), "device_ms": device_ms,
                "launches_per_call": per_call,
                "ms": time_call(lambda: kernels.rank_labels(x, valid, 10),
                                cold=True)[0],
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / device_ms if device_ms > 0 else None,
                "bytes": nbytes,
                "plain_ms": time_call(lambda: kernels.rank_labels_plain(x, valid, 10),
                                      cold=True)[0],
                "library_ms": time_call(lambda: _rank_labels(xr, vr, 10),
                                        cold=True)[0],
            }
            if per_call != 1:
                raise AssertionError(f"K3 {label} {dtype}: {per_call} launches a call")
    del flush
    log("kernels", f"K3 rank_labels (medians of {REPS}, L2 flushed): "
                   f"{json.dumps(k3_times)} | {smi}")
    t_p = phase_done(3, "kernels", t_p)

    # -- 4. golden monthly, f64 --------------------------------------------
    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device=dev)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    if len(ends) != MONTHLY["n_months"]:
        raise AssertionError(f"golden: {len(ends)} months")
    kernels.reset_launches()
    res = monthly_spread_backtest(pm, mm, lookback=12, skip=1)
    k1_golden = kernels.decile_partial_sums.launches
    if k1_golden < 1:
        raise AssertionError("golden: K1 was not launched")
    sv = res.spread_valid.cpu().numpy()
    got = {
        "n_valid_spreads": int(sv.sum()),
        "mean_spread": float(res.mean_spread),
        "ann_sharpe": float(res.ann_sharpe),
        "nw_t": float(nw_t_stat(res.spread, res.spread_valid)),
        "cum_return": float(np.prod(1 + res.spread.cpu().numpy()[sv])),
    }
    if got["n_valid_spreads"] != MONTHLY["n_valid_spreads"]:
        raise AssertionError(f"golden: {got['n_valid_spreads']} valid spreads")
    for k in ("mean_spread", "ann_sharpe", "nw_t", "cum_return"):
        np.testing.assert_allclose(got[k], MONTHLY[k], rtol=1e-9, err_msg=k)
    # the host entry points on the same month-end panel
    golden_panel = Panel(values=pm.cpu().numpy(), mask=mm.cpu().numpy(),
                        tickers=daily.tickers, times=ends)
    rep = run_monthly(golden_panel, device="cuda")
    np.testing.assert_allclose(rep.mean_spread, MONTHLY["mean_spread"], rtol=1e-9)
    grep = run_grid(golden_panel, device="cuda", mode="rank")
    gplain = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="rank", impl="plain")
    if not np.array_equal(grep.spread_valid, gplain.spread_valid.cpu().numpy()):
        raise AssertionError("golden: run_grid validity differs from plain")
    np.testing.assert_allclose(grep.spreads, gplain.spreads.cpu().numpy(),
                               **F64_TOL, equal_nan=True)
    log("golden", f"f64 MONTHLY fingerprints reproduced ({got}); K1 launches "
                  f"{k1_golden}; run_monthly/run_grid on cuda agree")
    t_p = phase_done(4, "golden", t_p)

    # -- 5. north star, f32 -------------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    pm, mm, ends = north_star_month_panel(device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    panel_s = time.perf_counter() - t0
    mres = monthly_spread_backtest(pm, mm, lookback=12, skip=1, mode="qcut")
    grids = {mode: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP,
                                    mode=mode)
             for mode in ("rank", "qcut")}
    torch.cuda.synchronize()
    launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"north star: a kernel was not launched: {launches}")
    k3_north = (kernels.rank_labels.launches, kernels.rank_labels.wide_rows)
    if k3_north != (1, 0):
        raise AssertionError(f"north star: K3 launches, wide rows {k3_north}, "
                             "expected (1, 0): the one rank-mode grid call")
    A, M = pm.shape
    n_stocks, n_days = NORTH_STAR_GRID
    log("north", f"panel {A}x{M} month ends from {n_stocks}x{n_days} daily bars in "
                 f"{panel_s:.2f} s (host generation + device aggregation); "
                 f"main-path launches {launches}")

    # the kernel path against the plain path
    mplain = monthly_spread_backtest(pm, mm, lookback=12, skip=1, mode="qcut",
                                     impl="plain")
    if not torch.equal(mres.spread_valid, mplain.spread_valid) or \
            not torch.equal(mres.decile_counts, mplain.decile_counts):
        raise AssertionError("north star monthly: validity/counts differ")
    torch.testing.assert_close(mres.spread, mplain.spread, rtol=0,
                               atol=SPREAD_ATOL, equal_nan=True)
    summary = {"monthly_valid": int(mres.spread_valid.sum()),
               "monthly_mean_spread": float(mres.mean_spread)}
    for mode, g in grids.items():
        gp = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP,
                              mode=mode, impl="plain")
        if tuple(g.spreads.shape) != (4, 4, M):
            raise AssertionError(f"grid {mode}: shape {tuple(g.spreads.shape)}")
        if not torch.equal(g.spread_valid, gp.spread_valid):
            raise AssertionError(f"grid {mode}: validity differs from plain")
        live = g.spread_valid
        if not bool(torch.isfinite(g.spreads[live]).all()) or int(live.sum()) == 0:
            raise AssertionError(f"grid {mode}: non-finite or empty spreads")
        torch.testing.assert_close(g.spreads, gp.spreads, rtol=0,
                                   atol=SPREAD_ATOL, equal_nan=True)
        summary[f"grid_{mode}_live"] = int(live.sum())
        summary[f"grid_{mode}_mean_J12K3"] = float(g.mean_spread[3, 0])
    log("north", f"kernel path equals plain path (validity exact, spreads "
                 f"within {SPREAD_ATOL}): {summary}")

    # timing: CUDA events and host wall around each rep, median of REPS
    # after warm-up (the helper that csmom_tpu_torch.phases times with)
    e2e = {}
    for label, fn in [
        ("monthly_qcut_J12", lambda: monthly_spread_backtest(pm, mm, 12, 1, mode="qcut")),
        ("grid16_rank", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="rank")),
        ("grid16_qcut", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="qcut")),
        ("grid16_rank_plain", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                       mode="rank", impl="plain")),
    ]:
        d_ms, h_ms = time_call(fn)
        e2e[label] = {"device_ms": d_ms, "host_ms": h_ms}
    log("north", "end-to-end f32 medians of %d reps: %s" % (REPS, json.dumps(e2e)))
    t_p = phase_done(5, "north star", t_p)

    # -- 6. research paths (BASELINE configs 3 and 5) -------------------------
    # (a) the JAX package's pinned outputs on the golden panel, f64
    kernels.reset_launches()
    check_research(research_fingerprints(dev))
    torch.cuda.synchronize()
    golden_launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                       "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(golden_launches.values()) < 1:
        raise AssertionError(f"research golden: a kernel was not launched: "
                             f"{golden_launches}")
    log("research", f"golden RESEARCH fingerprints reproduced in f64 (sector-"
                    f"neutral spread and NW t, net of 10 bps, grid netting and "
                    f"break-evens, walk-forward choices, bootstrap CIs, threefry "
                    f"draws); launches {golden_launches}")

    # (b) north star, f32, through the entry points and the research layer;
    # launch counts read around this run
    n_sec = 11
    sid = np.random.default_rng(11).integers(-1, n_sec, size=A)   # -1: unclassified
    ns_panel = Panel(values=pm.cpu().numpy(), mask=mm.cpu().numpy(),
                     tickers=tuple(f"S{i}" for i in range(A)), times=ends)
    sid_t = t(sid)
    key0 = random.PRNGKey(0, device=dev)
    kernels.reset_launches()
    sec_rep = run_monthly(ns_panel, sector_ids=sid, n_sectors=n_sec, device="cuda")
    hist_rep = run_grid(ns_panel, mode="hist", device="cuda")
    g_hist = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP, mode="hist")
    unit = grid_net_of_costs(pm, mm, g_hist, half_spread=1.0)
    be, turn = grid_break_even_bps(pm, mm, g_hist, unit=unit)
    net = grid_net_of_costs(pm, mm, g_hist, half_spread=0.0005)
    wf = walk_forward_select(g_hist.spreads, g_hist.spread_valid)
    boot = block_bootstrap_grid(g_hist.spreads, g_hist.spread_valid, key0,
                                n_samples=200, block_len=6)
    torch.cuda.synchronize()
    research_launches = {
        "decile_partial_sums": kernels.decile_partial_sums.launches,
        "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(research_launches.values()) < 1:
        raise AssertionError(f"research paths: a kernel was not launched: "
                             f"{research_launches}")

    # hist labels are rank labels, and the hist grid is the rank grid
    jt = t(GRID_JS)
    mom_r, momv_r = momentum_dynamic(pm, mm, jt, GRID_SKIP)
    momv_r = momv_r & formation_listed_mask(mm, GRID_SKIP)
    mom_r = torch.where(momv_r, mom_r, torch.nan)
    lab_hist, n_hist = decile_assign_panel(mom_r, momv_r, n_bins=10, mode="hist")
    lab_rank, n_rank = decile_assign_panel(mom_r, momv_r, n_bins=10, mode="rank")
    if not (torch.equal(lab_hist, lab_rank) and torch.equal(n_hist, n_rank)):
        raise AssertionError("research: hist labels differ from rank labels")
    rank_rep = run_grid(ns_panel, mode="rank", device="cuda")
    np.testing.assert_array_equal(hist_rep.spread_valid, rank_rep.spread_valid)
    np.testing.assert_array_equal(hist_rep.spreads, rank_rep.spreads)
    if not (torch.equal(g_hist.spreads.nan_to_num(), grids["rank"].spreads.nan_to_num())
            and torch.equal(g_hist.spread_valid, grids["rank"].spread_valid)):
        raise AssertionError("research: the hist grid differs from the rank grid")

    # the cross-table cohort sums against K2 on the grid's own labels
    ret, ret_valid = monthly_returns(pm, mm)
    H = max(GRID_KS)
    ks_, kc_ = _cohort_partial_sums(lab_rank, ret, ret_valid, 10, H, impl="kernel")
    absum_c, _ = _cohort_partial_sums(lab_rank, torch.where(
        ret_valid, torch.nan_to_num(ret), 0.0).abs(), ret_valid, 10, H, impl="plain")
    mm_err = {}
    for impl in ("matmul", "matmul_bf16"):
        ms_, mc_ = _cohort_partial_sums(lab_rank, ret, ret_valid, 10, H, impl=impl)
        if mc_.dtype != torch.float32 or ms_.dtype != torch.float32:
            raise AssertionError(f"research {impl}: not float32 outputs")
        if not torch.equal(mc_, kc_):
            raise AssertionError(f"research {impl}: counts differ from K2's")
        if impl == "matmul":
            assert_sums(ms_, ks_, absum_c, torch.float32, "research matmul sums")
        else:
            # bf16 keeps 8 significant bits: each return moves by at most
            # 2**-8 of itself before the float32 sums
            lim = F32_ATOL + (2.0 ** -8 + F32_RTOL) * absum_c
            if not bool(((ms_ - ks_).abs() <= lim).all()):
                raise AssertionError("research matmul_bf16 sums over their bf16 limit")
        mm_err[impl] = (ms_ - ks_).abs().max().item()

    # the sector-neutral engine (K1) against its plain run
    sec = sector_neutral_backtest(pm, mm, sid_t, n_sec, lookback=12, skip=1)
    sec_plain = sector_neutral_backtest(pm, mm, sid_t, n_sec, lookback=12, skip=1,
                                        impl="plain")
    if not (torch.equal(sec.decile_counts, sec_plain.decile_counts)
            and torch.equal(sec.spread_valid, sec_plain.spread_valid)
            and torch.equal(sec.labels, sec_plain.labels)):
        raise AssertionError("research: sector-neutral counts/validity differ from plain")
    torch.testing.assert_close(sec.spread, sec_plain.spread, rtol=0,
                               atol=SPREAD_ATOL, equal_nan=True)
    np.testing.assert_array_equal(sec_rep.labels, sec.labels.cpu().numpy())
    if not bool((sec.labels[sid_t < 0] == -1).all()):
        raise AssertionError("research: an unclassified asset was ranked")

    # one unit-cost run re-prices the grid at any level; f32: the unit cost
    # (about 1 a month) carries ~1e-7 of rounding, scaled by hs <= 1
    torch.testing.assert_close(grid_net_from_unit(g_hist, unit, 0.0005).spreads,
                               net.spreads, rtol=0, atol=1e-6, equal_nan=True)
    live = g_hist.spread_valid
    if not bool(torch.isfinite(net.spreads[live]).all()) or \
            not bool((net.spreads[live] <= g_hist.spreads[live]).all()):
        raise AssertionError("research: net spreads not finite or above gross")
    if not bool((turn > 0).all()) or not bool(torch.isfinite(be).all()):
        raise AssertionError("research: turnover or break-even not positive/finite")
    if int((wf.choice >= 0).sum()) == 0 or int(wf.choice.max()) > 15:
        raise AssertionError("research: walk-forward chose nothing or out of range")
    ci = boot.mean_ci
    if tuple(ci.shape) != (2, 4, 4) or not bool(torch.isfinite(ci).all()) \
            or not bool((ci[0] <= ci[1]).all()):
        raise AssertionError("research: bootstrap CIs not finite and ordered")
    log("research", f"north star f32: hist == rank labels and grids; matmul / "
                    f"matmul_bf16 counts equal K2's (max |sum err| {mm_err}); "
                    f"sector-neutral ({n_sec} sectors) equals plain; net from "
                    f"unit equals direct netting; launches {research_launches}")
    log("research", json.dumps({
        "sector_mean_spread": float(sec.mean_spread),
        "sector_valid": int(sec.spread_valid.sum()),
        "grid_net_mean_J12K3_5bps": float(net.mean_spread[3, 0]),
        "break_even_bps": be.flatten().tolist(),
        "mean_turnover": turn.flatten().tolist(),
        "wf_oos_mean": float(wf.mean_spread),
        "wf_cells_chosen": sorted(set(wf.choice[wf.choice >= 0].tolist())),
        "ci_J12K3": ci[:, 3, 0].tolist()}))

    # each new path's CUDA-event median at the north star, f32
    for label, fn in [
        ("grid_net_of_costs", lambda: grid_net_of_costs(pm, mm, grids["rank"], 0.0005)),
        ("grid_net_of_costs_hist", lambda: grid_net_of_costs(pm, mm, g_hist, 0.0005)),
        ("grid_break_even_bps", lambda: grid_break_even_bps(pm, mm, grids["rank"])),
        ("block_bootstrap_grid_200", lambda: block_bootstrap_grid(
            g_hist.spreads, g_hist.spread_valid, key0, n_samples=200)),
        ("walk_forward_select", lambda: walk_forward_select(
            g_hist.spreads, g_hist.spread_valid)),
        ("sector_neutral_monthly_qcut_J12", lambda: sector_neutral_backtest(
            pm, mm, sid_t, n_sec, lookback=12, skip=1)),
        ("ranking_grid_hist", lambda: decile_assign_panel(mom_r, momv_r, 10, "hist")),
        ("ranking_grid_rank", lambda: decile_assign_panel(mom_r, momv_r, 10, "rank")),
        ("grid16_rank_kernel", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                        mode="rank")),
        ("grid16_rank_matmul", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                        mode="rank", impl="matmul")),
        ("grid16_rank_matmul_bf16", lambda: jk_grid_backtest(
            pm, mm, GRID_JS, GRID_KS, mode="rank", impl="matmul_bf16")),
    ]:
        d_ms, h_ms = time_call(fn)
        log("research", f"time {label}: {d_ms:.4f} ms CUDA events, host "
                        f"{h_ms:.4f} ms (median of {REPS}) | {smi}")
    t_p = phase_done(6, "research", t_p)

    with tempfile.TemporaryDirectory(prefix="csmom_smoke_") as tmp:
        # -- 7. data-in: CSV caches and packs -> month-end panels on the card
        pack_dir = os.path.join(tmp, "north_star")
        data_in_launches = data_in(dev, smi, pm, mm, ends, mres, grids, pack_dir)
        t_p = phase_done(7, "data-in", t_p)

        # -- 8. cli: the port's CLI on phase 7(b)'s pack -------------------
        cli_launches = cli_phase(dev, smi, pack_dir, os.path.join(tmp, "results"),
                                 mres, grids, assert_sums, bound)
        t_p = phase_done(8, "cli", t_p)

    # -- 10. kernels line at the main-path shapes, measured here, before
    # phase 9: after its traces of ~10^5 device activities, later traces
    # of the kernels have lost records three times in a row -------------
    ret, ret_valid = monthly_returns(pm, mm)
    # K1's inputs as the monthly engine forms them (backtest/monthly.py)
    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(ret_valid, -1, dims=1)
    next_valid[:, -1] = False
    next_valid &= mres.labels >= 0
    lab1 = torch.where(next_valid, mres.labels, -1)
    r1 = torch.where(lab1 >= 0, torch.nan_to_num(next_ret), 0.0)
    # K2's inputs as the grid engine forms them (backtest/grid.py), rank mode
    mom, mom_valid = momentum_dynamic(pm, mm, t(GRID_JS), GRID_SKIP)
    mom_valid = mom_valid & formation_listed_mask(mm, GRID_SKIP)
    lab2, _ = decile_assign_panel(torch.where(mom_valid, mom, torch.nan),
                                  mom_valid, n_bins=10, mode="rank")
    H, B = max(GRID_KS), 10

    s1, c1 = kernels.decile_partial_sums(r1, lab1, B)
    p1, pc1 = kernels.decile_partial_sums_plain(r1, lab1, B)
    s2, c2 = kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H)
    p2, pc2 = kernels.cohort_partial_sums_plain(ret, ret_valid, lab2, B, H)
    if not (torch.equal(c1, pc1) and torch.equal(c2, pc2)):
        raise AssertionError("main-path shape: counts differ")
    absum1, _ = kernels.decile_partial_sums_plain(r1.abs(), lab1, B)
    absum2, _ = kernels.cohort_partial_sums_plain(
        torch.where(ret_valid, torch.nan_to_num(ret), 0.0).abs(), ret_valid, lab2, B, H)
    assert_sums(s1, p1, absum1, r1.dtype, "main-path shape: K1 sums")
    assert_sums(s2, p2, absum2, ret.dtype, "main-path shape: K2 sums")

    # yardsticks: one library computation of the same function each
    onehot = (lab1.T[:, None, :] == torch.arange(B, device=dev)[None, :, None]
              ).to(torch.float32)                                # [M, B, A]
    rhs = torch.stack([r1.T, torch.ones_like(r1.T)], dim=-1)    # [M, A, 2]

    def k1_library():
        return torch.bmm(onehot, rhs)                            # [M, B, 2]

    lib1 = k1_library()
    torch.testing.assert_close(lib1[..., 0].T, p1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lib1[..., 1].T, pc1)

    rf = torch.where(ret_valid, torch.nan_to_num(ret), 0.0)
    vf = ret_valid.to(torch.float32)
    mem = torch.stack([lab2 == 0, lab2 == B - 1], dim=1).to(torch.float32)
    mem_t = mem.transpose(-1, -2).contiguous()                   # [nJ, 2, M, A]
    col = torch.arange(M, device=dev)[:, None] + torch.arange(1, H + 1, device=dev)[None, :]
    keep = col < M
    colc = col.clamp(0, M - 1).expand(*mem_t.shape[:2], M, H)

    def k2_library():  # the reference's impl='matmul': cross table + band gather
        fs = torch.matmul(mem_t, rf)                             # [nJ, 2, M, M]
        fc = torch.matmul(mem_t, vf)
        return (torch.where(keep, torch.gather(fs, 3, colc), 0.0),
                torch.where(keep, torch.gather(fc, 3, colc), 0.0))

    lib2 = k2_library()
    torch.testing.assert_close(lib2[0], p2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lib2[1], pc2)

    k1_bytes = lab1.nbytes + r1.nbytes + s1.nbytes + c1.nbytes
    k1_ops = 2 * int(((lab1 >= 0) & (lab1 < B)).sum())
    k2_bytes, k2_ops = k2_bound_inputs(lab2, ret, ret_valid, B, H)

    rows = []
    for name, wrapper, fn, plain, library, err, nbytes, ops, src, rep in [
        ("decile_partial_sums", kernels.decile_partial_sums,
         lambda: kernels.decile_partial_sums(r1, lab1, B),
         lambda: kernels.decile_partial_sums_plain(r1, lab1, B), k1_library,
         (s1 - p1).abs().max().item(), k1_bytes, k1_ops,
         "csmom_tpu_torch/csrc/decile_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:153"),
        ("cohort_partial_sums", kernels.cohort_partial_sums,
         lambda: kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H),
         lambda: kernels.cohort_partial_sums_plain(ret, ret_valid, lab2, B, H),
         k2_library, (s2 - p2).abs().max().item(), k2_bytes, k2_ops,
         "csmom_tpu_torch/csrc/cohort_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:66"),
    ]:
        b_ms, b_by = bound(nbytes, ops)
        # ms: the call (host work of the wrapper included); device_ms: the
        # kernels' own durations in a profiler trace of the same calls
        ms = time_call(fn, cold=True)[0]
        device_ms, per_call, by_kernel = time_kernels(fn, wrapper.device_kernels,
                                                      split=True)
        log("kernels", f"{name} device ms by kernel (medians): {by_kernel}")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "device_ms": device_ms, "kernels_per_call": per_call,
            "wrapper_ms": ms - device_ms,
            "plain_ms": time_call(plain, cold=True)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / device_ms,
            "library_ms": time_call(library, cold=True)[0],
            "bytes": nbytes, "ops": ops,
            "research_launches": research_launches[name],
            "data_in_launches": data_in_launches[name],
            "cli_launches": cli_launches[name],
        })
    if min(r["cli_launches"] for r in rows) < 1:
        raise AssertionError(f"cli: a kernel was not launched: {cli_launches}")
    per_call = {r["name"]: r["kernels_per_call"] for r in rows}
    for name, per in per_call.items():
        if per != 1:
            raise AssertionError(f"{name} launched {per} kernels per call, not 1")
    # every CUDA kernel of one wrapper call, named or not (a profiler
    # trace: before phase 9, like the timings above)
    dispatches = {}
    mom_r = torch.where(mom_valid, mom, torch.nan)
    for name, fn in (("decile_partial_sums", lambda: kernels.decile_partial_sums(r1, lab1, B)),
                     ("cohort_partial_sums",
                      lambda: kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H)),
                     ("rank_labels", lambda: kernels.rank_labels(mom_r, mom_valid, B))):
        with count_dispatches() as d:
            fn()
        dispatches[name] = d["dispatches"]
    if dispatches != {"decile_partial_sums": 1, "cohort_partial_sums": 1,
                      "rank_labels": 1}:
        raise AssertionError(f"count_dispatches: one wrapper call dispatched "
                             f"{dispatches} CUDA kernels, not 1 each")
    log("kernels", f"main-path shapes: K1 labels/ret {tuple(lab1.shape)} f32, "
                   f"K2 labels {tuple(lab2.shape)} H={H} f32; times are medians "
                   f"of {REPS} reps with L2 flushed before each; kernels per "
                   f"call {per_call}; count_dispatches of one call {dispatches}")
    for row, first in ((rows[0], K1_FIRST_VERSION_DEVICE_MS),
                       (rows[1], K2_FIRST_VERSION_DEVICE_MS)):
        log("kernels", f"{row['name']} device time {row['device_ms']:.6f} ms in "
                       f"this run; its first version's, recorded (not measured "
                       f"here): {first} ms on an NVIDIA H100 80GB HBM3 at 700 W "
                       f"(PERF.md, section 6)")
    t_p = phase_done(10, "kernels line", t_p)

    # -- 11. serve: the in-process serving tier, before phase 9 (whose long
    # traces leave later traces losing records) --------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="csmom_serve_") as tmp:
        serve = serve_phase(smi, tmp, assert_sums, bound)
    log("serve", f"phase wall {time.perf_counter() - t_phase:.1f} s; service-run "
                 f"launches {serve['launches']} | {smi}")
    t_p = phase_done(11, "serve", t_p)
    for row in rows:
        row["serve_launches"] = serve["launches"][row["name"]]
        k1 = row["name"] == "decile_partial_sums"
        for key in ("serve_shape", "serve_device_ms", "serve_bound_ms",
                    "serve_bound_by"):
            row[key] = serve[key] if k1 else None

    # -- 12. pool: the multi-process serving pool, after phase 11 and before
    # phase 9 ---------------------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="csmom_pool_") as tmp:
        pool = pool_phase(smi, args.out or tmp)
    log("pool", f"phase wall {time.perf_counter() - t_phase:.1f} s; the workers' "
                f"launches {pool['launches']} | {smi}")
    t_p = phase_done(12, "pool", t_p)
    for row in rows:
        row["pool_launches"] = pool["launches"][row["name"]]

    # -- 13. fabric: router replicas as processes, after phase 12 and before
    # phase 9 ---------------------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="csmom_fabric_") as tmp:
        fab = fabric_phase(smi, args.out or tmp, pool["ceiling_rate"])
    log("fabric", f"phase wall {time.perf_counter() - t_phase:.1f} s; the workers' "
                  f"launches in the serving windows {fab['launches']}, "
                  f"{fab['backtest_batches']} backtest batches | {smi}")
    t_p = phase_done(13, "fabric", t_p)
    for row in rows:
        row["fabric_launches"] = fab["launches"][row["name"]]

    # -- 14. fleet: the observatory and the elastic tier, after phase 13 and
    # before phase 9 ---------------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="csmom_fleet_") as tmp:
        fleet = fleet_phase(smi, args.out or tmp, pool["ceiling_rate"])
    log("fleet", f"phase wall {time.perf_counter() - t_phase:.1f} s; the launches "
                 f"of its {fleet['processes']} worker processes {fleet['launches']}; "
                 f"walls {json.dumps(fleet['walls'])}; r20 armed "
                 f"{json.dumps(fleet['r20'])}; r21 {json.dumps(fleet['r21'])}; "
                 f"autoscale {json.dumps(fleet['autoscale'])} | {smi}")
    t_p = phase_done(14, "fleet", t_p)
    for row in rows:
        row["fleet_launches"] = fleet["launches"][row["name"]]

    # -- 15. trace and replay, after phase 14 and before phase 9 -------------
    with tempfile.TemporaryDirectory(prefix="csmom_trace_") as tmp:
        tr = trace_replay_phase(smi, args.out or tmp,
                                {"inproc": serve["latency_ms"]["bursty"],
                                 "fabric": fab["r20"]})
    log("trace", f"phase wall {tr['wall_s']:.1f} s; traced runs' launches "
                 f"{tr['launches']}, replay windows' {tr['replay_launches']}; "
                 f"cells {json.dumps({k: v for k, v in tr.items() if k not in ('launches', 'replay_launches', 'wall_s')})} "
                 f"| {smi}")
    t_p = phase_done(15, "trace and replay", t_p)
    for row in rows:
        row["trace_launches"] = tr["launches"][row["name"]]
        row["replay_launches"] = tr["replay_launches"][row["name"]]

    # -- 18. the mesh serving engine, after phase 15 and before phase 9 ------
    # its GPU_SERVE_MESH_r15.json lands under chiprun_out/ unless --out says
    smesh = serve_mesh_phase(smi, args.out or os.path.join(REPO, "chiprun_out"),
                             assert_sums, serve)
    log("serve-mesh", f"phase wall {smesh['wall_s']:.1f} s; the mesh cell's "
                      f"launches {smesh['launches']} | {smi}")
    t_p = phase_done(18, "serve mesh", t_p)
    for row in rows:
        row["serve_mesh_launches"] = smesh["launches"][row["name"]]

    # -- 9. intraday: the intraday leg and its CLI -------------------------
    t_phase = time.perf_counter()
    intraday_launches = intraday_phase(dev, smi, bw)
    log("intraday", f"phase wall {time.perf_counter() - t_phase:.1f} s; launches "
                    f"{intraday_launches} | {smi}")
    t_p = phase_done(9, "intraday", t_p)
    if intraday_launches != {"decile_partial_sums": 1, "cohort_partial_sums": 0}:
        raise AssertionError(f"intraday: launches {intraday_launches}, expected K1 1 "
                             f"(run's replicate) and K2 0")
    for row in rows:
        row["intraday_launches"] = intraday_launches[row["name"]]

    # -- 16. the warm-start and the examples ----------------------------------
    warm = warmup_phase(smi, assert_sums)
    log("warm", f"phase wall {warm['wall_s']:.1f} s; warm-up launches "
                f"{warm['warmup_launches']}, examples' {warm['examples_launches']}; "
                f"{json.dumps({k: warm[k] for k in ('warmup_cold_s', 'warmup_warm_s', 'warmup_max_peak_bytes', 'example_north_star_grid_ms')})} | {smi}")
    log("warm", f"per entry (ms, bytes): {json.dumps(warm['warmup_entries'])}")
    t_p = phase_done(16, "warm-start and examples", t_p)
    for row in rows:
        row["warmup_launches"] = warm["warmup_launches"][row["name"]]
        row["examples_launches"] = warm["examples_launches"][row["name"]]

    # -- 17. the multi-GPU compute layer, logical shards of the card ----------
    mesh = mesh_phase(smi, pm, mm, mres, grids)
    log("mesh", f"phase wall {mesh['wall_s']:.1f} s; launches {mesh['launches']} | "
                f"{smi}")
    t_p = phase_done(17, "mesh", t_p)
    for row in rows:
        row["mesh_launches"] = mesh["launches"][row["name"]]

    # -- 19. the lint sweep and meshes over two processes ---------------------
    multi = lint_multihost_phase(smi, pm, mm, mesh["ref8"])
    log("multihost", f"phase wall {multi['wall_s']:.1f} s; walls "
                     f"{json.dumps(multi['walls'])}; launches {multi['launches']} | "
                     f"{smi}")
    t_p = phase_done(19, "lint and multihost", t_p)
    for row in rows:
        row["multihost_launches"] = multi["launches"][row["name"]]

    # -- 20. rehearse and timeline: the heal, the stub tiers, the sidecar ------
    rh = rehearse_phase(smi)
    log("rehearse", f"phase wall {rh['wall_s']:.1f} s; pass 2's launches "
                    f"{rh['launches']} | {smi}")
    t_p = phase_done(20, "rehearse and timeline", t_p)
    for row in rows:
        row["rehearse_launches"] = rh["launches"][row["name"]]

    # -- 21. the perf ledger on the card ---------------------------------------
    lg = ledger_phase(smi)
    log("ledger", f"phase wall {lg['wall_s']:.1f} s; the two service runs' "
                  f"launches {lg['launches']} | {smi}")
    t_p = phase_done(21, "ledger", t_p)
    for row in rows:
        row["ledger_launches"] = lg["launches"][row["name"]]

    # -- 22. bench and the capture tier on the card -----------------------------
    bn = bench_phase(smi)
    log("bench", f"phase wall {bn['wall_s']:.1f} s; the bench child's launches "
                 f"{bn['launches']} | {smi}")
    t_p = phase_done(22, "bench and capture tier", t_p)
    for row in rows:
        row["bench_launches"] = bn["launches"][row["name"]]

    # -- 23. buffer donation on the card ------------------------------------------
    dn = donation_phase(smi, pm, mm)
    t_p = phase_done(23, "donation", t_p)
    for row in rows:
        row["donation_launches"] = dn["launches"][row["name"]]
    log("smoke", f"phase walls s {json.dumps(PHASE_WALLS)}; whole "
                 f"{time.perf_counter() - t_smoke:.1f} s | {smi}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"k3": k3_times}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
