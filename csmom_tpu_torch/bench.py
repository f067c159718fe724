"""Headline benchmark (supervisor + children): ``python -m csmom_tpu_torch.bench``.

Counterpart of the reference's root ``bench.py``; ``python -m
csmom_tpu_torch.cli bench [--device {cuda,cpu}]`` runs it.

Primary metric: event-backtest throughput on the golden event workload,
the 20-ticker x ~2,728-minute panel that takes the reference's Python
event loop 18.4 s (~148 bar-groups/s, measured; BASELINE.md) on one CPU
core.  The port builds the synthesized same-shape stand-in
(:func:`csmom_tpu_torch.workloads.golden_event_inputs`), so its golden
trade count is the stand-in's.

Also reported (in "extra"): the north-star J x K grid, all 16
Jegadeesh-Titman cells on a 3000-stock x 60-year monthly panel in one
call, at ``impl`` ``plain``, ``matmul``, ``kernel`` (the K2 CUDA kernel)
and ``matmul_bf16``, plus a bytes/operations model of the grid so "fast"
is quantified, the full-size legs, the grid through the (grid, asset)
sharded engine, and the histogram-rank comparison.

The supervisor

  1. probes the device the caller asked for (``cuda`` by default,
     ``cpu`` with ``--device cpu`` or ``CSMOM_BENCH_FORCE_CPU=1``) in a
     subprocess with a hard timeout,
  2. on a card whose kernel libraries are not all built, runs the
     warm-up child (profiles ``bench-gpu`` and ``golden``) so the
     measuring child loads them instead of building,
  3. runs the real benchmark in a child on that device, retrying a child
     that dies or prints no line on the SAME device while the budget
     allows (each lost attempt recorded in ``attempt_errors``),
  4. ALWAYS prints exactly one JSON line on stdout, every probe (UTC
     timestamp + exact error) recorded in extra:
     {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
     When the probe fails nothing is measured on another device: the
     line is the last-resort record (``value`` 0.0, ``extra.error``) and
     the process exits 1.

No metric in extra is ever a bare null: anything unmeasured carries a
reason string ("skipped: ..." / "not applicable: ...") instead.

Record size discipline: the reader of the headline keeps a 2,000-char
tail of stdout (``chaos.invariants.DRIVER_TAIL_CHARS``), and a full
record outgrows it.  So the supervisor splits its output: the FULL
record (probes, errors, every grid leg, the histrank comparison) is
written to ``GPU_BENCH_FULL_${CSMOM_ROUND}.json`` in
``CSMOM_BENCH_FULL_DIR`` (default: the working directory), beside its
``GPU_TELEMETRY_${CSMOM_ROUND}.json`` sidecar, and stdout's single line
is a compact HEADLINE built by :func:`_headline`: metric/value/unit/
vs_baseline plus a fixed, size-bounded extra that points at the full
record, hard-capped at ``HEADLINE_MAX_CHARS`` and degraded by dropping
extra detail, never the four required fields.

The environment picks the role: ``CSMOM_BENCH_CHILD`` (the measuring
child), ``CSMOM_BENCH_HISTRANK`` (the histogram-rank comparison),
``CSMOM_BENCH_WARMUP`` (the warm-up child), none (the supervisor).
``CSMOM_BENCH_SMOKE=1`` runs the pipeline's shape with every optional
heavyweight leg skipped with a reason (what ``rehearse`` drives);
``CSMOM_BENCH_BUDGET`` caps the whole run (seconds).  The supervisor
imports no torch.
"""

import json
import os
import subprocess
import sys
import time

BASELINE_GROUPS_PER_SEC = 148.3  # measured: 18.4 s / 2,728 datetime groups
                                 # of the reference's Python loop (BASELINE.md)
GOLDEN_TRADES = 50_801           # the golden stand-in's trade count in f64
                                 # (the JAX package's golden_event_inputs on
                                 # the same synthesized panel)
GOLDEN_TRADE_TOL = 4             # f32 tolerance: a few threshold crossings
                                 # sit within one f32 ulp of 1e-5
NORTH_STAR_TARGET_S = 10.0       # the reference's north-star target field
                                 # (BASELINE.json: 16-cell grid, 3000 x 60 yr)

# One total wall-clock budget, spent top-down: probe, warm-up child,
# measuring child (retried on the same device), then the reporting
# reserve (histrank child, reports, landing).  A cap, not a target.
TOTAL_BUDGET_S = int(os.environ.get("CSMOM_BENCH_BUDGET", "900"))
PROBE_TIMEOUT_S = int(os.environ.get("CSMOM_BENCH_PROBE_TIMEOUT", "60"))
CHILD_MIN_S = 120        # floor for a useful measuring child: its own
                         # budget gates its optional legs, so this buys the
                         # event headline and the north-star grid
REPORT_RESERVE_S = 60    # kept after the measuring child for the rest
WARMUP_TIMEOUT_S = 300   # the warm-up child's cap (a warm one takes ~15 s)
MAX_CHILD_ATTEMPTS = 3   # a child that dies at once cannot burn the budget
MESH_LOGICAL_SHARDS = 8  # the mesh leg's shards on a single device
_DEADLINE = time.monotonic() + TOTAL_BUDGET_S
_CHILD_T0 = time.monotonic()  # child-process start, for its own sub-budget

SMOKE = bool(os.environ.get("CSMOM_BENCH_SMOKE"))
SMOKE_REASON = "skipped: smoke mode (CSMOM_BENCH_SMOKE=1 — rehearsal runs " \
               "the pipeline, not the workload)"

# the checkout this package lives in: where committed captures are read
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chaos(point: str, **ctx):
    """Chaos checkpoint: a no-op (one environ lookup, no imports) unless
    a fault plan or telemetry is armed, so a disarmed supervisor stays
    package-import-free.  Armed telemetry routes through the real
    checkpoint so every chaos site doubles as a timeline event."""
    env = os.environ
    if "CSMOM_FAULT_PLAN" not in env and env.get("CSMOM_TELEMETRY",
                                                 "0") in ("", "0"):
        return None
    from csmom_tpu_torch.chaos.inject import checkpoint

    return checkpoint(point, **ctx)


_ROLES = ("CSMOM_BENCH_CHILD", "CSMOM_BENCH_HISTRANK", "CSMOM_BENCH_WARMUP")


def _child_env(role: str | None = None, device: str = "cuda") -> dict:
    """This process's environment for a subprocess, with the checkout on
    ``PYTHONPATH`` (``-m csmom_tpu_torch.bench`` from any directory), the
    child's ``role`` variable set and the others cleared, and
    ``CSMOM_BENCH_FORCE_CPU`` set exactly when ``device`` is the CPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in _ROLES and k != "CSMOM_BENCH_FORCE_CPU"}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    if role is not None:
        env[role] = "1"
    if device == "cpu":
        env["CSMOM_BENCH_FORCE_CPU"] = "1"
    return env


def _module_argv() -> list:
    return [sys.executable, "-m", "csmom_tpu_torch.bench"]


# -- run telemetry (csmom_tpu_torch.obs) -------------------------------------
#
# Default ON: the GPU_TELEMETRY_<round>.json sidecar is part of a round's
# evidence like the FULL record: phases (warmup/probe/compile/row/land),
# span walls and the metrics snapshot, readable with `timeline <round>`.
# CSMOM_TELEMETRY=0 disarms the whole layer (the supervisor then never
# imports the package).  The event stream is a scratch JSONL in the
# temporary directory that supervisor and children (env inheritance)
# append to; the landed artifact is the assembled sidecar.

# (obs module, root span, owned scratch-stream path or None) once armed
_TEL = None


def _tel_start():
    """Arm supervisor telemetry (unless CSMOM_TELEMETRY=0) and open the
    run's root span.  The arming decision is the shared
    obs.spans.arm_policy: an operator-provided env contract is honored;
    only a blank env gets the default scratch stream (which _tel_finish
    deletes once the sidecar has landed)."""
    global _TEL
    if os.environ.get("CSMOM_TELEMETRY", "") == "0":
        return  # before the package import: a disarmed supervisor stays light
    import tempfile

    from csmom_tpu_torch import obs

    default = os.path.join(
        tempfile.gettempdir(),
        f"csmom_torch_telemetry_{ROUND}_{os.getpid()}.jsonl",
    )
    col = (obs.spans.current_collector() if obs.armed() else
           obs.arm_policy("bench-supervisor", default_path=default,
                          run_id=ROUND))
    if col is None:
        return
    root = obs.span("bench.supervisor", root=True)
    root.__enter__()
    _TEL = (obs, root, default if col.path == default else None)


def _tel_span(name: str, **attrs):
    """A supervisor-side span; a no-op context manager when disarmed."""
    if _TEL is None:
        import contextlib

        return contextlib.nullcontext()
    return _TEL[0].span(name, **attrs)


def _tel_finish(out_dir: str):
    """Close the root span and land the telemetry sidecar (the shared
    obs.timeline finish sequence).  Returns the sidecar name or a reason
    string: a telemetry failure never costs the headline."""
    global _TEL
    if _TEL is None:
        return "not captured: telemetry disarmed (CSMOM_TELEMETRY=0)"
    obs, root, owned_stream = _TEL
    _TEL = None
    # the landing step runs with the collector closed, so its breadcrumb
    # goes in now: "reached the land step" is readable off the timeline
    # even when the record write itself dies (the bench.land faults)
    obs.point("bench.land", record=FULL_RECORD_NAME)
    root.__exit__(None, None, None)
    from csmom_tpu_torch.obs import metrics as obs_metrics
    from csmom_tpu_torch.obs import timeline as obs_tl

    try:
        fallback = obs_metrics.snapshot()
    except Exception:
        fallback = None
    # our own default arming (owned scratch stream, run id = ROUND) may
    # overwrite the round's sidecar across reruns; an operator-armed run
    # carries a foreign run id and must not clobber its evidence
    name = obs_tl.finish_and_write(out_dir, fallback_metrics=fallback,
                                   overwrite=owned_stream is not None)
    if owned_stream and name.startswith("GPU_TELEMETRY_"):
        try:
            os.remove(owned_stream)
        except OSError:
            pass
    return name


def _remaining() -> float:
    return max(30.0, _DEADLINE - time.monotonic())


# ---------------------------------------------------------------- child ----
#
# The child's inputs (golden event panels, packed grid panels) and its
# entry callables come from csmom_tpu_torch.compile.{workloads,entries}
# through the engine registry, shared with `warmup`, so the warm-up runs
# exactly what a bench child runs.


def child_main():
    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.event import event_backtest
    from csmom_tpu_torch.compile import workloads as wl
    from csmom_tpu_torch.registry import entry_factory
    from csmom_tpu_torch.utils.profiling import compile_stats

    grid_scalar_fn = entry_factory("grid.jk")
    batched_event_fn = entry_factory("event.panel")

    # telemetry: join the supervisor's event stream (env contract), or
    # stay disarmed, in which case every span below is the shared no-op
    from csmom_tpu_torch import obs
    from csmom_tpu_torch.obs import metrics as obs_metrics

    obs.arm_from_env("bench-child")
    # registered before any leg runs: a record showing rows_landed=0 must
    # mean "no leg completed", never "counting not wired"
    obs_metrics.counter("bench.rows_landed")
    _root_sp = obs.span("bench.child", root=True)
    _root_sp.__enter__()

    dev, on_cpu, dtype = wl.bench_device(
        "cpu" if os.environ.get("CSMOM_BENCH_FORCE_CPU") else "cuda")
    platform = "cpu" if on_cpu else "gpu"
    device_kind = "cpu" if on_cpu else torch.cuda.get_device_name(dev)
    np_dtype = np.float64 if on_cpu else np.float32
    _stats0 = compile_stats()  # child-lifetime base for the compile totals

    # per-leg compile accounting: the first call of every leg runs through
    # here, so the FULL record carries each shape's first-call wall and
    # the kernel libraries it built or loaded (eager torch compiles
    # nothing per shape; the libraries are what a warm-up leaves behind)
    _LEGS: dict = {}

    def _compiled_leg(name: str, first_call):
        _chaos("bench.compile", leg=name)
        b = compile_stats()
        t0 = time.perf_counter()
        with obs.span("bench.compile", leg=name):
            first_call()
        d = compile_stats().delta(b)
        _LEGS[name] = {
            "compile_wall_s": round(time.perf_counter() - t0, 4),
            "served_from_cache": d.libraries_built_or_loaded - d.libraries_built,
            "fresh_compiles": d.libraries_built,
        }

    # child sub-budget: every optional leg yields to it (with a recorded
    # reason) rather than running the child past its limit.  Priority:
    # event headline -> north-star rank grid -> everything else
    _child_budget = float(os.environ.get("CSMOM_BENCH_CHILD_BUDGET", "0") or 0)

    def _child_left() -> float:
        if not _child_budget:
            return float("inf")
        return _child_budget - (time.monotonic() - _CHILD_T0)

    def _r4(x):
        """A measured wall rounds; a skip/fail reason string passes through."""
        return round(x, 4) if isinstance(x, float) else x

    # Deadline guard: _PROG is filled as legs complete; at the deadline
    # the guard dumps whatever is measured as an explicitly-partial record
    # so the supervisor still gets a parseable line.  Anchored to
    # _CHILD_T0 (process start): torch's import and the card's context
    # count against the budget.
    from csmom_tpu_torch.utils.deadline import deadline_guard

    _PROG: dict = {}

    def _partial_line():
        if "value" not in _PROG:
            return None  # headline not yet measured: nothing worth a line
        ex = dict(_PROG.get("extra", {}))
        ex["partial"] = (
            "child deadline hit before every leg completed; unmeasured "
            "legs are absent (watchdog dump, not a full record)"
        )
        return json.dumps({
            "metric": "intraday_event_backtest_bar_groups_per_sec",
            "value": _PROG["value"],
            "unit": "bar_groups/s",
            "vs_baseline": _PROG["vs_baseline"],
            "extra": ex,
        })

    _finish = deadline_guard(
        "CSMOM_BENCH_CHILD_BUDGET", _partial_line, t0=_CHILD_T0
    )

    # timing discipline: every timed rep fetches a scalar result to the
    # host (utils.profiling.fetch synchronizes first); the scalar round
    # trip is the floor such walls cannot go under, and is reported
    from csmom_tpu_torch.utils.profiling import fetch, measure_rtt

    rtt_s = measure_rtt(dtype, device=dev)

    # -- golden event workload (the headline metric) ------------------------
    price, valid, score, adv, vol, n_trades = wl.golden_event_inputs(
        dtype, device=dev)
    n_bars = int(valid.any(dim=0).sum())

    # raw repeat samples (perf-ledger contract): every timed leg records
    # its per-rep walls, not only the mean, keyed by the same extra field
    # name as the leg's aggregate; the ledger bootstraps a CI from them
    _SAMPLES: dict = {}

    def _timed_reps(n: int, one_rep):
        """``(mean_wall, per_rep_walls)`` of n reps, each timed alone."""
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            one_rep()
            walls.append(time.perf_counter() - t0)
        return sum(walls) / n, [round(w, 6) for w in walls]

    run = lambda: fetch(event_backtest(price, valid, score, adv, vol).total_pnl)
    _compiled_leg("event.golden", run)
    reps = 20
    with obs.span("bench.row", row="event.golden", reps=reps):
        dt, _SAMPLES["event_backtest_wall_s"] = _timed_reps(reps, run)
    obs_metrics.counter("bench.rows_landed").inc()
    groups_per_sec = n_bars / dt
    _PROG.update({
        "value": round(groups_per_sec, 1),
        "vs_baseline": round(groups_per_sec / BASELINE_GROUPS_PER_SEC, 1),
        "extra": {
            "platform": platform,
            "device_kind": device_kind,
            "workload": f"golden 20x{n_bars} minute panel, "
                        f"{n_trades} trades ({np.dtype(np_dtype).name})",
            "tiny_op_rtt_s": round(rtt_s, 6),
            "event_backtest_wall_s": round(dt, 6),
            "golden_trades": n_trades,
            "golden_trades_ref": GOLDEN_TRADES,
            "golden_ok": abs(n_trades - GOLDEN_TRADES) <= GOLDEN_TRADE_TOL,
        },
    })
    # live references: legs recorded after this point (and the final
    # compile totals) show up in a watchdog partial dump too
    _PROG["extra"]["compile_legs"] = _LEGS
    _PROG["extra"]["samples"] = _SAMPLES
    _PROG["extra"]["samples_note"] = (
        "per-rep raw walls (s) keyed by the matching aggregate field — "
        "the ledger's bootstrap-CI regression input (obs.regress)"
    )
    # measured-row boundary: the headline is in _PROG, the grid legs are
    # not; a hang, an expired deadline or a kill between rows fires here,
    # and the headline above must still land in a partial record
    _chaos("bench.row", row="headline")
    _stall = float(os.environ.get("CSMOM_BENCH_STALL_S", "0") or 0)
    if _stall:  # test hook: a device that hangs right after the headline;
        time.sleep(_stall)  # the watchdog must turn this into a partial dump

    # -- north-star grid: 16 cells; full 3000 x 60 yr on the card, reduced
    #    (recorded) on the CPU --------------------------------------------
    if on_cpu:
        (A, T), grid_reps = wl.REDUCED_GRID, 5
    else:
        (A, T), grid_reps = wl.NORTH_STAR_GRID, 5
    # the panel comes from the packed binary cache through the same code
    # `warmup` runs; pack_ingest_s is the measured disk -> host wall
    pm, mm, M, pack_ingest_s = wl.grid_month_inputs(A, T, dtype, device=dev)
    Js = np.asarray(wl.GRID_JS)
    Ks = np.asarray(wl.GRID_KS)

    def timed(mode, impl="plain", sample_key=None):
        """One timed grid leg; ``sample_key`` is the extra field its
        aggregate lands in, so the per-rep samples are recorded under
        the same name at the same call site."""
        gfn = grid_scalar_fn(wl.GRID_JS, wl.GRID_KS, wl.GRID_SKIP, mode, impl)
        _compiled_leg(f"grid16.{mode}.{impl}@{A}x{M}",
                      lambda: fetch(gfn(pm, mm)))
        with obs.span("bench.row", row=f"grid16.{mode}.{impl}",
                      reps=grid_reps):
            dt, walls = _timed_reps(grid_reps, lambda: fetch(gfn(pm, mm)))
        if sample_key is not None:
            _SAMPLES[sample_key] = walls
        obs_metrics.counter("bench.rows_landed").inc()
        return dt

    def timed_or_reason(mode, impl="plain", floor_s=120.0, sample_key=None):
        """Run a grid leg if the child budget allows, else a reason string."""
        if SMOKE:
            return SMOKE_REASON
        left = _child_left()
        if left < floor_s:
            return (f"skipped: child budget too small for this leg "
                    f"({int(left)}s left < {int(floor_s)}s floor)")
        try:
            return timed(mode, impl, sample_key=sample_key)
        except Exception as e:
            return f"failed: {type(e).__name__}: {e}"[:200]

    # the north-star number itself is never budget-gated: it is the reason
    # the child exists
    grid_rank_s = timed("rank", sample_key="grid16_rank_s")
    _chaos("bench.row", row="grid16.rank")
    _PROG["extra"].update({
        "grid16_rank_s": round(grid_rank_s, 4),
        "grid_workload": f"16 cells, {A} stocks x {T} days ({M} months)",
        "grid_is_north_star_size": (A, T) == wl.NORTH_STAR_GRID,
        "north_star_met": bool(
            (A, T) == wl.NORTH_STAR_GRID and grid_rank_s < NORTH_STAR_TARGET_S
        ),
        "pack_ingest_s": round(pack_ingest_s, 4),
    })
    grid_qcut_s = timed_or_reason("qcut", sample_key="grid16_qcut_s")
    _PROG["extra"]["grid16_qcut_s"] = _r4(grid_qcut_s)
    # matmul-form cohort aggregation (membership^T @ returns cross table)
    grid_matmul_s = timed_or_reason("rank", "matmul",
                                    sample_key="grid16_rank_matmul_s")
    _PROG["extra"]["grid16_rank_matmul_s"] = _r4(grid_matmul_s)
    # the K2 kernel leg (the reference's pallas key): the kernel launches
    # only on a card; its plain version on the CPU is the tests' harness
    grid_pallas_s = (
        "skipped: cpu platform (the K2 kernel launches only on a card; "
        "its plain version on the CPU is a correctness harness, not a "
        "timed leg)"
        if on_cpu else timed_or_reason(
            "rank", "kernel", sample_key="grid16_rank_pallas_s")
    )
    # bf16-operand matmul form: reduced-precision throughput mode, only
    # meaningful on the card
    grid_bf16_s = (
        "skipped: cpu platform (bf16 matmul operands are a card fast path)"
        if on_cpu else timed_or_reason(
            "rank", "matmul_bf16",
            sample_key="grid16_rank_matmul_bf16_s")
    )
    _PROG["extra"]["grid16_rank_pallas_s"] = _r4(grid_pallas_s)
    _PROG["extra"]["grid16_rank_matmul_bf16_s"] = _r4(grid_bf16_s)

    # On the card a single event run is launch- and fetch-bound; a batch of
    # B independent backtests amortizes the fetch over B runs: the number
    # for parameter sweeps and bootstrap batches, labeled as such.  Runs
    # after the north-star grid: it is optional and must not burn budget
    # the grid needs.
    batched_per_run_s = None
    batched_skip_reason = (
        "skipped: cpu platform (the batched leg amortizes the card's "
        "launch and fetch overhead; on the CPU the single-run wall "
        "already measures compute)"
    )
    if not on_cpu and SMOKE:
        batched_skip_reason = SMOKE_REASON
    elif not on_cpu and _child_left() < 150:
        batched_skip_reason = (
            "skipped: child budget too small after the grid legs "
            f"({int(_child_left())}s left < 150s floor)"
        )
    elif not on_cpu:
        B = 32
        # perturb scores per batch lane so no degenerate dedup is possible
        bscore = score[None] * (
            1.0 + 1e-4 * torch.arange(B, dtype=score.dtype,
                                      device=dev)[:, None, None]
        )
        bat = batched_event_fn(B)
        try:
            _compiled_leg(f"event.batched{B}",
                          lambda: fetch(bat(price, valid, bscore, adv, vol)))
            with obs.span("bench.row", row=f"event.batched{B}"):
                breps = 5
                dt_b, bwalls = _timed_reps(
                    breps, lambda: fetch(bat(price, valid, bscore, adv, vol))
                )
                batched_per_run_s = dt_b / B
            _SAMPLES["event_batched_per_run_s"] = [
                round(w / B, 8) for w in bwalls
            ]
            obs_metrics.counter("bench.rows_landed").inc()
        except Exception as e:  # record the why, keep the headline metric
            batched_skip_reason = (
                f"failed: {type(e).__name__}: {e}"[:200]
            )
    if batched_per_run_s is not None:
        _PROG["extra"]["event_batched_per_run_s"] = round(batched_per_run_s, 6)

    # the full-size legs: one rep each of the north-star grid at impl
    # plain and matmul, proving the full-size run and its memory.  On the
    # CPU the main grid above is reduced, so these load the full panel; on
    # the card the main grid is already full size and they run on its panel
    A_f, T_f = wl.NORTH_STAR_GRID
    full_rank_s = full_matmul_s = None
    fpm = fmm = None
    full_floor_s = 360.0 if on_cpu else 60.0
    child_left = _child_left()  # inf when unbudgeted (standalone child runs)
    if SMOKE:
        full_rank_s = full_matmul_s = SMOKE_REASON
    elif child_left > full_floor_s:
        try:
            if (A, T) == (A_f, T_f):
                fpm, fmm, M_f = pm, mm, M
            else:
                fpm, fmm, M_f, _ = wl.grid_month_inputs(A_f, T_f, dtype,
                                                        device=dev)

            def gf(impl="plain"):
                gfn = grid_scalar_fn(
                    wl.GRID_JS, wl.GRID_KS, wl.GRID_SKIP, "rank", impl
                )
                fetch(gfn(fpm, fmm))

            def full_leg(impl):
                name = f"grid16.rank.{impl}@{A_f}x{M_f}"
                if name in _LEGS:  # the main grid's leg at the same shape
                    name += ".full"
                _compiled_leg(name, lambda: gf(impl))

            full_leg("plain")
            with obs.span("bench.row", row="grid16.full.plain"):
                # one rep by design (the leg proves the full-size run, it
                # does not distribute): a single raw sample, so the ledger
                # reports point deltas, never a CI
                full_rank_s, _SAMPLES["grid16_rank_full_s"] = \
                    _timed_reps(1, gf)
            obs_metrics.counter("bench.rows_landed").inc()
        except Exception as e:  # record, never lose the JSON line
            full_rank_s = f"failed: {type(e).__name__}: {e}"[:200]
        # the matmul leg doubles the full-size work: re-check the budget and
        # fail independently so a matmul problem cannot discard the plain
        # number
        child_left = _child_left()
        if isinstance(full_rank_s, float) and child_left > 3 * full_rank_s + 90:
            try:
                full_leg("matmul")
                with obs.span("bench.row", row="grid16.full.matmul"):
                    full_matmul_s, _SAMPLES["grid16_rank_matmul_full_s"] = \
                        _timed_reps(1, lambda: gf("matmul"))
                obs_metrics.counter("bench.rows_landed").inc()
            except Exception as e:
                full_matmul_s = f"failed: {type(e).__name__}: {e}"[:200]
        else:
            full_matmul_s = (
                "skipped: child budget too small to double the full-size "
                "work after the plain leg" if isinstance(full_rank_s, float)
                else "skipped: plain full-size leg did not produce a wall "
                     "to budget against"
            )
    else:
        full_rank_s = full_matmul_s = (
            f"skipped: child budget exhausted ({int(child_left)}s left < "
            f"{int(full_floor_s)}s floor for the full-size run)"
        )

    # -- mesh leg: the full-size grid through the (grid, asset) sharded
    # engine on the visible cards, or logical shards of the one device
    # (a mesh's devices may repeat).  Its workload key carries the layout
    # and device count, so the ledger never pairs a d1 wall with a d8 one
    full_sharded_s = None
    full_sharded_workload = "see grid16_rank_full_sharded_s for why absent"
    mesh_efficiency = None
    if on_cpu:
        ref_wall, spanel, smask = full_rank_s, fpm, fmm
    else:
        ref_wall, spanel, smask = grid_rank_s, pm, mm
    A_s, T_s = A_f, T_f
    if SMOKE:
        full_sharded_s = SMOKE_REASON
    elif spanel is None or not isinstance(ref_wall, float):
        full_sharded_s = (
            "skipped: no full-size panel in this child (the single-device "
            "full leg did not run; see grid16_rank_full_s)")
    elif _child_left() <= 2 * ref_wall + 120:
        full_sharded_s = (
            "skipped: child budget too small for the sharded full-size "
            "run after the single-device legs")
    else:
        try:
            from csmom_tpu_torch.mesh.pinning import shards_for
            from csmom_tpu_torch.mesh.rules import grid_asset_mesh
            from csmom_tpu_torch.parallel.collectives import grid_shard_fn

            n_cards = 0 if on_cpu else torch.cuda.device_count()
            if n_cards >= 2:
                devices = [torch.device("cuda", i) for i in range(n_cards)]
                layout = f"d{n_cards}"
            else:
                one = (dev if on_cpu or dev.index is not None
                       else torch.device("cuda", torch.cuda.current_device()))
                devices = [one] * MESH_LOGICAL_SHARDS
                layout = (f"d{MESH_LOGICAL_SHARDS} ({MESH_LOGICAL_SHARDS} "
                          f"logical shards of {one})")
            ndev = len(devices)
            g_sh = shards_for(len(wl.GRID_JS), ndev)
            a_sh = shards_for(int(spanel.shape[0]), max(1, ndev // g_sh))
            smesh = grid_asset_mesh(g_sh, a_sh, devices)
            simpl = "plain" if on_cpu else "kernel"
            sfn = grid_shard_fn(smesh, wl.GRID_SKIP, 10, "rank",
                                max(wl.GRID_KS), simpl)
            Js_t = torch.as_tensor(Js, dtype=torch.int64)
            Ks_t = torch.as_tensor(Ks, dtype=torch.int64)
            M_s = spanel.shape[1]

            def sg():
                spreads, live = sfn(spanel, smask, Js_t, Ks_t)
                fetch(torch.where(live, spreads, 0.0).nansum())

            leg = f"mesh.grid16.rank.{simpl}@{A_s}x{M_s}.g{g_sh}a{a_sh}"
            _compiled_leg(leg, sg)
            with obs.span("bench.row", row="grid16.full.sharded"):
                full_sharded_s, _SAMPLES["grid16_rank_full_sharded_s"] = \
                    _timed_reps(1, sg)
            obs_metrics.counter("bench.rows_landed").inc()
            full_sharded_workload = (
                f"16 cells, {A_s} stocks x {T_s} days, "
                f"grid{g_sh}xassets{a_sh} mesh, {layout}")
            if full_sharded_s > 0:
                # efficiency charges the devices the mesh spans (g*a)
                mesh_efficiency = round(
                    ref_wall / (full_sharded_s * g_sh * a_sh), 4)
        except Exception as e:  # record, never lose the JSON line
            full_sharded_s = f"failed: {type(e).__name__}: {e}"[:200]

    # a cost model of the grid's dominant stage (cohort partial sums:
    # nJ x H horizon-shifted masked reductions over the [A, M] panel), so
    # the wall maps to achieved bandwidth and operations
    nJ, H = len(Js), int(Ks.max())
    itemsize = np.dtype(np_dtype).itemsize
    grid_bytes = nJ * H * 3 * A * M * itemsize     # labels+ret+valid reads/horizon
    grid_flops = nJ * H * 6 * A * M                # cmp+select+2 FMA per side

    # peak HBM bandwidth by device name, so achieved GB/s reads as a
    # fraction of the roofline rather than a bare number
    from csmom_tpu_torch.utils.profiling import PEAK_HBM_GBPS

    peak_gbps = None if on_cpu else PEAK_HBM_GBPS.get(device_kind)

    # the final record extends the progressively-filled _PROG extra (one
    # source for every measured value: the watchdog's partial dump and
    # the full record never disagree on a number)
    extra = dict(_PROG["extra"])
    extra.update({
        "timing": "per-rep fetch of a scalar to the host, after a "
                  "device synchronize (utils.profiling.fetch)",
        "event_batched_per_run_s": (batched_skip_reason
                                    if batched_per_run_s is None
                                    else round(batched_per_run_s, 6)),
        "event_batched_note": (batched_skip_reason
                               if batched_per_run_s is None else
                               "per-run wall of a 32-wide batch (a loop of "
                               "single-panel calls, one fetch) — the "
                               "throughput number for sweeps/bootstrap, vs "
                               "the fetch-inclusive single-run wall above"),
        "reference_wall_s": 18.4,
        "pack_ingest_note": f"memmapped binary panel ({A}x{T} f32 values + "
                            "mask) read disk->host from the packed cache "
                            "(csmom_tpu_torch.panel.pack); replaces per-run "
                            "CSV parsing at scale",
        "north_star_target_s": NORTH_STAR_TARGET_S,
        "grid_model_gbytes": round(grid_bytes / 1e9, 3),
        "grid_achieved_gbps": round(grid_bytes / grid_rank_s / 1e9, 1),
        "grid_achieved_gflops": round(grid_flops / grid_rank_s / 1e9, 1),
        "device_kind": device_kind,
        "chip_peak_hbm_gbps": (
            peak_gbps if peak_gbps is not None else
            ("not applicable: cpu platform has no HBM roofline table entry"
             if on_cpu else
             f"unknown device kind {device_kind!r}: no peak-bandwidth "
             "table entry")
        ),
        "grid_hbm_fraction": (
            round(grid_bytes / grid_rank_s / 1e9 / peak_gbps, 4)
            if peak_gbps is not None else
            "not applicable: no peak-bandwidth entry for this platform"
        ),
        "grid16_rank_full_s": _r4(full_rank_s),
        "grid16_rank_matmul_full_s": _r4(full_matmul_s),
        "grid_full_workload": (
            f"16 cells, {A_f} stocks x {T_f} days"
            if isinstance(full_rank_s, float)
            else "see grid16_rank_full_s for why the full-size leg is absent"
        ),
        "grid16_rank_full_sharded_s": _r4(full_sharded_s),
        "grid_full_sharded_workload": full_sharded_workload,
        "mesh_scaling_efficiency": (
            mesh_efficiency if mesh_efficiency is not None else
            "not measurable: no (reference wall, sharded wall) pair this "
            "run — see grid16_rank_full_sharded_s"
        ),
    })
    # warm-start accounting: the kernel libraries this child built (0 when
    # the warm-up child, or an earlier run, built them) or loaded
    total_cs = compile_stats().delta(_stats0)
    extra["compile_totals"] = {
        **total_cs.as_dict(),
        "in_window_fresh_compiles": total_cs.libraries_built,
        "note": "libraries_built = kernel libraries compiled with nvcc in "
                "this child (fresh compiles); libraries_built_or_loaded "
                "adds those loaded from the build directory; eager torch "
                "compiles nothing per shape",
    }
    # the kernel wrappers' launch counts over this child's life (a CPU
    # call runs the plain version and counts none)
    from csmom_tpu_torch.ops import kernels

    extra["kernel_launches"] = {
        "decile_partial_sums": kernels.decile_partial_sums.launches,
        "cohort_partial_sums": kernels.cohort_partial_sums.launches,
    }
    if SMOKE:
        extra["smoke"] = ("smoke-mode record: pipeline-shaped, workload "
                          "reduced — NOT a performance capture")
    _margin = _child_left()
    obs_metrics.gauge("bench.deadline_margin_s").set(
        None if _margin == float("inf") else round(_margin, 3))
    extra["metrics"] = (
        obs_metrics.snapshot() if obs.armed() else
        "not captured: telemetry disarmed (CSMOM_TELEMETRY=0)"
    )
    line = json.dumps(
        {
            "metric": "intraday_event_backtest_bar_groups_per_sec",
            "value": round(groups_per_sec, 1),
            "unit": "bar_groups/s",
            "vs_baseline": round(groups_per_sec / BASELINE_GROUPS_PER_SEC, 1),
            "extra": extra,
        }
    )
    _chaos("bench.finish")
    # close the child's root span and mirror the final snapshot into the
    # event stream before the summary lands (the supervisor assembling the
    # sidecar reads it from there)
    _root_sp.set(platform=platform)
    _root_sp.__exit__(None, None, None)
    _col = obs.spans.current_collector()
    if _col is not None:
        _col.emit({"kind": "metrics", "t_s": round(time.monotonic(), 6),
                   "data": obs_metrics.snapshot()})
    _finish(line)


def histrank_child_main():
    """Distributed-rank shootout on an 8-shard mesh of the bench's device
    (logical shards of the card, or of the CPU with ``--device cpu``):
    the O(A) all_gather baseline against the radix-histogram boundary
    selection (communication independent of A) at a universe past the
    all_gather design point (A ~ 50k; the north star is 3k).

    The shards share one device, so the walls measure local compute
    (the histogram's bucket scans against one sort), while the
    communication-bytes model is what matters across hosts.  Both are
    reported.
    """
    import numpy as np
    import torch

    from csmom_tpu_torch.parallel.collectives import _ranked_labels_local
    from csmom_tpu_torch.parallel.compat import P, shard_map
    from csmom_tpu_torch.parallel.mesh import Mesh
    from csmom_tpu_torch.utils.profiling import sync

    dev = torch.device("cpu" if os.environ.get("CSMOM_BENCH_FORCE_CPU")
                       else "cuda:0")
    n_dev = MESH_LOGICAL_SHARDS
    A, M, B = 49_152, 120, 10          # A divisible by 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(A, M)).astype(np.float32)
    valid = rng.random((A, M)) > 0.1
    x = np.where(valid, x, np.nan).astype(np.float32)
    mesh = Mesh([dev] * n_dev, ("assets",))
    xt = torch.from_numpy(x).to(dev)
    vt = torch.from_numpy(valid).to(dev)

    def build(mode):
        return shard_map(
            lambda xl, vl: _ranked_labels_local(xl, vl, B, mode)[0],
            mesh=mesh,
            in_specs=(P("assets", None), P("assets", None)),
            out_specs=P("assets", None),
        )

    def timed(mode, reps=3):
        f = build(mode)
        f(xt, vt)  # first call
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            f(xt, vt)
        sync()
        return (time.perf_counter() - t0) / reps

    wall_gather = timed("rank")
    wall_hist = timed("rank_hist")

    # per-call communication model (bytes entering each device)
    itemsize = 4
    gather_bytes = A * M * itemsize + A * M * 1        # signal f32 + valid bool
    R, E, rounds = 16, B - 1, 32 // 4                  # f32 keys, 4 bits/round
    hist_bytes = rounds * R * M * E * 4 + 6 * M * E * 8  # psum'd hists + tie fixups
    # histogram comm is independent of A, so the bytes crossover is the A
    # where the gather's linear cost passes the histogram's constant; the
    # wall crossover also depends on the interconnect against the
    # histogram's extra local bucket scans, which only a multi-host
    # measurement can place: until then the bytes model is the label
    crossover_A = int(hist_bytes / (M * (itemsize + 1)))
    print(json.dumps({
        "metric": "histrank_comparison",
        "value": round(gather_bytes / hist_bytes, 1),
        "unit": "comm_reduction_x",
        "vs_baseline": 0.0,
        "extra": {
            "workload": f"{A} assets x {M} dates, {B} bins, {n_dev}-shard "
                        f"mesh of {dev}",
            "allgather_wall_s": round(wall_gather, 4),
            "rank_hist_wall_s": round(wall_hist, 4),
            "allgather_bytes_per_device": gather_bytes,
            "rank_hist_bytes_per_device": hist_bytes,
            "comm_reduction_x": round(gather_bytes / hist_bytes, 1),
            "bytes_crossover_assets": crossover_A,
            "note": "walls of logical shards of one device measure local "
                    "compute (the collectives are copies on it); the bytes "
                    "model is the multi-host story — rank_hist "
                    "communication is independent of A, so its comm bytes "
                    "undercut the gather's above bytes_crossover_assets. "
                    "The WALL crossover (comm savings vs the histogram's "
                    "extra local bucket scans) needs a real multi-host "
                    "measurement; absent one, this stays a bytes model, "
                    "not a speedup claim",
        },
    }))


def warmup_child_main():
    """Warm-start pass (``CSMOM_BENCH_WARMUP=1``): warms every
    ``bench-gpu`` + ``golden`` manifest shape on the card (``bench-cpu``
    on the CPU with ``CSMOM_BENCH_FORCE_CPU``), building or loading the
    kernel libraries and making the canonical inputs, so the
    measuring child loads instead of building.  Also reachable as
    ``warmup --profiles bench-gpu,golden``.  Prints one JSON summary line
    (the supervisor attaches it to the FULL record)."""
    from csmom_tpu_torch import obs
    from csmom_tpu_torch.compile.aot import warmup

    on_cpu = bool(os.environ.get("CSMOM_BENCH_FORCE_CPU"))
    obs.arm_from_env("bench-warmup")
    with obs.span("bench.warmup.child"):
        rep = warmup(profiles=("bench-cpu" if on_cpu else "bench-gpu",
                               "golden"), subdir="bench",
                     device="cpu" if on_cpu else "cuda")
    print(json.dumps({
        "metric": "aot_warmup",
        "value": rep["n_entries"],
        "unit": "manifest_entries",
        "n_cache_hits": rep["n_cache_hits"],
        "n_errors": rep["n_errors"],
        "wall_s": rep["wall_s"],
        "cache_dir": rep["cache_dir"],
    }))


# ----------------------------------------------------------- supervisor ----

_PROBE_CODE = {
    "cuda": ("import torch\n"
             "if not torch.cuda.is_available():\n"
             "    raise SystemExit('no CUDA device is available')\n"
             "print('gpu', torch.cuda.get_device_name(0))\n"),
    "cpu": "import torch\nprint(torch.zeros(1).device)\n",
}


def _probe_device(device: str, reserve_s: float):
    """``(ok, info)``: whether ``device`` initializes in a subprocess
    within the probe timeout.  ``reserve_s`` is budget that must stay
    untouched for later stages."""
    if _chaos("bench.probe") == "fail":
        return False, "chaos-injected probe failure (CSMOM_FAULT_PLAN)"
    timeout = min(PROBE_TIMEOUT_S, _remaining() - reserve_s)
    if timeout < 10:
        return False, "no budget left for a probe"
    try:
        with _tel_span("bench.probe", timeout_s=int(timeout), device=device):
            p = subprocess.run(
                [sys.executable, "-c", _PROBE_CODE[device]],
                capture_output=True, text=True, timeout=timeout,
                env=_child_env(device=device),
            )
    except subprocess.TimeoutExpired:
        return False, (f"probe timeout after {int(timeout)}s ({device} "
                       "hung at init)")
    if p.returncode == 0:
        return True, (p.stdout.strip().splitlines() or ["?"])[-1]
    return False, (p.stderr or "")[-400:]


def _parse_json_line(stdout: str):
    for line in reversed((stdout or "").strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "metric" in obj and "value" in obj:
            return obj
    return None


def _run_child(device: str):
    """One measuring child on ``device``: ``(record or None, error)``."""
    env = _child_env("CSMOM_BENCH_CHILD", device)
    timeout = _remaining() - REPORT_RESERVE_S
    if timeout < 60:
        return None, "no budget left for this attempt"
    env["CSMOM_BENCH_CHILD_BUDGET"] = str(int(timeout))
    try:
        with _tel_span("bench.child.attempt", device=device):
            p = subprocess.run(_module_argv(), env=env, capture_output=True,
                               text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        return _parse_json_line(out), f"child timeout after {int(timeout)}s"
    obj = _parse_json_line(p.stdout)
    if obj is not None:
        return obj, None
    return None, f"rc={p.returncode}: {(p.stderr or '')[-400:]}"


def _run_warmup_child(device: str):
    """The warm-up child on ``device``, before the measuring child, as a
    record-ready value: its summary line or the reason there is none.
    A warm-up's lasting product is the kernel libraries, so it runs only
    on a card where one of them is missing or fails its digest."""
    if SMOKE:
        return SMOKE_REASON
    if device == "cpu":
        return ("not needed: the cpu runs the plain versions, with no kernel "
                "library to build")
    from csmom_tpu_torch.ops import build

    if all(build.intact(build.library_path(k)) for k in build.KERNELS):
        return (f"not needed: every kernel library is built and intact in "
                f"{build.build_dir()} (a warm-up would only load them)")
    timeout = min(WARMUP_TIMEOUT_S,
                  _remaining() - CHILD_MIN_S - REPORT_RESERVE_S)
    if timeout < 30:
        return (f"skipped: no budget left before the measuring child "
                f"({int(timeout)}s < 30s floor)")
    env = _child_env("CSMOM_BENCH_WARMUP", device)
    try:
        with _tel_span("bench.warmup", device=device):
            p = subprocess.run(_module_argv(), env=env, capture_output=True,
                               text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return (f"failed: warm-up child timeout after {int(timeout)}s (the "
                "libraries and packs it reached stay built)")
    obj = _parse_json_line(p.stdout)
    if obj is not None:
        return obj
    return f"exited rc={p.returncode} without a summary line"[:200]


def _run_histrank_child(device: str):
    """The distributed-rank comparison in its own process, so its mesh
    never shares a process with the measuring child's timings."""
    if SMOKE:
        return SMOKE_REASON
    env = _child_env("CSMOM_BENCH_HISTRANK", device)
    timeout = _remaining() - 60
    if timeout < 90:
        return f"skipped: no budget left ({int(timeout)}s < 90s floor)"
    try:
        p = subprocess.run(_module_argv(), env=env, capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"failed: histrank child timeout after {int(timeout)}s"
    obj = _parse_json_line(p.stdout)
    if obj is None:
        return f"failed: rc={p.returncode}: {(p.stderr or '')[-300:]}"
    return obj


def _load_committed_json(pattern: str, absent_reason: str):
    """Most recent committed capture matching ``pattern`` (the checkout's
    root), as a compact dict, or the reason there is none.  Cross-process
    captures are measured by their own scripts and committed; bench only
    reports them."""
    import glob

    paths = sorted(glob.glob(os.path.join(_REPO, pattern)))
    if not paths:
        return absent_reason
    try:
        with open(paths[-1]) as f:
            rec = json.load(f)
        return {"source": os.path.basename(paths[-1]),
                **(rec.get("extra") or {})}
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable {os.path.basename(paths[-1])}: {e}"[:200]


def _load_histrank_multiproc():
    return _load_committed_json(
        "GPU_HISTRANK_MULTIPROC_*.json",
        "not measured: the port has no cross-process histrank capture "
        "(the reference's histrank_multiproc script is not ported); the "
        "in-process bytes model above stands alone",
    )


# The round's full record.  A reader of the headline keeps a 2,000-char
# tail of stdout, so everything beyond the headline lives in this file.
ROUND = os.environ.get("CSMOM_ROUND", "r05")
FULL_RECORD_NAME = f"GPU_BENCH_FULL_{ROUND}.json"
HEADLINE_MAX_CHARS = 1600  # hard cap, well under a capture's 2,000-char tail


def _full_dir() -> str:
    return os.environ.get("CSMOM_BENCH_FULL_DIR") or os.getcwd()


def _write_full_record(record: dict) -> str:
    """Persist the complete bench record to the round's file.

    Returns the file name (for the headline pointer), or a reason string
    if the write failed: the headline is never lost to a record-file IO
    error.

    A TOTAL failure (every attempt failed, value 0) never overwrites an
    existing measured round record: the failure record lands under a
    ``_failed`` sibling name instead, and the headline points there."""
    name = FULL_RECORD_NAME
    out_dir = _full_dir()
    if record.get("value") == 0.0 and (record.get("extra") or {}).get("error"):
        main_path = os.path.join(out_dir, name)
        try:
            with open(main_path) as f:
                existing = json.load(f).get("value")
            if isinstance(existing, (int, float)) and existing > 0:
                name = name.replace(".json", "_failed.json")
        except Exception:
            pass  # no measured record to protect: claim the main name
                  # (never die here: the headline must still print)
    path = os.path.join(out_dir, name)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        _chaos("bench.land", path=name)  # ENOSPC fault lands in the handler
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return name
    except OSError as e:
        # never leave a half-written .tmp beside the records
        try:
            os.remove(tmp)
        except OSError:
            pass
        return f"unwritable ({type(e).__name__}: {e})"[:120]


def _headline(record: dict, full_record_ref: str) -> str:
    """One compact JSON line for stdout: the four required fields plus a
    fixed, size-bounded digest of extra.  Serialized length is at most
    ``HEADLINE_MAX_CHARS`` by construction plus a final degrade step."""
    ex = record.get("extra") or {}

    def _s(v, n=120):  # bound any free-text value
        return v if not isinstance(v, str) else (v if len(v) <= n else v[:n - 1] + "…")

    probes = ex.get("probes") or []
    digest = {
        "platform": ex.get("platform"),
        "device_kind": ex.get("device_kind"),
        "north_star_met": ex.get("north_star_met"),
        # the headline metric's workload fingerprint: the ledger keys its
        # rows on it, so a round whose FULL record is lost still lands a
        # headline comparable with other rounds' records
        "workload": _s(ex.get("workload")),
        "grid16_rank_s": ex.get("grid16_rank_s"),
        "grid_workload": _s(ex.get("grid_workload")),
        "golden_ok": ex.get("golden_ok"),
        "event_backtest_wall_s": ex.get("event_backtest_wall_s"),
        "in_window_fresh_compiles": (ex.get("compile_totals") or {}).get(
            "in_window_fresh_compiles") if isinstance(
            ex.get("compile_totals"), dict) else None,
        "probes_summary": (
            f"{sum(1 for p in probes if p.get('ok'))}/{len(probes)} ok"
            if probes else None
        ),
        "error": _s(ex.get("error")),
        "partial": _s(ex.get("partial")),
        "full_record": full_record_ref,
        "full_record_note": "complete extra (probes, every grid leg, "
                            "histrank) lives in the full_record file",
    }
    digest = {k: v for k, v in digest.items() if v is not None}
    head = {
        "metric": _s(record.get("metric"), 80),
        "value": record.get("value"),
        "unit": _s(record.get("unit"), 40),
        "vs_baseline": record.get("vs_baseline"),
    }
    line = json.dumps({**head, "extra": digest})
    if len(line) > HEADLINE_MAX_CHARS:  # degrade, never exceed
        line = json.dumps({
            **head,
            "extra": {"full_record": full_record_ref,
                      "note": "headline digest exceeded the size cap; "
                              "see full_record"},
        })
    return line


def main(argv=None) -> int:
    """The supervisor; returns the exit code (1 on the last-resort
    record, when no child measured anything)."""
    import argparse
    import datetime

    ap = argparse.ArgumentParser(
        prog="python -m csmom_tpu_torch.bench",
        description="the headline benchmark: one JSON line on stdout, the "
                    "full record in GPU_BENCH_FULL_${CSMOM_ROUND}.json")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device to measure on (default cuda; "
                         "CSMOM_BENCH_FORCE_CPU=1 means cpu); nothing is "
                         "measured on another one")
    args = ap.parse_args(argv)
    device = "cpu" if (args.device == "cpu"
                       or os.environ.get("CSMOM_BENCH_FORCE_CPU")) else "cuda"

    def stamp():
        return datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        )

    _tel_start()  # root span + shared event stream for every child
    probes, errors = [], []
    result = None
    warmup_child = "not launched: the device probe failed"

    ok, info = _probe_device(device,
                             reserve_s=CHILD_MIN_S + REPORT_RESERVE_S)
    probes.append({"utc": stamp(), "stage": "probe", "device": device,
                   "ok": ok, "info": info})
    if ok:
        warmup_child = _run_warmup_child(device)
        for attempt in range(1, MAX_CHILD_ATTEMPTS + 1):
            obj, err = _run_child(device)
            if obj is not None:
                result = obj
                if err:  # a timed-out child's partial line still counts
                    errors.append(f"{device} child attempt {attempt}: {err}")
                break
            errors.append(f"{device} child attempt {attempt}: {err}")
            if err == "no budget left for this attempt":
                break

    if result is not None:
        rc = 0
        result.setdefault("extra", {})["probes"] = probes
        if errors:
            result["extra"]["attempt_errors"] = errors
        hr = _run_histrank_child(device)  # budget permitting; reasons otherwise
        result["extra"]["histrank_vs_allgather"] = (
            hr.get("extra", hr) if isinstance(hr, dict) else hr
        )
        result["extra"]["histrank_cross_process"] = _load_histrank_multiproc()
        result["extra"]["warmup_child"] = warmup_child
        try:
            from csmom_tpu_torch.compile.aot import read_warmup_report

            result["extra"]["aot_warmup_report"] = read_warmup_report("bench")
        except Exception as e:  # never lose the record to report plumbing
            result["extra"]["aot_warmup_report"] = (
                f"unreadable: {type(e).__name__}: {e}"[:200]
            )
        result["extra"]["multihost_equality"] = _load_committed_json(
            "GPU_MULTIHOST_*.json",
            "not captured: `python -m csmom_tpu_torch.parallel."
            "multihost_dryrun` checks cross-process sharded==single "
            "equality and commits no record",
        )
    else:
        # last resort: a parseable record that says nothing was measured
        rc = 1
        result = {
            "metric": "intraday_event_backtest_bar_groups_per_sec",
            "value": 0.0,
            "unit": "bar_groups/s",
            "vs_baseline": 0.0,
            "extra": {"error": ("all benchmark attempts failed"
                                + ("" if ok else f": the {device} probe "
                                   f"failed ({info.strip()[:160]})")),
                      "attempts": errors, "probes": probes},
        }
    # split the output: the telemetry sidecar lands first so the FULL
    # record can point at what actually landed (name or failure reason),
    # then the full record, then the bounded headline line on stdout
    result.setdefault("extra", {})["telemetry_sidecar"] = _tel_finish(
        _full_dir())
    ref = _write_full_record(result)
    print(_headline(result, ref), flush=True)
    return rc


if __name__ == "__main__":
    if os.environ.get("CSMOM_BENCH_HISTRANK"):
        histrank_child_main()
    elif os.environ.get("CSMOM_BENCH_WARMUP"):
        warmup_child_main()
    elif os.environ.get("CSMOM_BENCH_CHILD"):
        child_main()
    else:
        sys.exit(main())
