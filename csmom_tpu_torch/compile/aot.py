"""The warm-up: every manifest entry run once at its shape, with records.

Counterpart of ``csmom_tpu.compile.aot``, with its names:
:func:`aot_compile` warms one entry and :func:`warmup` warms whole
profiles and writes the report.  The reference lowers and compiles each
entry into XLA's executable cache on disk, so that a later process loads
instead of compiling.  Eager torch compiles nothing per shape: what
lasts across processes is the kernel libraries in
``build/csmom_tpu_torch/`` (:mod:`csmom_tpu_torch.ops.build`, keyed by a
digest of source and flags), and what lasts within a process is the
loaded libraries, the CUDA context, cuBLAS's handle and workspace, the
caching allocator grown to the shape's peak, and the lazy imports.  So
the port warms by running: it builds or loads the libraries an entry
launches, then calls the entry twice on seeded inputs of its shapes
(ROADMAP.md, known differences).  A donated entry consumes its inputs,
so each of its two calls gets inputs of its own, made from the same
seed, and its record's ``donated_calls`` says that both ran and
consumed them.

Each record carries the reference's ``name``, ``shapes``, ``memory``
(:mod:`csmom_tpu_torch.obs.memstats`, from the caching allocator around
the second call), ``cache_hit`` (true when no library had to be built),
``profile``, on failure ``error``, and ``self_healed`` when a library
the entry loads was found corrupt, evicted and rebuilt (``cache_hit`` is
then false); in place of ``trace_s``,
``compile_s``, ``cache_hits`` and ``cache_writes`` it has ``build_s``
(building or loading the entry's libraries), ``first_call_s``,
``warm_call_s``, ``libraries_built`` and the ``launches`` of each kernel
over both calls.  Every clock is read after the device finished.  The
report is the reference's ``aot_warmup`` dict with ``n_self_healed``
added, written to ``<build dir>/warmup/<subdir>/warmup_report.json``
(:func:`read_warmup_report`).  As in the reference a failing entry is
recorded with its error and the warm-up goes on.
"""

from __future__ import annotations

import json
import os
import time

from csmom_tpu_torch.utils.logging import get_logger

__all__ = ["REPORT_NAME", "aot_compile", "read_warmup_report", "report_dir",
           "warmup"]

log = get_logger("compile.aot")

REPORT_NAME = "warmup_report.json"
# the wrappers whose launch counters a record reads (ops/kernels.py)
_KERNELS = ("decile_partial_sums", "cohort_partial_sums", "rank_labels")


def report_dir(subdir: str = "bench") -> str:
    """Where :func:`warmup` writes its report for ``subdir``: under the
    build directory (:func:`~csmom_tpu_torch.ops.build.build_dir`)."""
    from csmom_tpu_torch.ops.build import build_dir

    return os.path.join(str(build_dir()), "warmup", subdir)


def _launches() -> dict:
    from csmom_tpu_torch.ops import kernels

    return {k: getattr(kernels, k).launches for k in _KERNELS}


def aot_compile(entry, device=None, seed: int = 0) -> dict:
    """Warm one :class:`~csmom_tpu_torch.compile.manifest.ManifestEntry`
    on ``device`` (default cuda, raising without a card); return its
    record (see the module docstring).

    The entry's arguments are made from ``seed``; on the card, a kernel
    the entry names that its calls did not launch, or one they launched
    that it does not name, fails the entry.
    """
    import numpy as np
    import torch

    from csmom_tpu_torch.chaos.inject import checkpoint
    from csmom_tpu_torch.device import resolve_device
    from csmom_tpu_torch.obs import memstats, span
    from csmom_tpu_torch.ops import build
    from csmom_tpu_torch.utils.donation import is_deleted
    from csmom_tpu_torch.utils.profiling import compile_stats, sync

    entry.validate()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    before, launches0 = compile_stats(), _launches()
    healed0 = len(build.libraries_healed())
    with span("aot.compile", entry=entry.name) as sp:
        sync()
        baseline = torch.cuda.memory_allocated(dev) if on_card else None
        args, kwargs = entry.materialize(dev, np.random.default_rng(seed))
        t0 = time.perf_counter()
        if on_card:
            for name in entry.kernels:
                build.load(name)
        build_s = time.perf_counter() - t0
        checkpoint("aot.compile", entry=entry.name)
        sync()
        consumed = 0
        t1 = time.perf_counter()
        out = entry.fn(*args, **dict(kwargs))
        sync()
        first_call_s = time.perf_counter() - t1
        del out
        if entry.donated:
            consumed += all(is_deleted(args[i]) for i in entry.donated)
            args, kwargs = entry.materialize(dev, np.random.default_rng(seed))
        t2 = time.perf_counter()
        out, memory = memstats.measure(lambda: entry.fn(*args, **dict(kwargs)),
                                       (args, kwargs), baseline)
        sync()
        warm_call_s = time.perf_counter() - t2
        if entry.donated:
            consumed += all(is_deleted(args[i]) for i in entry.donated)
            if consumed != 2:
                raise RuntimeError(
                    f"{entry.name}: {2 - consumed} of its two calls left the "
                    f"donated arguments {entry.donated} unconsumed")
        del out, args, kwargs
        sp.set(build_s=round(build_s, 4), first_call_s=round(first_call_s, 4),
               warm_call_s=round(warm_call_s, 4))
    d = compile_stats().delta(before)
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    if on_card:
        launched = {k for k, v in launches.items() if v}
        if launched != set(entry.kernels):
            raise RuntimeError(
                f"{entry.name}: its calls launched {sorted(launched)}, "
                f"the entry names {sorted(entry.kernels)}")
    rec = {
        "name": entry.name,
        "shapes": entry.shape_summary(),
        "build_s": round(build_s, 4),
        "first_call_s": round(first_call_s, 6),
        "warm_call_s": round(warm_call_s, 6),
        "memory": memstats.capture(entry.name, memory,
                                   platform="gpu" if on_card else "cpu"),
        "libraries_built": d.libraries_built,
        "launches": launches,
        "cache_hit": d.libraries_built == 0,
    }
    if entry.donated:
        rec["donated_calls"] = consumed
    healed = build.libraries_healed()[healed0:]
    if healed:
        rec["self_healed"] = ("corrupt cache entry evicted and recompiled "
                              "cold")
        rec["cache_hit"] = False
        log.warning("%s: corrupt kernel librar%s %s evicted and rebuilt",
                    entry.name, "y" if len(healed) == 1 else "ies",
                    ", ".join(healed))
    return rec


def warmup(profiles=("bench-gpu", "golden"), *, subdir: str = "bench",
           include_golden_event: bool = True, write_report: bool = True,
           device=None) -> dict:
    """Warm every manifest entry of the given profiles on ``device``
    (default cuda, raising without a card).

    For the bench profiles it also builds the grid's month-end inputs
    from the synthetic pack, as a benchmark would, and (with
    ``include_golden_event``) warms the event engines at the golden event
    workload's shapes, which runs the intraday pipeline (on the card also
    the 32-wide event leg).  ``bench-tpu`` reads as ``bench-gpu``.

    Returns the report (see the module docstring), written to
    :func:`report_dir` unless ``write_report`` is false.  Never raises on
    a single entry: a failed entry is recorded with its error.
    """
    import datetime

    from csmom_tpu_torch.chaos.inject import checkpoint
    from csmom_tpu_torch.compile.manifest import build_manifest, golden_event_entries
    from csmom_tpu_torch.compile.workloads import bench_device
    from csmom_tpu_torch.obs import memstats, span
    from csmom_tpu_torch.ops.build import build_dir
    from csmom_tpu_torch.registry.core import canonical_profile
    from csmom_tpu_torch.utils.profiling import compile_stats, measure_rtt

    profiles = tuple(canonical_profile(p) for p in profiles)
    dev, on_cpu, dtype = bench_device(device)
    t_start = time.perf_counter()
    base = compile_stats()

    entries = []
    for profile in profiles:
        entries += [(profile, e) for e in build_manifest(profile)]
    if not on_cpu:
        # the libraries the entries name, built at once (one nvcc each, in
        # parallel) rather than one at a time as the entries reach them; a
        # failed build is left to the entries, which record its error
        from csmom_tpu_torch.ops import build

        try:
            build.build(tuple(dict.fromkeys(k for _, e in entries for k in e.kernels)))
        except RuntimeError as e:
            log.warning("warmup: building the entries' kernels: %s", str(e)[:200])

    rows = []

    def run(profile, entry):
        checkpoint("warmup.entry", entry=entry.name)
        with span("warmup.entry", entry=entry.name, profile=profile):
            try:
                rec = aot_compile(entry, device=dev)
            except Exception as e:  # record, keep warming the rest
                rec = {"name": entry.name,
                       "error": f"{type(e).__name__}: {e}"[:200]}
        rec["profile"] = profile
        rows.append(rec)
        log.info("warmup %-40s build %.2fs first %.4fs warm %.4fs %s",
                 rec.get("name"), rec.get("build_s", 0.0),
                 rec.get("first_call_s", 0.0), rec.get("warm_call_s", 0.0),
                 "HIT" if rec.get("cache_hit") else
                 ("ERROR" if "error" in rec else "built"))

    for profile, entry in entries:
        run(profile, entry)

    # a benchmark's wall is not only its entry points: building the grid
    # inputs (the pack, its read, the month-end aggregation) runs too
    bench = any(p.startswith("bench") for p in profiles)
    inputs_note = "skipped: no bench profile requested"
    if bench:
        from csmom_tpu_torch.compile.workloads import (
            NORTH_STAR_GRID,
            REDUCED_GRID,
            grid_month_inputs,
        )

        sizes = ([REDUCED_GRID, NORTH_STAR_GRID]
                 if "bench-cpu" in profiles else [NORTH_STAR_GRID])
        t0_in = time.perf_counter()
        try:
            for A, T in sizes:
                grid_month_inputs(A, T, dtype, device=dev)
            inputs_note = (f"grid month panels built for {sizes} in "
                           f"{time.perf_counter() - t0_in:.1f}s "
                           "(pack and its read warmed)")
        except Exception as e:
            inputs_note = f"failed: {type(e).__name__}: {e}"[:200]

    golden_note = "skipped: include_golden_event=False"
    if include_golden_event and bench:
        # the event engines at the golden shapes; building the inputs runs
        # the intraday pipeline.  On the card also the 32-wide event leg
        try:
            for entry in golden_event_entries(dtype, batch=None if on_cpu else 32,
                                              device=dev):
                run("golden-event", entry)
            measure_rtt(dtype, device=dev)
            golden_note = "resolved from the golden input build"
        except Exception as e:
            golden_note = f"failed: {type(e).__name__}: {e}"[:200]
    elif not bench:
        golden_note = "skipped: no bench profile requested"

    total = compile_stats().delta(base)
    peaks = {r["name"]: memstats.peak_bytes(r.get("memory")) for r in rows}
    measured = {k: v for k, v in peaks.items() if v is not None}
    report = {
        "metric": "aot_warmup",
        "utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        "platform": "cpu" if on_cpu else "gpu",
        "device": str(dev),
        "profiles": list(profiles),
        "cache_dir": str(build_dir()),
        "n_entries": len(rows),
        "n_cache_hits": sum(1 for r in rows if r.get("cache_hit")),
        "n_errors": sum(1 for r in rows if "error" in r),
        "n_self_healed": sum(1 for r in rows if r.get("self_healed")),
        "input_builders": inputs_note,
        "golden_event": golden_note,
        "wall_s": round(time.perf_counter() - t_start, 2),
        "totals": total.as_dict(),
        # which shape claims the most device memory, so a reader sees the
        # binding shape first (per-shape detail rides in each entry)
        "memory": (
            {
                "n_shapes_measured": len(measured),
                "max_peak_bytes": max(measured.values()),
                "max_peak_entry": max(measured, key=measured.get),
            }
            if measured else
            "not measured: no entry produced a memory measurement"
        ),
        "entries": rows,
    }
    if write_report:
        d = report_dir(subdir)
        path = os.path.join(d, REPORT_NAME)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
    return report


def read_warmup_report(subdir: str = "bench") -> dict | str:
    """The most recent warm-up report of ``subdir``, or a reason string."""
    path = os.path.join(report_dir(subdir), REPORT_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return (f"not available: no warmup report at {path}; run "
                "`python -m csmom_tpu_torch.cli warmup`")
