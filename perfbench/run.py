"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

In order: the cell's inputs are made from ``--seed``; the port is loaded
and the cell's entry warmed (``setup_s``); the entry is driven back to
back for ``--seconds`` (with ``--trace 1`` a stretch in the middle of the
window runs under the profiler); every call's fetched output is compared
with the plain reference once the window has closed; and one JSON line is
printed last on standard output.  The numbers compared are printed beside
their limits as the last lines on standard error.

A cell is found by name: its configuration in ``perfbench/configs/``, its
traffic mix in ``perfbench/traffic/``, the entry the traffic names in
``perfbench/entries/`` (with its reference of the same name in
``perfbench/reference/``), its limits in ``perfbench/limits/<workload>.json``
and each metric's reader in ``perfbench/metrics/<metric>.py``, or for a
metric ``<family>.<layer>`` without a file of its own,
``perfbench/metrics/<family>.py``.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "csmom_tpu_torch"
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "csmom_tpu")
# calls before the window: the first loads or builds the kernel library
# and the cell's kernels; every call has the cell's one set of shapes
WARM_CALLS = 1
# each traced stretch: about this long, within these call counts
STRETCH_S = 0.3
STRETCH_CALLS = (10, 100)


def _process_age_s() -> float:
    """Seconds since this process started, from the kernel's records
    (0 where they cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the process's start on the perf_counter clock
T_START = _T_IMPORT - _process_age_s()


class Fail(Exception):
    """A run that must end with a nonzero code and no result."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's parts by name: its BENCHMARK.json entry, configuration,
    traffic, limits and the metrics it reports with and without a trace."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Fail(2, f"unknown workload {workload!r}; BENCHMARK.json has "
                      + ", ".join(sorted(cells)))
    w = cells[workload]
    pb = root / "perfbench"
    cfg = load_json(pb / "configs" / f"{w['config']}.json")
    traffic = load_json(pb / "traffic" / f"{w['traffic']}.json")
    limits = load_json(pb / "limits" / f"{workload}.json")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"workload": w, "config": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def load_reader(name: str, root: Path = ROOT):
    """The metric reader ``perfbench/metrics/<name>.py``, or for a name
    ``<family>.<layer>`` without a file of its own, the family's reader
    ``perfbench/metrics/<family>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "perfbench"
    os.environ["CSMOM_JIT_CACHE"] = str(root / "build" / PROGRAM)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def check_program(root: Path = ROOT) -> None:
    """The program under test has to be the checkout's own."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        raise Fail(4, f"{PROGRAM} is not in this checkout")
    if not Path(spec.origin).resolve().is_relative_to(root):
        raise Fail(4, f"{PROGRAM} loads from {spec.origin}, outside the "
                      f"checkout {root}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Outputs:
    """Every fetched output of the window, kept once for each distinct value
    with the number of calls that gave it, so that the window's host memory
    stays flat.  An output is compared bit for bit with the last value
    seen, and looked up by its bytes only where it differs."""

    def __init__(self):
        self.groups: dict = {}
        self.last = None
        self.n = 0

    def add(self, out) -> None:
        self.n += 1
        last = self.last
        if last is not None and last[0].shape == out.shape \
                and last[0].dtype == out.dtype \
                and (last[0].view("u1") == out.view("u1")).all():
            last[1] += 1
            return
        self.last = self.groups.setdefault(out.tobytes(), [out, 0])
        self.last[1] += 1


def compare(outputs: Outputs, cell, ref, limits: dict):
    """Every call's output against the reference: the worst reading of each
    number over the calls (alike outputs are read once), the number of
    calls with a reading over its limit, and the checks ``{name: {"value",
    "limit"}}`` with the last call's panel readings."""
    worst: dict = {}
    failed = 0
    for out, n in outputs.groups.values():
        r = cell.readings(out, ref)
        if any(not (r[k] <= limits[k]) for k in r):
            failed += n
        for k, v in r.items():
            if k not in worst or not v <= worst[k]:   # NaN counts as worst
                worst[k] = v
    worst.update(cell.final_readings(ref))
    checks = {k: {"value": float(worst.get(k, math.inf)), "limit": limits[k]}
              for k in limits}
    return failed, checks


def _chunk_means(durations, chunk_s: float) -> list:
    """Mean call milliseconds over each ``chunk_s`` of the window."""
    out, acc, n = [], 0.0, 0
    for d in durations:
        acc, n = acc + d, n + 1
        if acc >= chunk_s:
            out.append(acc / n * 1e3)
            acc, n = 0.0, 0
    if n:
        out.append(acc / n * 1e3)
    return out


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, t_start: float = T_START):
    """Run one cell; returns ``(result dict, checks)``.  ``device="cpu"``
    drives the whole run on the CPU (the tests' path; no device metric is
    then read)."""
    import torch

    from perfbench import load
    from perfbench.trace import capture, reduce

    parts = resolve(load_json(root / "BENCHMARK.json"), workload, root)
    traffic = parts["traffic"]
    marks = {"torch_imported_s": time.perf_counter() - t_start}
    cell = load("entries", traffic["entry"]).Cell(parts["config"], traffic,
                                                  seed, device)
    marks["inputs_ready_s"] = time.perf_counter() - t_start
    cuda = device != "cpu"
    t = time.perf_counter()
    for _ in range(WARM_CALLS):
        cell.call()
    marks["build_s"] = time.perf_counter() - t
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()

    # once the profiler has run, CUPTI slows every later launch: a traced
    # run's untraced wall a call is read from the calls before its stretches
    outputs, durations, stretches, n_before = Outputs(), [], [], None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    traced_at = t0 + seconds / 2 if trace else math.inf
    now = t0
    while now < deadline:
        if now >= traced_at:
            traced_at = math.inf
            per_call = statistics.fmean(durations) if durations else STRETCH_S
            n = int(min(max(round(STRETCH_S / per_call), STRETCH_CALLS[0]),
                        STRETCH_CALLS[1]))
            n_before = len(durations)
            # a first stretch, not read, only starts the profiler: CUPTI's
            # first use slows the calls that follow it for a while
            for out in capture(cell.call, n, cuda, False)[0]:
                outputs.add(out)
            for host_ops in (False, True):
                outs, prof, wall = capture(cell.call, n, cuda, host_ops)
                for out in outs:
                    outputs.add(out)
                stretches.append((n, prof, wall))
        else:
            outputs.add(cell.call())
            durations.append(time.perf_counter() - now)
        now = time.perf_counter()
    window_s = now - t0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    before = durations[:n_before]
    call_s = statistics.fmean(before) if before else None

    cell.close()
    if cuda:
        torch.cuda.empty_cache()
    timings = dict(marks)
    t = time.perf_counter()
    tr = reduce(*stretches) if stretches else None
    timings["trace_read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = cell.reference()
    timings["reference_s"] = time.perf_counter() - t
    t = time.perf_counter()
    failed, checks = compare(outputs, cell, ref, parts["limits"])
    timings["compare_s"] = time.perf_counter() - t
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=outputs.n, call_s=call_s,
        trace=tr, work=cell.work(ref),
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu")
    metrics = {}
    for m in parts["per_layer" if trace else "end_to_end"]:
        v = load_reader(m["name"], root).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    result = {
        "correct": bool(correct),
        "attempted": outputs.n,
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": ctx.device_kind,
            "count": int(parts["workload"]["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if tr is not None and tr.device_ops:
        result["device"]["busy_s"] = tr.busy_us() / 1e6
        result["device"]["window_s"] = tr.wall_us / 1e6
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    q = statistics.quantiles(durations, n=10) if len(durations) > 1 else [0.0] * 9
    walls = {"untraced": call_s}
    if n_before is not None and durations[n_before:]:
        walls["after_stretches"] = statistics.fmean(durations[n_before:])
    for (n, _, wall), name in zip(stretches, ("cuda_only_stretch", "host_ops_stretch")):
        walls[name] = wall / n
    print("perfbench: " + json.dumps(dict(
        setup_s=setup_s, window_s=window_s, calls=outputs.n,
        distinct_outputs=len(outputs.groups),
        call_ms_p10_p50_p90_max=[q[0] * 1e3, q[4] * 1e3, q[8] * 1e3,
                                 max(durations, default=0.0) * 1e3],
        call_ms_by_5s=_chunk_means(durations, 5.0),
        first_calls_ms=[d * 1e3 for d in durations[:20]],
        wall_ms_a_call={k: v * 1e3 for k, v in walls.items() if v is not None},
        **timings)), file=sys.stderr)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        if not (ROOT / "BENCHMARK.json").is_file():
            raise Fail(2, f"no BENCHMARK.json at {ROOT}")
        bench = load_json(ROOT / "BENCHMARK.json")
        chips = int(resolve(bench, args.workload)["workload"]["chips"])
        set_cache_dirs()
        if str(ROOT) not in sys.path:
            sys.path.insert(0, str(ROOT))
        check_program()
        import torch

        if not torch.cuda.is_available():
            raise Fail(2, "no CUDA device: this benchmark runs only on the card")
        if torch.cuda.device_count() < chips:
            raise Fail(2, f"the cell asks for {chips} cards, "
                          f"{torch.cuda.device_count()} present")
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace))
        found = forbidden_modules()
        if found:
            raise Fail(3, "loaded in the benchmark's process: " + ", ".join(found))
    except Fail as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
