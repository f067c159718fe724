"""Readings for setting a cell's correctness limits, on the card.

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out FILE]

For each ``--seeds`` seed the cell's timed call runs once at the cell's own
size and its output is read against the plain reference, as a run reads
it; for each ``--control-seeds`` seed the control (the entry's
lower-precision path in the timed call's place) is read the same way.
Prints one JSON line per seed, then the largest program reading and the
smallest control reading of each number: the lower and upper readings a
limit is set between.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench.run import ROOT, load_json, resolve, set_cache_dirs


def readings(cell, control: bool) -> dict:
    out = cell.control_call() if control else cell.call()
    cell.close()
    t = time.perf_counter()
    ref = cell.reference()
    ref_s = time.perf_counter() - t
    r = dict(cell.readings(out, ref))
    r.update(cell.final_readings(ref))
    return r, ref_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    from perfbench import load

    parts = resolve(load_json(ROOT / "BENCHMARK.json"), args.workload)
    traffic = parts["traffic"]
    lines, worst, least = [], {}, {}
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        cell = load("entries", traffic["entry"]).Cell(parts["config"], traffic,
                                                      seed, "cuda")
        try:
            r, ref_s = readings(cell, control)
        except Exception as e:  # a control that crashes has failed: no number
            if not control:
                raise
            r, ref_s = {"error": f"{type(e).__name__}: {e}"}, None
        del cell
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "kind": "control" if control else "program",
                "reference_s": ref_s, "readings": r}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for k, v in r.items():
            if k == "error":
                continue
            d = least if control else worst
            pick = min if control else max
            d[k] = v if k not in d else pick(d[k], v)
    summary = {"workload": args.workload, "lower": worst, "upper": least,
               "limits": parts["limits"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
