"""Miniature capture child: the capture *path* without the bench *workload*.

Counterpart of ``csmom_tpu.chaos.minibench``, copied.  ``python -m
csmom_tpu_torch.chaos.minibench`` plays the role of a measurement
process (a bench child) in milliseconds: it arms the same
:func:`~csmom_tpu_torch.utils.deadline.deadline_guard`, "measures" N
rows with a ``mini.row`` checkpoint between them, mirrors every measured
row into a progress sidecar file (the ground truth a rehearsal compares
artifacts against: a row in the sidecar but not in the landed artifact
is a lost measurement), and ends with one trailing JSON line through the
guard's single-write emit path.

The deadline, trailing-JSON and landing invariants are properties of the
capture plumbing, not of the workload being measured, so ``rehearse``'s
``mini`` tier rehearses them in under a second a fault with no torch
import, while its ``bench`` tiers drive :mod:`csmom_tpu_torch.bench`.

Env contract (mirrors the bench child's):

- ``CSMOM_MINIBENCH_BUDGET``  wall budget (s) for the deadline guard
- ``CSMOM_MINIBENCH_ROWS``    rows to measure (default 5)
- ``CSMOM_MINIBENCH_ROW_S``   simulated wall per row (default 0.01)
- ``CSMOM_MINIBENCH_SIDECAR`` path for the progress sidecar (JSON lines)
- ``CSMOM_MINIBENCH_MIN_DELAY`` the guard's earliest fire (s, default 30)
- ``CSMOM_FAULT_PLAN``        the armed fault plan, as everywhere
"""

from __future__ import annotations

import json
import os
import sys
import time

_T0 = time.monotonic()


def main() -> int:
    from csmom_tpu_torch.chaos.inject import checkpoint
    from csmom_tpu_torch.obs import arm_from_env
    from csmom_tpu_torch.utils.deadline import deadline_guard

    # join an armed telemetry stream (CSMOM_TELEMETRY): every checkpoint
    # below then doubles as a timeline point, as in the bench child
    arm_from_env("minibench")

    n_rows = int(os.environ.get("CSMOM_MINIBENCH_ROWS", "5"))
    row_s = float(os.environ.get("CSMOM_MINIBENCH_ROW_S", "0.01"))
    sidecar = os.environ.get("CSMOM_MINIBENCH_SIDECAR", "")

    rows: list = []

    def record_row(row: dict) -> None:
        rows.append(row)
        if sidecar:  # ground truth: appended the instant a row is measured
            with open(sidecar, "a") as f:
                f.write(json.dumps(row) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def partial_line():
        if not rows:
            return None  # nothing measured: no artifact-worthy line
        return json.dumps({
            "metric": "minibench_rows_per_sec",
            "value": round(rows[-1]["value"], 4),
            "unit": "rows/s",
            "vs_baseline": 1.0,
            "extra": {
                "rows": rows,
                "partial": "minibench deadline hit before every row "
                           "completed; unmeasured rows are absent",
            },
        })

    finish = deadline_guard(
        "CSMOM_MINIBENCH_BUDGET", partial_line, t0=_T0,
        min_delay_s=float(os.environ.get("CSMOM_MINIBENCH_MIN_DELAY", "30")),
    )

    checkpoint("mini.start")
    for i in range(n_rows):
        checkpoint("mini.row", row=i)
        t0 = time.perf_counter()
        # the "measurement": a deterministic spin standing in for a timed leg
        acc = 0.0
        k = 0
        while time.perf_counter() - t0 < row_s:
            acc += (k % 97) * 1e-9
            k += 1
        record_row({"row": i, "value": 1.0 / max(row_s, 1e-9),
                    "wall_s": round(time.perf_counter() - t0, 6)})
        print(f"row {i} done wall={rows[-1]['wall_s']}s", flush=(i % 2 == 0))

    checkpoint("mini.finish")
    finish(json.dumps({
        "metric": "minibench_rows_per_sec",
        "value": round(rows[-1]["value"], 4),
        "unit": "rows/s",
        "vs_baseline": 1.0,
        "extra": {"rows": rows, "n_rows": len(rows)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
