"""K1 at the north star under other launch plans and builds: what each
part of the kernel costs.

    python -m csmom_tpu_torch.k1_sweep [--out PATH]

Needs a CUDA card and nvcc.  Compiles ``csrc/decile_partial_sums.cu`` as
it stands (``main``), with the next round's loads issued after this round's adds
(``nopipe``), with 4 assets a round instead of 8 (``unroll4``), with
scalar loads instead of 16-byte ones (``scalar``), and with the
reduction switched off, so that its sums are wrong and ``correct`` says
so: no adds over the asset groups of a block and none over the cluster's
ranks (``noreduce``).  ``main`` runs at the plan that
:func:`~csmom_tpu_torch.ops.kernels._decile_plan` picks and at three other
(lanes, asset groups) splits, the other builds at the plan's only, all on
the monthly engine's K1 inputs (qcut, J = 12, f32).  Each run is held
against the plain version and timed by
:func:`~csmom_tpu_torch.phases.time_kernels`.  Prints the card's name and
power limit, then one JSON object per run; ``--out`` also writes the card
and the runs there as one JSON object.  Shares its build and card helpers
with :mod:`csmom_tpu_torch.k2_sweep`.
"""

from __future__ import annotations

import argparse
import json

from csmom_tpu_torch.k2_sweep import build_variants, card, variant_source
from csmom_tpu_torch.ops import build, kernels

SOURCE = build.SRC_DIR / "decile_partial_sums.cu"
OUT_DIR = build.BUILD_DIR / "k1_sweep"

# name -> (label, source edits (old, new))
_NEXT = "    load_round<T, VEC>(lp, rp, step, i + kUnroll, n, nv, lab[1], r[1]);\n"
_ADD0 = "    add_round<T>(lab[0], r[0], bin0, nbg, slots, nt);\n"
_AFTER = "    load_round<T, VEC>(lp, rp, step, i + 2 * kUnroll, n, nv, lab[0], r[0]);\n"
_ADD1 = "    add_round<T>(lab[1], r[1], bin0, nbg, slots, nt);\n"
VARIANTS = {
    "main": ("as built", []),
    "nopipe": ("next round loaded after the adds",
               [(_NEXT + _ADD0, _ADD0 + _NEXT), (_AFTER + _ADD1, _ADD1 + _AFTER)]),
    "unroll4": ("4 assets a round", [
        ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")]),
    "scalar": ("scalar loads", [
        ("const int vec = M % V == 0 && aligned(labels, 4 * V) && aligned(ret, 16);",
         "const int vec = 0;")]),
    "nowalk": ("no asset read", [
        ("const int n = (a0 < a_hi && m0 < M) ?", "const int n = (a0 < 0 && m0 < M) ?")]),
    "noreduce": ("reduction off", [
        ("for (int gg = 0; gg < groups; ++gg) {", "for (int gg = 0; gg < 1; ++gg) {"),
        ("if (q < C) {\n        acc += ps[q];", "if (q < 1) {\n        acc += ps[q];")]),
}
# (lanes, asset groups, cluster size) beside the plan's own
OTHER_SPLITS = ((4, 32, 8), (16, 16, 8), (4, 16, 8))


def k1_source(name: str) -> str:
    """K1's source with variant ``name``'s edits."""
    return variant_source(SOURCE.read_text(), name, VARIANTS, SOURCE)


def _monthly_inputs():
    """K1's inputs as the monthly engine forms them, qcut, J = 12, f32."""
    import torch

    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.signals.momentum import monthly_returns
    from csmom_tpu_torch.workloads import north_star_month_panel

    pm, mm, _ = north_star_month_panel(device="cuda", dtype=torch.float32)
    labels = monthly_spread_backtest(pm, mm, 12, 1, mode="qcut").labels
    ret, valid = monthly_returns(pm, mm)
    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(valid, -1, dims=1)
    next_valid[:, -1] = False
    next_valid &= labels >= 0
    lab = torch.where(next_valid, labels, -1)
    return torch.where(lab >= 0, torch.nan_to_num(next_ret), 0.0), lab


def sweep():
    """One record per (variant, split) run."""
    import torch

    from csmom_tpu_torch.phases import time_kernels

    entries = build_variants("decile_partial_sums", VARIANTS, OUT_DIR)
    ret, labels = _monthly_inputs()
    A, M = ret.shape
    B = 10
    plain_s, plain_c = kernels.decile_partial_sums_plain(ret, labels, B)
    absum, _ = kernels.decile_partial_sums_plain(ret.abs(), labels, B)
    plan = kernels._decile_plan(A, M, B, ret.element_size())
    splits = ((plan["lanes"], plan["groups"], plan["cluster"]),) + OTHER_SPLITS
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, (label, _) in VARIANTS.items():
        lib, fn = entries[name]
        for lanes, groups, c in splits if name == "main" else splits[:1]:
            gx = c * -(-M // (lanes * plan["v"]))
            smem = kernels._k1_smem(plan["nb"], lanes, groups, 4)
            sums = torch.empty((B, M), device="cuda")
            counts = torch.empty_like(sums)

            def call():
                code = fn(labels.data_ptr(), ret.data_ptr(), sums.data_ptr(),
                          counts.data_ptr(), A, M, B, plan["v"], lanes, groups,
                          plan["nb"], c, gx, plan["grid"][1], smem,
                          ret.device.index or 0, stream)
                build.check(lib, code, f"k1_sweep {name} lanes={lanes} groups={groups}")

            call()
            torch.cuda.synchronize()
            correct = bool(torch.equal(counts, plain_c)) and bool(
                ((sums - plain_s).abs() <= 1e-6 + 1e-5 * absum).all())
            device_ms, per_call = time_kernels(call, ("decile_tile_kernel",))
            # the same call with L2 left clean by the flush, at the plan
            clean_ms = (time_kernels(call, ("decile_tile_kernel",), clean=True)[0]
                        if (lanes, groups, c) == splits[0] else None)
            rows.append({
                "variant": name, "label": label, "lanes": lanes, "groups": groups,
                "cluster": c, "blocks": gx * plan["grid"][1],
                "threads": lanes * groups, "smem": smem,
                "device_ms": device_ms, "kernels_per_call": per_call,
                "clean_l2_device_ms": clean_ms, "correct": correct,
            })
            print(json.dumps(rows[-1]), flush=True)
    # what a library reduction reaching every input byte once takes under
    # the same flush: torch's sums of the returns and of the labels
    floor_ms, per_call = time_kernels(lambda: (ret.sum(), labels.sum()),
                                      ("reduce_kernel",))
    rows.append({"variant": "read_floor", "label": "torch sum of ret and labels",
                 "device_ms": floor_ms, "kernels_per_call": per_call})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = card()
    print(name, flush=True)
    rows = sweep()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": name, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
