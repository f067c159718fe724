"""K2 at the north star under other launch plans and builds: what each
part of the kernel costs.

    python -m csmom_tpu_torch.k2_sweep [--out PATH]

Needs a CUDA card and nvcc.  Compiles ``csrc/cohort_partial_sums.cu`` as
it stands (``main``), with one more staged tile in flight (``more_stages``)
and with one part switched off, so that its sums are wrong and
``correct`` says so: the member sums (``nocompute``), the conversion of
each staged tile into (r, valid) pairs (``noconvert``) and the
``cp.async`` staging (``nostage``).  The first two run at the plan that
:func:`~csmom_tpu_torch.ops.kernels._cohort_plan` picks and at three other
(J group, asset groups) splits, the ablations at the plan's only, all on
the grid engine's K2 inputs (rank mode, f32).  Each run is held against
the plain version and timed by :func:`~csmom_tpu_torch.phases.time_kernels`.
Prints the card's name and power limit, then one JSON object per run;
``--out`` also writes the card and the runs there as one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from csmom_tpu_torch.ops import build, kernels

SOURCE = build.SRC_DIR / "cohort_partial_sums.cu"

_STAGES = f"constexpr int kStages = {kernels._K2_STAGES};"
# name -> (staged tiles in flight, source edits (old, new))
VARIANTS = {
    "main": (kernels._K2_STAGES, []),
    "more_stages": (kernels._K2_STAGES + 1, [
        (_STAGES, f"constexpr int kStages = {kernels._K2_STAGES + 1};")]),
    "nocompute": (kernels._K2_STAGES, [
        ("for (int a = g; lane_live && a < na; a += groups) {",
         "for (int a = g; a < 0; a += groups) {")]),
    "noconvert": (kernels._K2_STAGES, [
        ("u < kTA * kW / kRE; u += blockDim.x) {", "u < 0; u += blockDim.x) {")]),
    "nostage": (kernels._K2_STAGES, [
        ("if (st < n_tiles)\n      stage_tile", "if (st < 0)\n      stage_tile"),
        ("if (nx < n_tiles)\n      stage_tile", "if (nx < 0)\n      stage_tile")]),
}
# (J group, asset groups) beside the plan's own; each fills 256 threads
OTHER_SPLITS = ((2, 2), (1, 8), (4, 2))


def variant_source(src: str, name: str, variants=None, source=None) -> str:
    """A kernel's source with variant ``name``'s edits (K2's by default);
    each edit must match exactly once."""
    variants = VARIANTS if variants is None else variants
    source = SOURCE if source is None else source
    for old, new in variants[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"{source.stem}: variant {name!r} expects {old!r} "
                             f"once in {source.name}, found {src.count(old)}")
        src = src.replace(old, new)
    return src


def build_variants(kernel: str, variants, out_dir):
    """{variant: float32 C entry point} of ``csrc/<kernel>.cu`` under each
    of ``variants``' edits, all compiled at once into ``out_dir``."""
    source = build.SRC_DIR / f"{kernel}.cu"
    src = source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in variants:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, name, variants, source))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{out_dir.name}: nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.csmom_error_string.restype = ctypes.c_char_p
        lib.csmom_error_string.argtypes = [ctypes.c_int]
        fn = getattr(lib, f"csmom_{kernel}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = kernels._ARGTYPES[kernel]
        entries[name] = (lib, fn)
    return entries


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _grid_inputs():
    """K2's inputs as the grid engine forms them, rank mode, f32."""
    import torch

    from csmom_tpu_torch.ops.ranking import decile_assign_panel
    from csmom_tpu_torch.signals.momentum import (
        formation_listed_mask, momentum_dynamic, monthly_returns,
    )
    from csmom_tpu_torch.workloads import GRID_JS, GRID_SKIP, north_star_month_panel

    pm, mm, _ = north_star_month_panel(device="cuda", dtype=torch.float32)
    ret, valid = monthly_returns(pm, mm)
    mom, mv = momentum_dynamic(pm, mm, torch.tensor(GRID_JS, device="cuda"), GRID_SKIP)
    mv = mv & formation_listed_mask(mm, GRID_SKIP)
    labels, _ = decile_assign_panel(torch.where(mv, mom, torch.nan), mv,
                                    n_bins=10, mode="rank")
    return ret, valid, labels


def sweep():
    """One record per (variant, split) run."""
    import torch

    from csmom_tpu_torch.phases import time_kernels

    entries = build_variants("cohort_partial_sums", VARIANTS,
                             build.build_dir() / "k2_sweep")
    ret, valid, labels = _grid_inputs()
    nJ, A, M = labels.shape
    H, B = 12, 10
    plain_s, plain_c = kernels.cohort_partial_sums_plain(ret, valid, labels, B, H)
    absum, _ = kernels.cohort_partial_sums_plain(
        torch.where(valid, torch.nan_to_num(ret), 0.0).abs(), valid, labels, B, H)
    plan = kernels._cohort_plan(nJ, A, M, H, ret.element_size())
    splits = ((plan["jg"], plan["groups"]),) + OTHER_SPLITS
    n_hc = -(-H // plan["hc"])
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, (stages, edits) in VARIANTS.items():
        lib, fn = entries[name]
        ablation = name not in ("main", "more_stages")
        for jg, groups in splits[:1] if ablation else splits:
            grid = (plan["cluster"], plan["grid"][1], -(-nJ // jg) * n_hc)
            smem = kernels._k2_smem(jg, plan["hc"], groups, 4, stages)
            sums = torch.empty((nJ, 2, M, H), device="cuda")
            counts = torch.empty_like(sums)

            def call():
                code = fn(labels.data_ptr(), ret.data_ptr(), valid.data_ptr(),
                          sums.data_ptr(), counts.data_ptr(), nJ, A, M, H, B,
                          plan["ts"], plan["ta"], jg, plan["hc"], groups,
                          plan["cluster"], *grid, smem, ret.device.index or 0,
                          stream)
                build.check(lib, code, f"k2_sweep {name} jg={jg} groups={groups}")

            call()
            torch.cuda.synchronize()
            correct = bool(torch.equal(counts, plain_c)) and bool(
                ((sums - plain_s).abs() <= 1e-6 + 1e-5 * absum).all())
            device_ms, per_call = time_kernels(call, ("cohort_tile_kernel",))
            rows.append({
                "variant": name, "stages": stages, "jg": jg, "groups": groups,
                "cluster": plan["cluster"], "blocks": grid[0] * grid[1] * grid[2],
                "threads": groups * jg * plan["ts"], "smem": smem,
                "device_ms": device_ms, "kernels_per_call": per_call,
                "correct": correct,
            })
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
