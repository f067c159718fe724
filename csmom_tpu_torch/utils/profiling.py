"""Timing and profiling utilities.

Counterpart of ``csmom_tpu.utils.profiling``, with its names:

- :func:`wall` times a call correctly: CUDA launches are asynchronous,
  so the clock is read only after the device has finished
  (``torch.cuda.synchronize``);
- :func:`fetch` synchronizes and copies a result to the host as numpy;
  :func:`measure_rtt` is the round trip of a scalar operation on the
  card, the floor under any fetched wall;
- :func:`trace` logs the wall of a block under a label and, given a
  directory, writes a ``torch.profiler`` trace of it there;
- :func:`compile_stats` and :func:`count_dispatches` are the warm-up's
  accounting.  Eager torch compiles nothing per shape, so the counters
  are the kernel libraries built or loaded (:mod:`csmom_tpu_torch.ops.build`),
  and a dispatch is a CUDA kernel launch read from a profiler trace
  (ROADMAP.md, known differences).

torch is imported inside the functions, so importing this module loads
neither torch nor a kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from csmom_tpu_torch.utils.logging import get_logger

__all__ = ["CompileStats", "PEAK_HBM_GBPS", "compile_stats",
           "count_dispatches", "fetch", "measure_rtt", "sync", "trace",
           "wall"]

log = get_logger("profiling")

# peak HBM bandwidth by torch.cuda.get_device_name, GB/s: the vendor's
# figure for the card the port targets (the roofline denominator of the
# bounds in PERF.md)
PEAK_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
# idle seconds at each end of a count_dispatches trace
_TRACE_MARGIN_S = 0.05


def sync() -> None:
    """Wait for every launch on the card, when this process uses one."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def wall(fn, *args, warmup: int = 0, **kwargs):
    """Run ``fn(*args, **kwargs)`` and wait for the device; return
    ``(result, seconds)``.  ``warmup`` extra untimed calls first."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync()
    return out, time.perf_counter() - t0


def fetch(y):
    """``y`` on the host as a numpy array, after the device finished.

    Use inside timed loops: the copy to the host includes the work that
    produced ``y``.  Reduce to a scalar first so the copy is negligible."""
    import numpy as np
    import torch

    sync()
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def measure_rtt(dtype=None, reps: int = 10, device=None) -> float:
    """Per-call floor of ``fetch``-timed walls: one scalar operation on
    ``device`` (default cuda, raising without a card) and its copy back,
    in seconds (mean over ``reps`` after one untimed call)."""
    import torch

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    s = torch.zeros((), dtype=dtype or torch.float32, device=dev)
    fetch(s + 1.0)
    t0 = time.perf_counter()
    for _ in range(reps):
        fetch(s + 1.0)
    return (time.perf_counter() - t0) / reps


@dataclasses.dataclass(frozen=True)
class CompileStats:
    """Snapshot of the process's kernel-library counters (monotone)."""

    libraries_built_or_loaded: int
    libraries_built: int

    def delta(self, since: "CompileStats") -> "CompileStats":
        return CompileStats(*(getattr(self, f.name) - getattr(since, f.name)
                              for f in dataclasses.fields(self)))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def compile_stats() -> CompileStats:
    """The kernel libraries this process has built or loaded, and built
    (:func:`~csmom_tpu_torch.ops.build.libraries_built_or_loaded`,
    :func:`~csmom_tpu_torch.ops.build.libraries_built`)."""
    from csmom_tpu_torch.ops import build

    return CompileStats(build.libraries_built_or_loaded(),
                        build.libraries_built())


@contextlib.contextmanager
def count_dispatches():
    """Count the CUDA kernel launches of the block.

    Yields a dict whose ``"dispatches"`` key is filled on exit: the
    kernels (copies and fills aside) that a ``torch.profiler`` trace of
    the block saw on the card.  Needs a card: on a machine without one it
    raises, naming ``device="cuda"``.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError(
            "count_dispatches counts CUDA kernel launches and needs a card: "
            'run the block with device="cuda" on a machine with one')
    box: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins keep the block away from the trace's edges, where
        # device records can be dropped (as phases.time_kernels does)
        time.sleep(_TRACE_MARGIN_S)
        yield box
        torch.cuda.synchronize()
        time.sleep(_TRACE_MARGIN_S)
    box["dispatches"] = sum(
        1 for evt in prof.events()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and not evt.name.startswith(("Memcpy", "Memset")))


@contextlib.contextmanager
def trace(label: str, out_dir: str | None = None):
    """Time (and, with ``out_dir``, profile) a block.

    With ``out_dir`` the block runs under ``torch.profiler`` and its
    Chrome trace lands in ``<out_dir>/<label>.json``; without, this is a
    labelled wall timer.  The wall is read after the device finished."""
    import os

    if out_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        ctx = profile(activities=acts)
    else:
        ctx = contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx as prof:
        yield
        sync()
    dt = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{label}.json"))
    log.info("%s: %.4fs%s", label, dt, f" (trace -> {out_dir})" if out_dir else "")
