"""Canonical hot-path workloads of the warm-up and the benchmarks.

Counterpart of ``csmom_tpu.compile.workloads``.  The grid canon, the
panel sizes, the north-star month-end panel and the golden event inputs
have one source, :mod:`csmom_tpu_torch.workloads`, re-exported here; this
module adds the reference's input builders on top:

- :func:`bench_device`: the device, whether it is the CPU, and the
  profile's float type (f64 on the CPU, f32 on the card), in place of
  the reference's ``bench_platform``;
- :func:`ensure_pack` and :func:`grid_month_inputs`: the grid's
  month-end panels from a synthetic pack on disk, with the measured pack
  read;
- :func:`months_in_days`: the month count of the pack calendar.
"""

from __future__ import annotations

import os
import time

import numpy as np

from csmom_tpu_torch.config import DEFAULT_TICKERS as DEMO_TICKERS
from csmom_tpu_torch.workloads import (
    GRID_JS,
    GRID_KS,
    GRID_SKIP,
    NORTH_STAR_GRID,
    REDUCED_GRID,
    golden_event_inputs,
    month_panel,
    north_star_month_panel,
)

__all__ = [
    "DEMO_TICKERS", "GRID_JS", "GRID_KS", "GRID_SKIP", "NORTH_STAR_GRID",
    "REDUCED_GRID", "REFERENCE_DATA", "bench_device", "ensure_pack",
    "golden_event_inputs", "grid_month_inputs", "month_panel",
    "months_in_days", "north_star_month_panel",
]

# the reference package's default data directory (its 20 tickers' daily
# and intraday caches), or CSMOM_REFERENCE_DATA where that is set
REFERENCE_DATA = os.environ.get(
    "CSMOM_REFERENCE_DATA", os.path.join(os.sep, "root", "reference", "data"))


def bench_device(device=None):
    """``(device, on_cpu, dtype)``: ``device`` resolved (default cuda,
    raising without a card), and the float type of the profiles' panels
    there, f64 on the CPU (oracle-tight) and f32 on the card."""
    import torch

    from csmom_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    return dev, on_cpu, (torch.float64 if on_cpu else torch.float32)


def ensure_pack(A: int, T: int) -> str:
    """Create-if-missing the synthetic daily pack (seed 7, listing gaps)
    under the temporary directory; returns its directory.

    Keyed by ``SYNTH_VERSION`` so a generator edit never serves a stale
    panel; built in a pid-suffixed directory and renamed into place, so a
    concurrent reader never sees half a pack."""
    import shutil
    import tempfile

    from csmom_tpu_torch.panel.pack import save_packed
    from csmom_tpu_torch.panel.synthetic import SYNTH_VERSION, synthetic_daily_panel

    d = os.path.join(tempfile.gettempdir(),
                     f"csmom_torch_pack_s{SYNTH_VERSION}_{A}x{T}_seed7")
    if not os.path.exists(os.path.join(d, "meta.json")):
        tmp = f"{d}.build{os.getpid()}"
        save_packed(synthetic_daily_panel(A, T, seed=7, listing_gaps=True), tmp)
        try:
            os.rename(tmp, d)
        except OSError:  # lost the race: another process's pack is in place
            shutil.rmtree(tmp, ignore_errors=True)
    return d


def grid_month_inputs(A: int, T: int, dtype, device=None):
    """Month-end grid panels from the packed synthetic panel.

    Returns ``(pm, mm, M, pack_ingest_s)``: month-end price and mask
    tensors on ``device`` (default cuda, raising without a card), the
    month count, and the wall of the memmapped pack's read into host
    memory.  Building a cold pack happens before the timed read.
    ``dtype`` is a torch float type.
    """
    from csmom_tpu_torch.device import resolve_device
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.pack import load_packed
    from csmom_tpu_torch.panel.panel import to_tensors

    dev = resolve_device(device)
    pack_dir = ensure_pack(A, T)
    t0 = time.perf_counter()
    panel = load_packed(pack_dir)  # memmap: pages fault in on first touch
    # copy=True reads every page inside the timed window
    host_values = np.array(panel.values, copy=True)
    host_mask = np.array(panel.mask, copy=True)
    pack_ingest_s = time.perf_counter() - t0
    seg, ends = month_end_segments(panel.times)
    v, m = to_tensors(host_values, host_mask, device=dev, dtype=dtype)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    return pm, mm, len(ends), pack_ingest_s


def months_in_days(T: int) -> int:
    """Month count of the synthetic pack calendar for ``T`` business
    days, from the calendar generator the packs use."""
    from csmom_tpu_torch.panel.calendar import month_end_segments
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    times = synthetic_daily_panel(1, T, seed=7).times
    _, ends = month_end_segments(times)
    return len(ends)
