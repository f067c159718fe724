"""Calendar utilities: month-end segmentation and aggregation.

Counterpart of :mod:`csmom_tpu.panel.calendar`.  The segment ids are
sorted, so the per-(asset, month) "last valid day" is a running maximum
(``cummax``) over masked day indices read at each segment's last day —
no scatter, hence no order-dependent float reduction anywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def month_end_segments(times: np.ndarray):
    """Host-side: map daily timestamps -> (segment_ids, month_end_times).

    Returns:
      seg_ids:  int32[T_daily], 0..M-1, nondecreasing — month index per day.
      month_ends: datetime64[M] calendar month-end stamps (pandas 'ME' labels).
    """
    t = np.asarray(times, dtype="datetime64[D]")
    if t.size and (np.diff(t.view("int64")) < 0).any():
        raise ValueError("times must be nondecreasing (month segments are "
                         "read off a running maximum over sorted days)")
    months = t.astype("datetime64[M]")
    uniq, seg_ids = np.unique(months, return_inverse=True)
    month_ends = (uniq + 1).astype("datetime64[D]") - np.timedelta64(1, "D")
    return seg_ids.astype(np.int32), month_ends.astype("datetime64[ns]")


def month_end_aggregate(values, mask, seg_ids, num_segments: int):
    """Per (asset, month): the last valid observation and whether any exists.

    Args:
      values: f[A, T] daily panel (NaN at masked slots).
      mask:   bool[A, T].
      seg_ids: int[T] nondecreasing month index per day (host array, from
        :func:`month_end_segments`).
      num_segments: M.

    Returns:
      (last_vals f[A, M], any_mask bool[A, M]) on ``values``' device.
    """
    dev = values.device
    A, T = values.shape
    seg = np.asarray(seg_ids, dtype=np.int64)
    if seg.size and (np.diff(seg) < 0).any():
        raise ValueError("seg_ids must be nondecreasing")
    k = np.arange(num_segments)
    # each segment's first and last day (last < first for an empty segment)
    first = torch.as_tensor(np.searchsorted(seg, k, side="left"), device=dev)
    last = torch.as_tensor(np.searchsorted(seg, k, side="right") - 1, device=dev)

    day_idx = torch.arange(T, device=dev)
    masked_idx = torch.where(mask, day_idx, -1)
    # last valid day at or before each day
    run_max = torch.cummax(masked_idx, dim=1).values
    last_idx = run_max[:, last.clamp(0, max(T - 1, 0))]
    any_mask = (last_idx >= first) & (last >= first)
    gather_idx = last_idx.clamp(0, max(T - 1, 0))
    last_vals = torch.gather(values, 1, gather_idx)
    last_vals = torch.where(any_mask, last_vals, torch.nan)
    return last_vals, any_mask
