"""Calendar utilities: month-end segmentation and aggregation.

Counterpart of :mod:`csmom_tpu.panel.calendar`.  The segment ids are
sorted, so the per-(asset, month) "last valid day" is a running maximum
(``cummax``) over masked day indices read at each segment's last day, and
a per-segment sum is a difference of prefix sums at the segment bounds —
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


def _segment_bounds(seg_ids, num_segments: int, device):
    """Each sorted segment's first day and one past its last day (equal
    for an empty segment), as int64 tensors on ``device``."""
    seg = np.asarray(seg_ids, dtype=np.int64)
    if seg.size and (np.diff(seg) < 0).any():
        raise ValueError("seg_ids must be nondecreasing")
    k = np.arange(num_segments)
    return (torch.as_tensor(np.searchsorted(seg, k, side="left"), device=device),
            torch.as_tensor(np.searchsorted(seg, k, side="right"), device=device))


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
    # each segment's first and last day (last < first for an empty segment)
    first, end = _segment_bounds(seg_ids, num_segments, dev)
    last = end - 1

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


def segment_sum_panel(values, mask, seg_ids, num_segments: int):
    """Per (asset, month) sum of valid observations (volume aggregation).

    Masked slots contribute 0, as the reference fills missing volume with 0
    before summing.  Each segment's sum is the difference of an inclusive
    prefix sum at its bounds, accumulated in float64 whatever the input
    type (a float32 prefix over decades of daily volumes would lose the
    month in its rounding), then cast back.

    Returns ``f[A, M]`` on ``values``' device (0 for an empty segment).
    """
    first, end = _segment_bounds(seg_ids, num_segments, values.device)
    filled = torch.where(mask, torch.nan_to_num(values), 0.0)
    c = torch.cumsum(filled, dim=1, dtype=torch.float64)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)   # c[:, t] = sum of days < t
    return (c[:, end] - c[:, first]).to(values.dtype)
