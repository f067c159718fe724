"""The yardstick of the roofline metrics: the card's published peaks and the
bytes and operations that each measured piece of work needs, computed from
its inputs' shapes.  A byte is counted once for each input read and each
output written, whatever the program reads again.
"""

from __future__ import annotations

import numpy as np

# published peaks of the SXM part at its 700 W limit (NVIDIA's data sheet):
# HBM3 bytes/s and float32 FLOP/s outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12},
}


def peaks(kind: str):
    """The peak table row of a device name, or None for a card without one."""
    return PEAKS.get(kind)


def k2_bound_inputs(labels_shape, members, ret_itemsize: int, H: int):
    """(bytes, operations) that K2 (cohort partial sums) must move and do:
    each input read once (labels int32 ``[nJ, A, M]``, returns ``[A, M]``,
    their validity bool ``[A, M]``) and both outputs (sums and counts
    ``[nJ, 2, M, H]``) written once; two adds per (member, horizon inside
    the panel).  ``members[s]`` counts the (J, asset) pairs in the bottom
    or top bin at formation month s."""
    nJ, A, M = labels_shape
    out_bytes = 2 * nJ * 2 * M * H * ret_itemsize
    nbytes = nJ * A * M * 4 + A * M * ret_itemsize + A * M + out_bytes
    horizons = (M - 1 - np.arange(M)).clip(0, H)
    ops = 2 * int((np.asarray(members, dtype=np.int64) * horizons).sum())
    return nbytes, ops


def bound_s(nbytes: int, ops: int, kind: str):
    """The least time the work could take on the card: the longer of bytes
    over the memory rate and operations over the float32 peak; None for a
    card without a peak row."""
    p = peaks(kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["f32_flops"])


def event_bytes(A: int, T: int, itemsize: int) -> int:
    """Bytes one event backtest with its cost attribution must move: the
    price, validity and score panels and the two per-name maps read once;
    positions (int32), trade sides (int8) and fill prices ``[A, T]``, the
    per-bar PnL, bar mask, portfolio value and cash ``[T]``, the per-name
    impact and the scalar totals written once."""
    inputs = A * T * (2 * itemsize + 1) + 2 * A * itemsize
    outputs = A * T * (4 + 1 + itemsize) + T * (3 * itemsize + 1) + A * itemsize
    scalars = 14 * itemsize
    return inputs + outputs + scalars
