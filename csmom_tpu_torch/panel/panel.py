"""Panel: the dense masked ``[A, T]`` container, and its hand-off to tensors.

A numpy copy of :class:`csmom_tpu.panel.panel.Panel` (values NaN at masked
slots, a boolean mask, host-side tickers and timestamps).  This system
holds no weights: the panel is its state, and :func:`to_tensors` is where
host arrays become the port's tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Panel:
    """A dense masked (assets x time) panel.

    Attributes:
      values:  float array ``[A, T]``; NaN at masked slots.
      mask:    bool array ``[A, T]``; True where an observation exists.
      tickers: length-A asset identifiers.
      times:   length-T ``np.datetime64`` timestamps.
      name:    what the values are (e.g. ``"adj_close"``).
    """

    values: np.ndarray
    mask: np.ndarray
    tickers: tuple
    times: np.ndarray
    name: str = "values"

    def __post_init__(self):
        if self.values.shape != self.mask.shape:
            raise ValueError(
                f"values{self.values.shape} and mask{self.mask.shape} differ"
            )
        if self.values.shape[0] != len(self.tickers):
            raise ValueError(
                f"{len(self.tickers)} tickers but A={self.values.shape[0]}"
            )
        if self.values.shape[1] != len(self.times):
            raise ValueError(f"{len(self.times)} times but T={self.values.shape[1]}")


def to_tensors(values, mask, device=None, dtype=None):
    """Host ``(values, mask)`` arrays -> ``(values f[A, T], mask bool[A, T])``
    tensors on ``device``.

    ``device`` defaults to ``"cuda"`` and raises without a card (pass
    ``device="cpu"`` to run there).  ``dtype`` defaults to the values'
    own float type; a cast happens on the host, before the copy, as the
    JAX package's workload functions cast before ``jnp.asarray``.
    """
    dev = resolve_device(device)
    v = torch.from_numpy(np.ascontiguousarray(values))
    if dtype is not None:
        v = v.to(dtype)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool))
    return v.to(dev), m.to(dev)
