"""Panel: the dense masked ``[A, T]`` container, and its hand-off to tensors.

A numpy copy of :class:`csmom_tpu.panel.panel.Panel` (values NaN at masked
slots, a boolean mask, host-side tickers and timestamps) and of its
``PanelBundle``.  This system holds no weights: the panel is its state,
and :func:`to_tensors` (``Panel.tensors``, the counterpart of the
reference's ``Panel.device``) is where host arrays become the port's
tensors on a device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

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

    @property
    def n_assets(self) -> int:
        return self.values.shape[0]

    @property
    def n_times(self) -> int:
        return self.values.shape[1]

    @property
    def shape(self):
        return self.values.shape

    @classmethod
    def from_dense(cls, values, tickers: Sequence[str], times, name: str = "values"):
        """Build from a dense array; the mask is where the values are finite."""
        values = np.asarray(values, dtype=np.float64)
        return cls(values=values, mask=np.isfinite(values), tickers=tuple(tickers),
                   times=np.asarray(times), name=name)

    def tensors(self, device=None, dtype=None):
        """``(values, mask)`` as tensors on ``device``: :func:`to_tensors`
        of this panel (the counterpart of the reference's
        ``Panel.device``).  ``device`` defaults to ``"cuda"`` and raises
        without a card; ``dtype`` defaults to the values' own type."""
        return to_tensors(self.values, self.mask, device=device, dtype=dtype)

    def to_dataframe(self):
        """Wide DataFrame view (tickers x times) for debugging and tables."""
        import pandas as pd

        return pd.DataFrame(np.where(self.mask, self.values, np.nan),
                            index=list(self.tickers), columns=self.times)

    def select_assets(self, keep: Sequence[str]) -> "Panel":
        idx = [self.tickers.index(t) for t in keep]
        return Panel(values=self.values[idx], mask=self.mask[idx],
                     tickers=tuple(keep), times=self.times, name=self.name)

    # A snapshot is one versioned .npz of the dense arrays and axes (the
    # reference's format, so each package reads the other's snapshots).
    _SNAPSHOT_VERSION = 1

    def save(self, path: str) -> str:
        """Write a versioned snapshot (.npz); returns the file's path."""
        np.savez_compressed(
            path,
            __version__=np.int64(self._SNAPSHOT_VERSION),
            values=self.values,
            mask=self.mask,
            tickers=np.asarray(self.tickers, dtype=object),
            times=self.times,
            name=np.asarray(self.name),
        )
        return path if path.endswith(".npz") else path + ".npz"

    @classmethod
    def load(cls, path: str) -> "Panel":
        """Re-read a snapshot; raises on a version newer than this one."""
        with np.load(path, allow_pickle=True) as z:
            ver = int(z["__version__"])
            if ver > cls._SNAPSHOT_VERSION:
                raise ValueError(
                    f"{path}: snapshot version {ver} is newer than this "
                    f"library understands ({cls._SNAPSHOT_VERSION})"
                )
            return cls(values=z["values"], mask=z["mask"],
                       tickers=tuple(z["tickers"].tolist()), times=z["times"],
                       name=str(z["name"]))

    def __repr__(self) -> str:
        a, t = self.shape
        cov = float(self.mask.mean()) if self.mask.size else 0.0
        return f"Panel({self.name!r}, A={a}, T={t}, coverage={cov:.1%})"


@dataclasses.dataclass(frozen=True)
class PanelBundle:
    """Several aligned panels over one (tickers, times) grid: the daily
    bundle's open/high/low/close/adj_close/volume, the intraday bundle's
    price/volume."""

    panels: dict
    tickers: tuple
    times: np.ndarray

    def __getitem__(self, key: str) -> Panel:
        return self.panels[key]

    def __contains__(self, key: str) -> bool:
        return key in self.panels

    @property
    def fields(self):
        return tuple(self.panels)


def to_tensors(values, mask, device=None, dtype=None):
    """Host ``(values, mask)`` arrays -> ``(values f[A, T], mask bool[A, T])``
    tensors on ``device``.

    ``device`` defaults to ``"cuda"`` and raises without a card (pass
    ``device="cpu"`` to run there).  ``dtype`` defaults to the values' own
    float type; a cast happens on the host, before the copy, as the JAX
    package's workload functions cast before ``jnp.asarray``.
    """
    dev = resolve_device(device)
    return _host_to(values, dtype, dev), _host_to(mask, torch.bool, dev)


def _host_to(a, dtype, dev):
    """One host array as a tensor of ``dtype`` on ``dev``.

    For the card the array is read once, cast on the way, into pinned host
    memory, and copied from there.  On the CPU a writable array of the
    right type is shared, as ``torch.from_numpy`` shares it, and anything
    else (a cast, a read-only memmapped pack) is copied once, so no tensor
    aliases a file mapping.
    """
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        # a read-only array (a memmapped pack) is only read, by the copy below
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        src = torch.from_numpy(a)
    want = src.dtype if dtype is None else dtype
    if dev.type == "cpu":
        return src.to(want, copy=not a.flags.writeable)
    staging = torch.empty(a.shape, dtype=want, pin_memory=True)
    staging.copy_(src)
    return staging.to(dev, non_blocking=True)
