"""Packed binary panel cache: the at-scale data path.

A copy of :mod:`csmom_tpu.panel.pack`, on the same layout (version 1), so
each package reads the other's packs.  The per-ticker CSV cache is
re-parsed from text on every run: fine at 20 tickers x 1,760 bars,
hopeless at the north-star 3,000 x 15,120.  A pack writes the dense
``[A, T]`` arrays once as raw ``.npy`` (one file per field) beside a small
JSON manifest, and re-reads them with numpy memory mapping, so a load
touches pages only as they are read.  (``np.load`` cannot memory-map the
members of an ``.npz``, which is why this is a directory and not the
compressed ``Panel.save`` snapshot.)

Layout (version 1)::

    <dir>/
      meta.json          {"version": 1, "tickers": [...], "fields": [...],
                          "times_dtype": "datetime64[ns]"}
      times.npy          i64[T] (datetime64 ticks, dtype in meta)
      <field>.values.npy f32/f64[A, T] per field, NaN at masked slots
      <field>.mask.npy   bool[A, T]

Masks are stored explicitly (not re-derived from NaN), so a pack of a
non-float field or an all-finite panel with invalid lanes round-trips
exactly.
"""

from __future__ import annotations

import json
import os

import numpy as np

from csmom_tpu_torch.panel.panel import Panel, PanelBundle

_PACK_VERSION = 1


def is_packed(path: str) -> bool:
    """True iff ``path`` is a packed panel directory (manifest present).

    The one place pack detection lives: the API and every CLI surface that
    accepts a pack as ``--data-dir`` route through this, so a future layout
    change cannot diverge between them.
    """
    return os.path.isfile(os.path.join(path, "meta.json"))


def save_packed(obj, path: str) -> str:
    """Write a :class:`Panel` or :class:`PanelBundle` as a packed directory.

    Overwrites field files already present; returns ``path``.
    """
    panels = obj.panels if isinstance(obj, PanelBundle) else {obj.name: obj}
    if not panels:
        raise ValueError("nothing to pack: empty bundle")
    first = next(iter(panels.values()))
    os.makedirs(path, exist_ok=True)
    times = np.asarray(first.times)
    np.save(os.path.join(path, "times.npy"), times.view("i8"))
    for field, p in panels.items():
        if not np.array_equal(np.asarray(p.times), times):
            raise ValueError(f"field {field!r} is not on the shared calendar")
        if tuple(p.tickers) != tuple(first.tickers):
            raise ValueError(f"field {field!r} is not on the shared tickers")
        np.save(os.path.join(path, f"{field}.values.npy"), p.values)
        np.save(os.path.join(path, f"{field}.mask.npy"), p.mask)
    meta = {
        "version": _PACK_VERSION,
        "tickers": list(first.tickers),
        "fields": sorted(panels),
        "times_dtype": str(times.dtype),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    # Re-packing over an existing directory with fewer fields must not leave
    # the old fields' arrays orphaned: load_packed is meta-driven so they are
    # invisible to it, but they inflate the pack's on-disk size and mislead a
    # plain dir listing.  Meta is written first, so a crash here
    # leaves a correct pack plus removable orphans, never a broken manifest.
    keep = {"times.npy", "meta.json"} | {
        f"{f}.{kind}.npy" for f in panels for kind in ("values", "mask")
    }
    for name in os.listdir(path):
        if name not in keep and (
            name.endswith(".values.npy") or name.endswith(".mask.npy")
        ):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass  # a vanished/locked orphan is harmless
    return path


def load_packed(path: str, mmap: bool = True):
    """Re-open a packed directory.

    Returns a :class:`Panel` when the pack holds one field, else a
    :class:`PanelBundle`.  With ``mmap=True`` (default) the arrays are
    ``np.memmap`` views — pages fault in as they are read, so opening a
    north-star-sized pack is O(metadata); ``Panel.tensors()`` reads them
    once into pinned host memory and copies them to the card.  Unknown
    versions fail loudly: an unreadable cache must never quietly shrink
    the universe.
    """
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ver = int(meta.get("version", -1))
    if ver > _PACK_VERSION or ver < 1:
        raise ValueError(
            f"{path}: pack version {ver} is not understood by this library "
            f"(supports 1..{_PACK_VERSION}) — refusing to guess at the layout"
        )
    mode = "r" if mmap else None
    times = np.load(os.path.join(path, "times.npy"), mmap_mode=None)
    times = times.view(meta["times_dtype"])
    tickers = tuple(meta["tickers"])
    panels = {}
    for field in meta["fields"]:
        values = np.load(os.path.join(path, f"{field}.values.npy"), mmap_mode=mode)
        mask = np.load(os.path.join(path, f"{field}.mask.npy"), mmap_mode=mode)
        panels[field] = Panel(
            values=values, mask=mask, tickers=tickers, times=times, name=field
        )
    if len(panels) == 1:
        return next(iter(panels.values()))
    return PanelBundle(panels=panels, tickers=tickers, times=times)


def pack_csv_cache(data_dir: str, tickers, out: str,
                   fields=("adj_close", "volume"), df=None,
                   dtype=None) -> str:
    """One-shot CSV cache -> packed directory conversion (the JAX CLI's
    ``csmom fetch --pack``): load the per-ticker daily CSVs through the normal ingest
    path, pivot each requested field to a dense panel, write the pack.

    Pass ``df`` (the canonical long daily frame) when the caller already
    holds it — ``csmom fetch`` does — so the CSVs are not re-parsed; that
    double parse is the exact cost this format exists to eliminate.
    ``dtype`` (e.g. ``np.float32``) downcasts the stored values — at
    north-star scale f32 halves the pack and matches the engines' f32
    runs; the default keeps the ingest's f64.
    """
    import dataclasses

    from csmom_tpu_torch.panel.ingest import load_daily, long_to_panel

    if df is None:
        df = load_daily(data_dir, list(tickers))
    if df.empty:
        raise ValueError(f"no readable daily caches for {len(tickers)} "
                         f"tickers under {data_dir}")
    panels = {f: long_to_panel(df, f) for f in fields}
    if dtype is not None:
        panels = {
            f: dataclasses.replace(p, values=p.values.astype(dtype))
            for f, p in panels.items()
        }
    first = next(iter(panels.values()))
    return save_packed(
        PanelBundle(panels=panels, tickers=tuple(first.tickers),
                    times=np.asarray(first.times)),
        out,
    )
