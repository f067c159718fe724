"""The native CSV row parser (``fastcsv.cpp``), built with ``g++`` at first
use and bound with ``ctypes``.

Counterpart of :mod:`csmom_tpu.native`, with its own copy of the source.
The library goes to ``build/csmom_tpu_torch/`` at the repository root (the
CUDA kernels' build directory), keyed by a hash of the source and the
flags.  When no compiler is there or the build fails,
:func:`parse_price_csv_native` returns None and the ingest parses with
pandas instead, as the reference does; :func:`available` says which of the
two a caller gets, and ``parse_price_csv_native.files`` counts the files
the native parser has read.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "csmom_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_STATE: dict = {}   # "lib": the loaded library, or None once a build failed


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"fastcsv-{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        log.warning("native CSV parser build failed (%s); using the pandas "
                    "ingest", e)
        return None
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def get_lib():
    """The loaded library (built first if needed); None when it cannot be
    built."""
    with _LOCK:
        if "lib" not in _STATE:
            path = _build()
            lib = None
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.fastcsv_count_rows.argtypes = [ctypes.c_char_p]
                lib.fastcsv_count_rows.restype = ctypes.c_longlong
                lib.fastcsv_parse.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_longlong,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_double),
                ]
                lib.fastcsv_parse.restype = ctypes.c_longlong
            _STATE["lib"] = lib
        return _STATE["lib"]


def available() -> bool:
    """True when the native parser is built and loaded (building it now if
    it was not tried yet); False means the ingest parses with pandas."""
    return get_lib() is not None


def parse_price_csv_native(path: str, n_cols: int):
    """Parse a price CSV's data rows natively.

    Returns ``(epoch_ns i64[R], values f64[R, n_cols])``, or None when the
    native library is unavailable (the caller parses with pandas then).
    Preamble and junk rows (both cache dialects) are skipped by the same
    first-cell-is-a-date rule as ``panel.ingest.read_price_csv``.
    """
    lib = get_lib()
    if lib is None:
        return None
    cap = lib.fastcsv_count_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    cap = max(int(cap), 1)
    epochs = np.empty(cap, dtype=np.int64)
    values = np.empty((cap, n_cols), dtype=np.float64)
    rows = lib.fastcsv_parse(
        path.encode(),
        cap,
        n_cols,
        epochs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rows < 0:
        raise OSError(f"native parse failed for {path}")
    parse_price_csv_native.files += 1
    return epochs[:rows], values[:rows]


parse_price_csv_native.files = 0
