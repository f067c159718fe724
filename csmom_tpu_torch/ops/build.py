"""Build and load the hand-written CUDA kernels.

    python -m csmom_tpu_torch.ops.build

builds every kernel (the serving tier's cold-cache gate asks for this
before ``serve`` or ``loadgen`` on the card).  Each source
``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries go to
``build/csmom_tpu_torch/`` at the repository root, keyed by a hash of the
source and the flags, so an edited kernel never loads a stale build.  All
sources compile in parallel (one ``nvcc`` each).  Nothing here runs at
import time; a missing or failing ``nvcc`` raises with its output.

:func:`libraries_built_or_loaded` counts, over the process's life, each
library compiled and each library loaded: the serving tier's
in-window build count (``TorchEngine.fresh_compiles``) is its change
since the engine warmed.  :func:`libraries_built` counts the fresh
builds alone, which the warm-up (``compile/aot.py``) reports per entry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "csmom_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("decile_partial_sums", "cohort_partial_sums")

_LIBS: dict = {}
_LOCK = threading.Lock()
# libraries compiled or loaded by this process (libraries_built_or_loaded)
_EVENTS = 0
# libraries compiled by this process (libraries_built)
_BUILT = 0


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def libraries_built_or_loaded() -> int:
    """How many kernel libraries this process has compiled plus how many
    it has loaded, so far; a load from an existing build counts once, a
    fresh build twice (compiled, then loaded)."""
    return _EVENTS


def libraries_built() -> int:
    """How many kernel libraries this process has compiled (fresh
    builds only; a load of an existing build does not count)."""
    return _BUILT


def build(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, all at once.

    Returns ``{name: nvcc's output}`` for the kernels compiled by this
    call (the ``-Xptxas -v`` register and shared-memory report); raises
    ``RuntimeError`` with the compiler's output if any build fails.
    """
    global _EVENTS, _BUILT
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))  # atomic: never a half-written .so
            _EVENTS += 1
            _BUILT += 1
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    global _EVENTS
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.csmom_error_string.restype = ctypes.c_char_p
            lib.csmom_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
            _EVENTS += 1
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.csmom_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


if __name__ == "__main__":
    for _name, _log in build().items():
        print(f"built {_name} -> {library_path(_name)}")
    print(f"every kernel is built in {BUILD_DIR}")
