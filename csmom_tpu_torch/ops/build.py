"""Build and load the hand-written CUDA kernels.

    python -m csmom_tpu_torch.ops.build

builds every kernel (the serving tier's cold-cache gate asks for this
before ``serve`` or ``loadgen`` on the card).  Each source
``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries go to
:func:`build_dir`, keyed by a hash of the source and the flags, so an
edited kernel never loads a stale build.  All sources compile in parallel
(one ``nvcc`` each).  Nothing here runs at import time; a missing or
failing ``nvcc`` raises with its output.

**The build directory** is ``$CSMOM_JIT_CACHE`` when that names a path
(the reference's variable for where compiled artifacts persist), else
``build/csmom_tpu_torch/`` at the repository root (:data:`BUILD_DIR`).
The reference's ``CSMOM_JIT_CACHE=0`` switches its executable cache off;
a kernel library must exist to launch, so ``0`` keeps the default
directory here.  The native CSV parser, the warm-up report, the
serving tier's cold-cache gate and the kernel sweeps all read the
directory from :func:`build_dir`.

**Self-heal.** Beside each library ``<name>-<digest>.so`` the build
writes ``<name>-<digest>.so.sha256``, the library's content digest; both
land with ``os.replace``.  :func:`load` checks the library against it
before ``ctypes`` maps the file.  A missing, unreadable or mismatched
digest is corruption: the library and its digest are evicted, rebuilt
and checked again; a second failure raises with the compiler's output
and never falls back to the plain version.  Before evicting, the check
is made once more, so a process that finds a library while another
replaces it evicts nothing good.  :func:`libraries_healed` counts the
heals of this process.

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
# the build directory when CSMOM_JIT_CACHE names none (build_dir)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "csmom_tpu_torch"
CACHE_ENV = "CSMOM_JIT_CACHE"
DIGEST_SUFFIX = ".sha256"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("decile_partial_sums", "cohort_partial_sums", "rank_labels")

_LIBS: dict = {}
# reentrant: load() builds under it, and build() counts under it
_LOCK = threading.RLock()
# libraries compiled or loaded by this process ("events",
# libraries_built_or_loaded) and compiled by it ("built",
# libraries_built), counted under _LOCK: shard threads and batch scorers
# reach build() and load() through the kernel wrappers
_COUNTS = {"events": 0, "built": 0}
# libraries evicted as corrupt and rebuilt by this process (libraries_healed)
_HEALED: list = []


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


def build_dir() -> Path:
    """Where kernel libraries are built and looked for: ``$CSMOM_JIT_CACHE``
    when it names a path, else :data:`BUILD_DIR`.  Read at every call, so
    a process may point it elsewhere before its first build."""
    configured = os.environ.get(CACHE_ENV, "")
    if configured in ("", "0"):
        return BUILD_DIR
    return Path(os.path.abspath(configured))


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def digest_path(lib: Path) -> Path:
    """The file holding ``lib``'s content sha256."""
    return lib.with_name(lib.name + DIGEST_SUFFIX)


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def intact(lib: Path) -> bool:
    """True when ``lib`` and its digest file are readable and agree."""
    try:
        return _sha256(lib) == digest_path(lib).read_text().strip()
    except (OSError, UnicodeDecodeError):
        return False


def libraries_built_or_loaded() -> int:
    """How many kernel libraries this process has compiled plus how many
    it has loaded, so far; a load from an existing build counts once, a
    fresh build twice (compiled, then loaded)."""
    return _COUNTS["events"]


def libraries_built() -> int:
    """How many kernel libraries this process has compiled (fresh
    builds only; a load of an existing build does not count)."""
    return _COUNTS["built"]


def libraries_healed() -> list:
    """The kernels whose library this process found corrupt, evicted and
    rebuilt, in the order of the heals."""
    return list(_HEALED)


def build(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, all at once.

    Returns ``{name: nvcc's output}`` for the kernels compiled by this
    call (the ``-Xptxas -v`` register and shared-memory report); raises
    ``RuntimeError`` with the compiler's output if any build fails.  Each
    library lands after its digest file, both with ``os.replace``.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
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
            lib = library_path(n)
            sha = digest_path(lib).with_suffix(f".{os.getpid()}.tmp")
            sha.write_text(_sha256(tmp) + "\n")
            # the digest first: a reader that finds the library finds its
            # digest (atomic: never a half-written .so)
            os.replace(sha, digest_path(lib))
            os.replace(tmp, lib)
            with _LOCK:
                _COUNTS["events"] += 1
                _COUNTS["built"] += 1
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _evict(lib: Path) -> None:
    for p in (lib, digest_path(lib)):
        p.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, and
    checked against its digest before it is mapped (a corrupt one is
    evicted and rebuilt, see the module docstring)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            path = library_path(name)
            # a failed check is made once more before evicting: another
            # process may have been between its two os.replace calls
            if not intact(path) and not intact(path):
                _evict(path)
                logs = build((name,))
                if not intact(path):
                    raise RuntimeError(
                        f"{name}: the library rebuilt after a corrupt one was "
                        f"evicted fails its digest check ({path}); nvcc "
                        "said:\n" + logs.get(name, "(nothing)"))
                _HEALED.append(name)
            lib = ctypes.CDLL(str(path))
            lib.csmom_error_string.restype = ctypes.c_char_p
            lib.csmom_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
            _COUNTS["events"] += 1
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.csmom_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


if __name__ == "__main__":
    for _name, _log in build().items():
        print(f"built {_name} -> {library_path(_name)}")
    print(f"every kernel is built in {build_dir()}")
