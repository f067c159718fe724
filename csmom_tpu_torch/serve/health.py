"""Health and readiness of the serving pool: demonstrated, not declared.

Counterpart of ``csmom_tpu.serve.health``.  Two probes, because they
answer different questions:

- **Liveness** (:func:`liveness`): does the process respond?  A ping
  over the worker's socket with a short timeout.  Failing it means
  restart; it says nothing about whether the worker could serve.
- **Readiness** (:func:`readiness`): may the router send traffic?  The
  worker's own report: every bucket shape warmed, one self-probe
  request per endpoint served through admission → coalesce → dispatch,
  no kernel library built or loaded since the warm snapshot, and a
  matching cache version.

**Cache version** (:func:`aot_cache_version`): the rolling-restart
contract is warm-before-ready, which holds only when the supervisor and
the worker agree on the built world.  The token fingerprints the bucket
grid, the endpoints, the engine parameters, torch's release (read from
package metadata, no import) and the digests of the kernel libraries
the engine launches (``ops/build.py::library_path``: source and nvcc
flags), so an edited ``.cu`` or changed flags read as version skew.  A
worker handed an ``--expect-cache-version`` that does not match its own
refuses to become ready with a pointed message.

**Cold-cache honesty** (:func:`cache_readiness`): on the card, every
engine kernel's library must already exist in ``build.BUILD_DIR``, else
the worker (and the CLI, once, before any spawn) refuses with
``BUILD_POINTER`` instead of building inside what claims to be a ready
probe.  The reference checks serialized XLA executables here; the port
checks kernel libraries (ROADMAP.md, known differences).

No torch import: the supervisor's monitor loop and the stub workers use
this module.
"""

from __future__ import annotations

import hashlib
import json

from csmom_tpu_torch.ops import build
from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve import proto
from csmom_tpu_torch.serve.buckets import bucket_spec
from csmom_tpu_torch.serve.engine import KERNELS

__all__ = ["BUILD_POINTER", "aot_cache_version", "cache_readiness",
           "expected_entry_names", "liveness", "readiness"]

# the remedy every cold or skewed message points at: one string, shared
# with the CLI's cold-cache gate, so the pointer never drifts
BUILD_POINTER = "python -m csmom_tpu_torch.ops.build"


def aot_cache_version(profile: str, *, lookback: int = 12, skip: int = 1,
                      n_bins: int = 10, mode: str = "rank",
                      engine: str = "torch") -> str:
    """Deterministic fingerprint of the built world this pool expects.

    Torch-free: torch's release is read from package metadata and the
    kernels' digests from their sources, so the supervisor stamps a
    version without touching a device.  The token changes iff the
    bucket geometry, the endpoint set, the engine parameters, the torch
    release or a kernel library's source or flags change."""
    spec = bucket_spec(profile)
    try:
        from importlib.metadata import version

        torch_ver = version("torch")
    except Exception:
        torch_ver = "unknown"
    basis = {
        "profile": spec.name,
        "months": spec.months,
        "asset_buckets": list(spec.asset_buckets),
        "batch_buckets": list(spec.batch_buckets),
        "dtype": spec.dtype,
        "endpoints": list(serve_endpoints()),
        "engine_params": {"lookback": lookback, "skip": skip,
                          "n_bins": n_bins, "mode": mode},
        "torch": torch_ver,
        "kernels": {n: build.library_path(n).name for n in KERNELS},
    }
    if engine not in ("torch", "jax"):
        basis["engine"] = engine
    blob = json.dumps(basis, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:12]


def expected_entry_names() -> set:
    """The file names of the kernel libraries the engine launches, as
    ``python -m csmom_tpu_torch.ops.build`` writes them."""
    return {build.library_path(n).name for n in KERNELS}


def cache_readiness() -> tuple:
    """``(ready, reason)``: does every engine kernel's library exist in
    ``build.BUILD_DIR``?  ``reason`` names ``BUILD_POINTER`` when not."""
    missing = sorted(n for n in KERNELS if not build.library_path(n).exists())
    if missing:
        return False, (
            f"cold kernel build: no library of {', '.join(missing)} in "
            f"{build.BUILD_DIR} — build first ({BUILD_POINTER})")
    return True, (f"kernel build check: {', '.join(KERNELS)} built in "
                  f"{build.BUILD_DIR}")


# ---------------------------------------------------------------- probes ---

def liveness(socket_path: str, timeout_s: float = 2.0) -> tuple:
    """``(alive, reason)``: does the worker process answer a ping?"""
    try:
        obj, _ = proto.request_once(socket_path, {"op": "ping"},
                                    timeout_s=timeout_s)
    except (OSError, proto.ProtocolError) as e:
        return False, f"{type(e).__name__}: {e}"
    if obj.get("ok"):
        return True, "pong"
    return False, f"ping answered without ok: {obj}"


def readiness(socket_path: str, timeout_s: float = 5.0) -> dict:
    """The worker's readiness report (see :mod:`csmom_tpu_torch.serve.worker`),
    or a not-ready dict carrying the probe failure as the reason.  The
    report's ``ok`` is the routing decision; the rest is the evidence
    behind it (warm shapes, per-endpoint probe states, fresh builds,
    cache version)."""
    try:
        obj, _ = proto.request_once(socket_path, {"op": "ready"},
                                    timeout_s=timeout_s)
        return obj
    except (OSError, proto.ProtocolError) as e:
        return {"ok": False,
                "reason": f"readiness probe failed: {type(e).__name__}: {e}"}
