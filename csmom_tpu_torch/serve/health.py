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
flags), so an edited ``.cu`` or changed flags read as version skew.  The
mesh engine's token also carries its device count (``mesh_devices``, the
worker's pinned slice size): a pool resized without a new deploy reads
as skew.  A worker handed an ``--expect-cache-version`` that does not
match its own refuses to become ready with a pointed message.

**Cold-cache honesty** (:func:`cache_readiness`): on the card, every
engine kernel's library must already exist in ``build.BUILD_DIR``, else
the worker (and the CLI, once, before any spawn) refuses with
``BUILD_POINTER`` instead of building inside what claims to be a ready
probe.  The reference checks serialized XLA executables here; the port
checks kernel libraries (ROADMAP.md, known differences).  Given a
profile, the reason also says how many of the profile's warm-up entries
(:func:`expected_entry_names`, the mesh profile's with ``mesh_devices``)
the warm-up report under ``cache_subdir`` covers: evidence, not a gate,
since eager torch builds nothing per shape and the worker warms every
shape itself before it is ready.

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
from csmom_tpu_torch.serve.engine import ENGINE_ALIASES, KERNELS

__all__ = ["BUILD_POINTER", "aot_cache_version", "cache_readiness",
           "expected_entry_names", "liveness", "mesh_devices_of",
           "readiness"]

# the remedy every cold or skewed message points at: one string, shared
# with the CLI's cold-cache gate, so the pointer never drifts
BUILD_POINTER = "python -m csmom_tpu_torch.ops.build"


def aot_cache_version(profile: str, *, lookback: int = 12, skip: int = 1,
                      n_bins: int = 10, mode: str = "rank",
                      engine: str = "torch",
                      mesh_devices: int | None = None) -> str:
    """Deterministic fingerprint of the built world this pool expects.

    Torch-free: torch's release is read from package metadata and the
    kernels' digests from their sources, so the supervisor stamps a
    version without touching a device.  The token changes iff the
    bucket geometry, the endpoint set, the engine parameters, the torch
    release, a kernel library's source or flags, or the mesh engine's
    device count (``mesh_devices``) change.  The reference's engine
    names (``jax``, ``jax-mesh``) give the port's engines' tokens."""
    engine = ENGINE_ALIASES.get(engine, engine)
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
    if engine != "torch":
        basis["engine"] = engine
    if mesh_devices is not None:
        basis["mesh_devices"] = int(mesh_devices)
    blob = json.dumps(basis, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:12]


def mesh_devices_of(engine: str, device: str, pinned: int | None = None):
    """The device count a mesh engine meshes, which its version token
    carries: the pinned slice's count, else one logical shard of a
    single ``device`` (``cpu``, ``cuda:0``), else every visible card
    (``cuda``: counted without creating a CUDA context).  None for the
    other engines."""
    if ENGINE_ALIASES.get(engine, engine) != "torch-mesh":
        return None
    if pinned:
        return pinned
    if device != "cuda":
        return 1
    import torch

    return torch.cuda.device_count()


def expected_entry_names(profile: str | None = None,
                         mesh_devices: int | None = None) -> set:
    """With no profile: the file names of the kernel libraries the engine
    launches, as ``python -m csmom_tpu_torch.ops.build`` writes them.

    With a bucket profile (``serve``, ``serve-smoke``): the warm-up
    entry names of its serve grid, ``serve.{kind}.b{B}@{A}x{M}``, or
    with ``mesh_devices`` those of its mesh grid,
    ``mesh.serve.{kind}.b{B}@{A}x{M}.d{n}`` with ``n`` each shape's
    shard count, and the scaling probe's single-device entry; from the
    bucket geometry, :func:`~csmom_tpu_torch.mesh.pinning.shards_for` and
    the placement rule (:func:`~csmom_tpu_torch.mesh.rules.serve_axis_for`)
    alone, with no torch import."""
    if profile is None:
        return {build.library_path(n).name for n in KERNELS}
    spec = bucket_spec(profile)
    if mesh_devices is None:
        return {f"serve.{kind}.b{B}@{A}x{M}"
                for kind in serve_endpoints() for B, A, M in spec.shapes()}
    from csmom_tpu_torch.mesh.pinning import shards_for
    from csmom_tpu_torch.mesh.rules import serve_axis_for

    out = set()
    for kind in serve_endpoints():
        axis = serve_axis_for(kind)
        for B, A, M in spec.shapes():
            n = shards_for(B if axis == "batch" else A, mesh_devices)
            out.add(f"mesh.serve.{kind}.b{B}@{A}x{M}.d{n}")
    out.add(f"mesh.serve.single-probe.{serve_endpoints()[0]}."
            f"b{spec.batch_buckets[-1]}@{spec.max_assets}x{spec.months}")
    return out


def _report_coverage(profile: str, cache_subdir: str,
                     mesh_devices: int | None) -> str:
    """How many of the profile's expected entries the warm-up report
    under ``cache_subdir`` lists without an error, as a sentence."""
    from csmom_tpu_torch.compile.aot import read_warmup_report

    expected = expected_entry_names(profile, mesh_devices)
    report = read_warmup_report(cache_subdir)
    if isinstance(report, str):
        return f"no warm-up report in {cache_subdir!r} ({report})"
    warmed = {e.get("name") for e in report.get("entries") or []
              if isinstance(e, dict) and not e.get("error")}
    return (f"the warm-up report in {cache_subdir!r} covers "
            f"{len(expected & warmed)} of the {len(expected)} entries of "
            f"{'mesh ' if mesh_devices is not None else ''}profile "
            f"{profile!r}" + (f" on d{mesh_devices}"
                              if mesh_devices is not None else ""))


def cache_readiness(profile: str | None = None, cache_subdir: str = "bench",
                    mesh_devices: int | None = None) -> tuple:
    """``(ready, reason)``: does every engine kernel's library exist in
    ``build.BUILD_DIR``?  ``reason`` names ``BUILD_POINTER`` when not,
    and given a bucket ``profile`` it adds the warm-up report's coverage
    of that profile (of its mesh grid on ``mesh_devices`` devices)."""
    missing = sorted(n for n in KERNELS if not build.library_path(n).exists())
    mesh = f" for a d{mesh_devices} mesh" if mesh_devices is not None else ""
    if missing:
        return False, (
            f"cold kernel build{mesh}: no library of {', '.join(missing)} in "
            f"{build.BUILD_DIR} — build first ({BUILD_POINTER})")
    reason = (f"kernel build check{mesh}: {', '.join(KERNELS)} built in "
              f"{build.BUILD_DIR}")
    if profile is not None:
        reason += "; " + _report_coverage(profile, cache_subdir, mesh_devices)
    return True, reason


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
