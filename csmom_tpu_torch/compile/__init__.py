"""The warm-start: a manifest of hot entry points, warmed by running them.

Counterpart of ``csmom_tpu.compile``:

- :mod:`~csmom_tpu_torch.compile.workloads`: the canonical input builders
  (grid canon, north-star and reduced grids from a synthetic pack, the
  golden event workload);
- :mod:`~csmom_tpu_torch.compile.entries`: the shared hot entry points;
- :mod:`~csmom_tpu_torch.compile.manifest`: each hot entry point with its
  canonical shapes and the kernels it launches, bound against the
  functions' signatures so the manifest cannot drift from the code;
- :mod:`~csmom_tpu_torch.compile.aot`: the warm-up, which builds or loads
  each entry's kernel libraries and runs it twice at its shapes, with
  per-entry walls, launches and memory, as the CLI's ``warmup``.

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "ManifestEntry": "csmom_tpu_torch.compile.manifest",
    "build_manifest": "csmom_tpu_torch.compile.manifest",
    "aot_compile": "csmom_tpu_torch.compile.aot",
    "warmup": "csmom_tpu_torch.compile.aot",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.compile' has no attribute {name!r}")
