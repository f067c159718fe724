"""The port's static-analysis sweep (the exports of
:mod:`csmom_tpu.analysis`).

One parse per file, the registered rule visitors, scoped in-file pragmas
with stale-pragma detection, and a registry-driven rule set:
:mod:`~csmom_tpu_torch.analysis.core` is the framework,
:mod:`~csmom_tpu_torch.analysis.rules` the per-file rules
(clock-discipline, lock-discipline, dial-discipline, enumeration-drift),
:mod:`~csmom_tpu_torch.analysis.callgraph` the whole-program layer and
:mod:`~csmom_tpu_torch.analysis.project_rules` the project-scope rules
(lock-order, compile-surface).

- :func:`run_lint` runs the sweep (tier-1 gates on it at project scope)
  and returns a :class:`LintReport`;
- ``python -m csmom_tpu_torch.cli lint [--project] [--format
  text|json|github] [--no-cache] [--rule <id>] [--paths ...]`` is its
  CLI (:mod:`csmom_tpu_torch.cli.lint`).

Stdlib-only: a sweep imports neither torch nor any engine module, and
the names resolve on first use.
"""

from __future__ import annotations

_LAZY = {
    "Finding": "csmom_tpu_torch.analysis.core",
    "LintReport": "csmom_tpu_torch.analysis.core",
    "LintRule": "csmom_tpu_torch.analysis.core",
    "ProjectRule": "csmom_tpu_torch.analysis.core",
    "default_sources": "csmom_tpu_torch.analysis.core",
    "run_lint": "csmom_tpu_torch.analysis.core",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.analysis' has no attribute {name!r}")
