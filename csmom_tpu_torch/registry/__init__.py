"""csmom_tpu_torch.registry — register an engine once, get every surface.

Counterpart of ``csmom_tpu.registry``'s serving queries (each loads the
builtin registrations on first use):

- :func:`serve_endpoints`: the serving tier's endpoint names;
- :func:`serve_surface`: one endpoint's :class:`ServeSurface`;
- :func:`workload_kinds`: the loadgen endpoint mix;
- :func:`get_engine` / :func:`engine_specs`: spec access;
- :func:`strategies`: the strategy zoo (``strategy/base.py``'s
  registrations);
- :func:`register_engine` / :func:`unregister_engine`: registration at
  run time (plugins, tests).

See :mod:`csmom_tpu_torch.registry.core` for the model and
:mod:`csmom_tpu_torch.registry.builtin` for what ships registered.
"""

from __future__ import annotations

from csmom_tpu_torch.registry.core import (
    REGISTRY,
    EngineRegistry,
    EngineSpec,
    ServeSurface,
    ensure_builtin,
    register_engine,
)

__all__ = [
    "EngineRegistry",
    "EngineSpec",
    "REGISTRY",
    "ServeSurface",
    "engine_specs",
    "get_engine",
    "register_engine",
    "serve_endpoints",
    "serve_surface",
    "strategies",
    "unregister_engine",
    "workload_kinds",
]


def serve_endpoints() -> tuple:
    return ensure_builtin().serve_endpoints()


def serve_surface(name: str) -> ServeSurface:
    return ensure_builtin().serve_surface(name)


def workload_kinds() -> tuple:
    return ensure_builtin().workload_kinds()


def get_engine(name: str, kind: str | None = None) -> EngineSpec:
    return ensure_builtin().get(name, kind)


def engine_specs(kind: str | None = None) -> tuple:
    return ensure_builtin().specs(kind)


def strategies() -> dict:
    """name -> Strategy class.  The port's strategies register through
    ``strategy.base.register_strategy``, not as engine specs; importing the
    builtin zoo (which imports torch) is what registers it."""
    from csmom_tpu_torch.strategy.base import available_strategies

    return available_strategies()


def unregister_engine(name: str, kind: str | None = None) -> None:
    ensure_builtin().unregister(name, kind)
