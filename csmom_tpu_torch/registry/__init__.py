"""csmom_tpu_torch.registry — register an engine once, get every surface.

Counterpart of ``csmom_tpu.registry``'s serving queries (each loads the
builtin registrations on first use):

- :func:`serve_endpoints`: the serving tier's endpoint names;
- :func:`serve_surface`: one endpoint's :class:`ServeSurface`;
- :func:`workload_kinds`: the loadgen endpoint mix;
- :func:`manifest_entries` / :func:`manifest_profiles` /
  :func:`manifest_entry_names`: the warm-up manifest
  (``compile/manifest.py`` builds from these);
- :func:`entry_factory`: a compile engine's shared entry factory;
- :func:`get_engine` / :func:`engine_specs`: spec access;
- :func:`strategies`: the strategy zoo (kind ``strategy``; importing the
  builtin zoo registers it);
- :func:`lint_rules`: the lint rules (kind ``lint``; importing the
  analysis rule modules registers them);
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
    "entry_factory",
    "get_engine",
    "lint_rules",
    "manifest_entries",
    "manifest_entry_names",
    "manifest_profiles",
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


def manifest_profiles() -> tuple:
    return ensure_builtin().manifest_profiles()


def manifest_entries(profile: str, dtype=None) -> list:
    return ensure_builtin().manifest_entries(profile, dtype)


def manifest_entry_names(profile: str) -> set:
    """The entry names the profile's engines declare without building
    their entries (``EngineSpec.manifest_names_fn``)."""
    return ensure_builtin().manifest_entry_names(profile)


def entry_factory(name: str):
    """A compile engine's shared (``lru_cache``d) entry factory, so
    every caller in one process runs one callable."""
    spec = ensure_builtin().get(name, kind="compile")
    if spec.entry_fn is None:
        raise KeyError(f"engine {name!r} declares no entry factory")
    return spec.entry_fn


def get_engine(name: str, kind: str | None = None) -> EngineSpec:
    return ensure_builtin().get(name, kind)


def engine_specs(kind: str | None = None) -> tuple:
    return ensure_builtin().specs(kind)


def strategies() -> dict:
    """name -> Strategy class of every kind-``strategy`` engine.
    Importing the builtin zoo (which imports torch) is what registers it,
    so this is the one query that is not torch-free."""
    import csmom_tpu_torch.strategy.builtin  # noqa: F401  (registers the zoo)

    return ensure_builtin().strategies()


def lint_rules() -> tuple:
    """Kind-``lint`` specs in registration order.  Importing the rule
    modules (stdlib-only) registers the shipped set, the per-file and
    the project-scope rules; a rule registered at run time appears here
    at once, which enrolls it in the sweep, its CLI and the fixture
    self-test."""
    import csmom_tpu_torch.analysis.rules  # noqa: F401  (registers the rules)
    import csmom_tpu_torch.analysis.project_rules  # noqa: F401, I001  (then the project set)

    return ensure_builtin().specs("lint")


def unregister_engine(name: str, kind: str | None = None) -> None:
    ensure_builtin().unregister(name, kind)
