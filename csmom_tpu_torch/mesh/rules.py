"""The partition-rule tables: regex -> spec, resolved on a named mesh.

Counterpart of :mod:`csmom_tpu.mesh.rules`, with the port's own spec
type :class:`P` (a tuple, as JAX's ``PartitionSpec`` is, so the two
compare entry for entry; :mod:`csmom_tpu_torch.parallel.compat` reads
it).  A rule
table maps leaf names to specs and :func:`match_partition_rules`
resolves a whole named tree at once; scalars and one-element leaves are
never split, and a leaf no rule matches raises.

==================  ======================  ============================
table               mesh                    what is split
==================  ======================  ============================
serve batch rules   ``("batch",)``          micro-batch rows of
                                            ``values/mask f[B, A, M]``
serve asset rules   ``("assets",)``         the asset axis of the
                                            per-asset endpoints
grid rules          ``("grid", "assets")``  J cells over ``grid``, assets
                                            over ``assets``
panel asset rules   ``("assets",)``         ``[A, ...]`` panels and
                                            per-asset vectors
==================  ======================  ============================

The serve tables place the mesh serving engine's micro-batches
(:func:`csmom_tpu_torch.mesh.variants.sharded_serve_entry_fn`); the grid
and panel tables place the sharded engines of
:mod:`csmom_tpu_torch.parallel`.  Which axis a serve endpoint splits
is itself a rule (:func:`serve_axis_for`).
"""

from __future__ import annotations

import math
import re

__all__ = [
    "P",
    "PartitionSpec",
    "grid_asset_mesh",
    "grid_rules",
    "match_partition_rules",
    "named_mesh",
    "panel_asset_rules",
    "serve_axis_for",
    "serve_rules",
]

class P(tuple):
    """A partition spec, one entry per leading dimension: a mesh axis
    name, a tuple of names (split over their product, the first the
    major one) or ``None`` (not split); later dimensions are not split.
    ``P("assets", None)`` splits dimension 0 over ``assets``; ``P()`` is
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


PartitionSpec = P

# serve-endpoint placement: regex on the endpoint name -> mesh axis.  The
# asset axis only for per-asset endpoints; anything else, a plugin the
# table has never heard of included, takes the batch axis
_SERVE_AXIS_RULES = (
    (r"^(momentum|turnover)$", "assets"),
    (r".", "batch"),
)


def serve_axis_for(endpoint: str) -> str:
    """Which mesh axis a serve endpoint's sharded entry splits."""
    for rule, axis in _SERVE_AXIS_RULES:
        if re.search(rule, endpoint):
            return axis
    return "batch"


def serve_rules(axis: str):
    """The serve-panel table of one placement: ``values``/``mask`` are
    ``f[B, A, M]`` micro-batches; outputs ``f[B, A]`` (per asset) or
    ``f[B, k]`` (summary)."""
    if axis == "batch":
        return (
            (r"(^|/)(values|mask)$", P("batch", None, None)),
            (r"(^|/)out_per_asset$", P("batch", None)),
            (r"(^|/)out_summary$", P("batch", None)),
        )
    if axis == "assets":
        return (
            (r"(^|/)(values|mask)$", P(None, "assets", None)),
            (r"(^|/)out_per_asset$", P(None, "assets")),
        )
    raise ValueError(f"unknown serve placement {axis!r}: use 'batch' or "
                     "'assets'")


def grid_rules():
    """The J x K grid table: panels split over asset shards, J cells over
    ``grid``, per-cell planes gathered grid-major."""
    return (
        (r"(^|/)(prices|mask)$", P("assets", None)),
        (r"(^|/)Js$", P("grid")),
        (r"(^|/)Ks$", P()),
        (r"(^|/)(spreads|spread_valid|net)$", P("grid", None, None)),
    )


def panel_asset_rules():
    """``[A, ...]`` panels and per-asset vectors, split over assets (the
    stream signals, histrank labels, the event engine's five arrays)."""
    return (
        (r"(^|/)(prices|values|volumes|price|valid|score|mask)$",
         P("assets")),
        (r"(^|/)(shares|adv|vol)$", P("assets")),
        (r"(^|/)labels$", P("assets")),
    )


def match_partition_rules(rules, tree, sep: str = "/"):
    """Resolve a named tree of arrays to specs.

    ``tree`` is nested dicts/lists/tuples with array-like leaves (tensors,
    numpy arrays, manifest ``TensorSpec``\\ s: anything with a
    ``shape``).  A leaf's name joins its path with ``sep``, and the first
    rule whose regex searches the name wins.  Scalars and one-element
    leaves get ``P()``; a larger leaf that no rule matches raises,
    naming it.
    """
    def spec_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if len(shape) == 0 or math.prod(shape) == 1:
            return P()
        for rule, ps in rules:
            if re.search(rule, name):
                return ps
        raise ValueError(
            f"no partition rule matches leaf {name!r} (shape {shape}); "
            "add a rule to csmom_tpu_torch/mesh/rules.py or pass an "
            "explicit spec")

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(f"{name}{sep}{k}" if name else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(f"{name}{sep}{i}" if name else str(i), v)
                   for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        return spec_for(name, node)

    return walk("", tree)


def named_mesh(axis: str, n_shards: int, devices=None):
    """A 1-D mesh named ``axis`` over the first ``n_shards`` devices
    (default: the visible cards)."""
    from csmom_tpu_torch.parallel.mesh import Mesh, visible_devices

    devices = tuple(devices) if devices is not None else tuple(visible_devices())
    if n_shards > len(devices):
        raise ValueError(f"{n_shards} shards > {len(devices)} visible devices")
    return Mesh(list(devices[:n_shards]), (axis,))


def grid_asset_mesh(grid_shards: int, asset_shards: int, devices=None):
    """The ``(grid, assets)`` mesh of the J x K backtest, sized
    explicitly (:func:`csmom_tpu_torch.parallel.mesh.make_mesh`'s
    placement)."""
    from csmom_tpu_torch.parallel.mesh import make_mesh, visible_devices

    devices = tuple(devices) if devices is not None else tuple(visible_devices())
    need = grid_shards * asset_shards
    if need > len(devices):
        raise ValueError(
            f"grid {grid_shards} x assets {asset_shards} = {need} devices "
            f"> {len(devices)} visible")
    return make_mesh(list(devices[:need]), grid_axis=grid_shards)
