"""Numerical guards.

Counterpart of ``csmom_tpu.utils.guards``:

- :func:`validate_panel` is the host-side ingest gate, copied: mask and
  value consistency, no Inf, a monotone time axis.  Bad assets are
  maskable (a fully masked row only warns); a malformed panel raises.
- :func:`checked` takes the place of the reference's ``checkify``
  wrapper, with its contract: ``checked(fn)(*args) -> (err, out)`` and
  ``err.throw()`` raising on the first failed check.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from csmom_tpu_torch.utils.logging import get_logger

__all__ = ["CheckError", "FLOAT_CHECKS", "INDEX_CHECKS", "checked",
           "validate_panel"]

log = get_logger("guards")

FLOAT_CHECKS = frozenset({"float"})
INDEX_CHECKS = frozenset({"index"})


def validate_panel(values, mask, times=None, name: str = "panel") -> None:
    """Raise ValueError on structural problems; warn on maskable ones.

    Checks: shapes match; no +-Inf anywhere; no non-finite value where
    mask=True (NaN under mask is the convention, NaN *over* mask poisons
    reductions); times (if given) strictly increasing and length-matched.
    """
    values = np.asarray(values)
    mask = np.asarray(mask)
    if values.shape != mask.shape:
        raise ValueError(f"{name}: values{values.shape} vs mask{mask.shape}")
    if np.isinf(values).any():
        raise ValueError(f"{name}: contains Inf (corrupt ingest?)")
    bad = mask & ~np.isfinite(values)
    if bad.any():
        a_bad = np.unique(np.nonzero(bad)[0])
        raise ValueError(
            f"{name}: {int(bad.sum())} masked-valid slots hold non-finite "
            f"values (asset rows {a_bad[:10].tolist()}...)"
        )
    if times is not None:
        times = np.asarray(times)
        if len(times) != values.shape[-1]:
            raise ValueError(f"{name}: {len(times)} times vs T={values.shape[-1]}")
        if len(times) > 1 and not (times[1:] > times[:-1]).all():
            raise ValueError(f"{name}: time axis not strictly increasing")
    dead = ~mask.any(axis=-1)
    if dead.any():
        log.warning("%s: %d asset(s) fully masked (dead lanes)", name, int(dead.sum()))


@dataclasses.dataclass(frozen=True)
class CheckError:
    """The failed checks of one :func:`checked` call, in output order
    (empty when every check passed)."""

    messages: tuple = ()

    def get(self) -> str | None:
        """The first failure's message, or None."""
        return self.messages[0] if self.messages else None

    def throw(self) -> None:
        """Raise ``ValueError`` with the first failure's message."""
        if self.messages:
            raise ValueError(self.messages[0])


def _leaves(out, path="out"):
    """(path, tensor) of every tensor in ``out`` (tensors, tuples, lists,
    dicts and dataclasses, nested)."""
    import torch

    if isinstance(out, torch.Tensor):
        yield path, out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _leaves(getattr(out, f.name), f"{path}.{f.name}")
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, f"{path}[{k!r}]")


def checked(fn, errors=None):
    """Wrap ``fn`` with float and index checks.

    Returns ``g(*args, **kwargs) -> (err, out)``; ``err.throw()`` raises
    the first failed check as ``ValueError``.  ``errors`` is a set of
    check names, ``FLOAT_CHECKS | INDEX_CHECKS`` by default.

    - The float check looks at every floating tensor ``fn`` returns, after
      the call, and fails on the first one holding a NaN or an Inf.
    - The index check is torch's own: an out-of-range index in ``fn``
      raises from the indexing operation itself, so it never reaches
      ``err``.

    Not caught, unlike ``checkify``: a NaN or Inf made inside ``fn`` and
    not returned (one that a later operation masks out or reduces away),
    and the values of non-tensor outputs.
    """
    if errors is None:
        errors = FLOAT_CHECKS | INDEX_CHECKS

    def g(*args, **kwargs):
        import torch

        out = fn(*args, **kwargs)
        msgs = []
        if "float" in errors:
            for path, t in _leaves(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    kind = "nan" if bool(torch.isnan(t).any()) else "inf"
                    msgs.append(f"{kind} generated by {getattr(fn, '__name__', 'fn')}"
                                f": {path} holds a non-finite value")
        return CheckError(tuple(msgs)), out

    return g
