"""Buffer donation: a call that consumes its caller's tensors.

Counterpart of ``donate_argnums`` in the reference's donated entries
(``event_backtest_donated``, ``jk_grid_backtest(donate_panels=True)``,
``serve_entry_fn_donated``, ...).  There the caller hands XLA its input
buffers, the arrays report ``is_deleted()`` afterwards, and the call's
peak memory can be smaller.  Torch frees a storage when its last
reference goes, and the caching allocator hands the block to the next
allocation on the stream, so the port keeps the same contract:

- :func:`consume`, called at a donated surface's entry, returns aliases
  of the caller's tensors (new tensor objects on the same storage) for
  the body to work on, and detaches each caller's tensor from its
  storage (``Tensor.set_()``).  The storage is freed once the body drops
  its last alias or view, so a body that lets go of an input after its
  last use gives that memory back to the allocator in the middle of the
  call;
- a consumed tensor reads as an empty tensor of shape ``(0,)`` where JAX
  raises on a deleted array (ROADMAP.md, known difference 79): a read
  after donation is a wrong number, not an error, which is what the
  ``donation-safety`` lint rule catches;
- :func:`is_deleted` is the counterpart of ``jax.Array.is_deleted()``.

A tensor that cannot be donated is left untouched with a warning whose
text starts as XLA's does ("donated buffers were not usable"): a view
of another tensor's storage (the base keeps the memory), a tensor that
requires grad, a tensor given twice in one call (or two tensors on one
storage), and anything that is not a tensor (a numpy array, which the
surface uploads itself; the upload is then what the body releases
early).

Streams: a consumed storage that a kernel on another stream still reads
must be kept alive with ``Tensor.record_stream``.  Every donated surface
of the port runs its body on the current stream of its tensors' one
device, so no storage crosses streams; :func:`consume` raises when the
tensors it is given lie on more than one device.
"""

from __future__ import annotations

import warnings
import weakref

__all__ = ["NOT_USABLE", "consume", "is_deleted"]

NOT_USABLE = "donated buffers were not usable"

# id -> consumed tensor, held weakly: an entry leaves with its tensor, so
# a later object at the same address is never taken for a consumed one
# (a WeakSet would compare tensors with their elementwise __eq__)
_CONSUMED: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def is_deleted(t) -> bool:
    """True exactly for a tensor that a donated surface consumed."""
    return _CONSUMED.get(id(t)) is t


def _storage_key(t):
    return (t.device, t.untyped_storage().data_ptr()) if t.numel() else None


def _refusal(t, i: int, shared: set) -> str | None:
    """Why argument ``i`` cannot be donated, or None when it can."""
    import torch

    if not isinstance(t, torch.Tensor):
        return f"argument {i} is a {type(t).__name__}, not a tensor"
    if t.requires_grad:
        return f"argument {i} requires grad"
    if t._is_view() or t.storage_offset() != 0 or \
            t.untyped_storage().nbytes() != t.numel() * t.element_size():
        return f"argument {i} is a view of a larger storage"
    if id(t) in shared or _storage_key(t) in shared:
        return f"argument {i} shares its storage with another argument"
    return None


def consume(*tensors):
    """Donate ``tensors``: return the aliases the body works on, in order,
    and leave each caller's tensor empty (see the module docstring).  An
    argument that cannot be donated is returned as it is, with a
    warning; a tensor that was consumed already raises, as a deleted
    array does in JAX."""
    import torch

    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(
            f"donated tensors lie on {sorted(map(str, devices))}: a donated "
            "call runs on one device's current stream")
    ids, keys, shared = set(), set(), set()
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        if is_deleted(t):
            raise RuntimeError(
                "a tensor given to a donated call was consumed by an earlier "
                "donated call: pass a fresh tensor")
        key = _storage_key(t)
        if id(t) in ids or (key is not None and key in keys):
            shared |= {id(t), key}
        ids.add(id(t))
        keys.add(key)
    shared.discard(None)
    out = []
    for i, t in enumerate(tensors):
        why = _refusal(t, i, shared)
        if why is not None:
            warnings.warn(f"{NOT_USABLE}: {why}; it was left as it was",
                          UserWarning, stacklevel=3)
            out.append(t)
            continue
        with torch.inference_mode(False):
            alias = t.detach()
        with torch.inference_mode(t.is_inference()):
            t.set_()
        _CONSUMED[id(t)] = t
        out.append(alias)
    return tuple(out)
