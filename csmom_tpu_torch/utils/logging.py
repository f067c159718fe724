"""Structured logging.

Counterpart of ``csmom_tpu.utils.logging``: every module logs through a
namespaced stdlib logger under ``csmom_tpu_torch`` with one shared
format, its level set by ``CSMOM_LOG_LEVEL`` (default ``INFO``; an
unknown level name falls back to ``INFO``).  Unlike the reference's, the
package logger keeps propagating to the root logger, so a handler there
(pytest's ``caplog``, an application's own) sees the port's records too.
"""

from __future__ import annotations

import logging
import os

__all__ = ["get_logger"]

_ROOT = "csmom_tpu_torch"
_CONFIGURED = False


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("CSMOM_LOG_LEVEL", "INFO").upper()
    # getLevelName(name) round-trips a known level name to its int and
    # returns the "Level %s" string for anything else
    if not isinstance(logging.getLevelName(level), int):
        level = "INFO"
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """The logger ``csmom_tpu_torch.<name>`` (``name`` as given when it
    already starts with the package name)."""
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
