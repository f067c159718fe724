"""Known-bad fixture: lock-order defects the PER-FILE lock rule cannot
see (each function is locally disciplined — with-blocks only, no
lexical blocking call under a lock)."""

import threading

from .helpers import slow_push


class Book:
    def __init__(self):
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()

    def credit(self):
        # order: _lock -> _state_lock
        with self._lock:
            with self._state_lock:
                return 1

    def debit(self):
        # order: _state_lock -> _lock, but only THROUGH _flush — the
        # opposite order is invisible to any single-function view
        with self._state_lock:
            return self._flush()

    def _flush(self):
        with self._lock:
            return 2

    def publish(self):
        # helper-hidden blocking call: slow_push sleeps, one hop away
        with self._lock:
            return slow_push(self)
