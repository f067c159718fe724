"""Clean twin: same two locks, ONE global acquisition order
(_lock before _state_lock, everywhere), blocking work outside the
critical section."""

import threading

from .helpers import slow_push


class Book:
    def __init__(self):
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()

    def credit(self):
        with self._lock:
            with self._state_lock:
                return 1

    def debit(self):
        with self._lock:
            return self._flush()

    def _flush(self):
        with self._state_lock:
            return 2

    def publish(self):
        with self._lock:
            payload = 3
        return slow_push(payload)
