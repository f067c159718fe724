"""Known-bad fixture: locks leaving scope bare, blocking under a lock."""

import threading
import time

_lock = threading.Lock()
_state = {"n": 0}


def leaky_update():
    _lock.acquire()              # no with, no try/finally: a raise between
    _state["n"] += 1             # acquire and release deadlocks every
    _lock.release()              # later waiter


def slow_path(sock, payload):
    with _lock:
        time.sleep(0.05)         # blocking call with the lock held
        sock.sendall(payload)    # socket write serializes every waiter
