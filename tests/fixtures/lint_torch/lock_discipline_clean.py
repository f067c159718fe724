"""Clean twin: with-blocks and try-finally, blocking work outside."""

import threading
import time

_lock = threading.Lock()
_state = {"n": 0}


def safe_update():
    with _lock:
        _state["n"] += 1


def safe_manual():
    _lock.acquire()
    try:
        _state["n"] += 1
    finally:
        _lock.release()


def slow_path(sock, payload):
    with _lock:
        n = _state["n"]
    time.sleep(0.05)             # the wait happens lock-free
    sock.sendall(payload + bytes([n % 256]))


def try_lock_then_release():
    # the canonical non-blocking acquire: the if-test acquire whose
    # body opens with a try releasing in its finally (the read baton)
    if _lock.acquire(blocking=False):
        try:
            _state["n"] += 1
        finally:
            _lock.release()
