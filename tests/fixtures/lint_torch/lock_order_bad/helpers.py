"""The helper that hides the blocking call one hop from the lock."""

import time


def slow_push(book):
    time.sleep(0.01)
    return book
