"""The same helper — legal when called with no lock held."""

import time


def slow_push(payload):
    time.sleep(0.01)
    return payload
