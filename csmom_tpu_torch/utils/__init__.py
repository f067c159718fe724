"""Utilities of the serving tier: clocks and deadlines."""
