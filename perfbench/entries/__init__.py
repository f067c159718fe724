"""The benchmark's entries, one module each, found by the name that a
traffic file gives."""
