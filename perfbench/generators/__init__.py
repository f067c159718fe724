"""The benchmark's generators, one module each, found by the name that a
configuration file gives."""
