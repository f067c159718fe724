"""The benchmark of ``csmom_tpu_torch`` on an NVIDIA card.

``python3 -m perfbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (see README.md).
"""

import importlib


def load(kind: str, name: str):
    """The module ``perfbench.<kind>.<name>``: an entry or a generator,
    found by the name that a traffic or configuration file gives."""
    return importlib.import_module(f"{__name__}.{kind}.{name}")
