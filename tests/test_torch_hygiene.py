"""Package rules of the port: no JAX and no csmom_tpu module anywhere in it,
and no silent CPU fallback when no card is present."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for dirpath, dirnames, names in os.walk(os.path.join(_REPO, "csmom_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "csmom_tpu")  # exact: csmom_tpu_torch is fine


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, _REPO), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_package_import_is_lazy():
    """Importing the package loads neither torch nor any engine module."""
    code = ("import sys, csmom_tpu_torch; "
            "print('torch' in sys.modules, "
            "any(m.startswith('csmom_tpu_torch.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                         capture_output=True, text=True, timeout=60).stdout
    assert out.split() == ["False", "False"]


def test_entry_points_raise_without_a_card():
    """cuda is the default; without a card every entry point raises and
    names device='cpu' instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import numpy as np

    from csmom_tpu_torch import run_grid, run_monthly
    from csmom_tpu_torch.device import resolve_device
    from csmom_tpu_torch.panel.panel import Panel, to_tensors
    from csmom_tpu_torch.workloads import month_panel

    panel = Panel(values=np.ones((3, 4)), mask=np.ones((3, 4), bool),
                  tickers=("a", "b", "c"), times=np.arange(4).astype("datetime64[D]"))
    for call in (lambda: run_monthly(panel), lambda: run_grid(panel),
                 lambda: to_tensors(panel.values, panel.mask),
                 lambda: month_panel(3, 40), lambda: resolve_device(None),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
