"""Fixtures of the benchmark's tests.

Run them from the repository's root: ``python -m pytest perfbench/tests``
(CPU), and on the card ``python -m pytest perfbench/tests -m card``.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# sizes a CPU run holds: the configurations' shapes with fewer stocks,
# days and minutes
TINY = {
    "jt93_crsp": {"n_assets": 120, "n_days": 2000},
    "sp500_minutes": {"n_assets": 16, "n_days": 3, "minutes_per_day": 60},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one (run on the "
                   "card with -m card)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")


def edit_config(root: Path, name: str, **changes) -> None:
    p = root / "perfbench" / "configs" / f"{name}.json"
    cfg = json.loads(p.read_text())
    cfg.update(changes)
    p.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files (BENCHMARK.json and ``perfbench/``)
    with every configuration cut to a CPU size."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for name, changes in TINY.items():
        edit_config(tmp_path, name, **changes)
    return tmp_path
