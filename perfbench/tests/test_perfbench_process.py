"""The harness as a process: what it imports, and that it refuses to run
without a card or without the program beside it."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "csmom_tpu")
PB = ROOT / "perfbench"


def _modules():
    return sorted("perfbench." + ".".join(p.relative_to(PB).with_suffix("").parts)
                  for p in PB.rglob("*.py")
                  if "tests" not in p.parts and p.parent.name != "metrics"
                  and p.name != "__init__.py")


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    """Every module of the harness and every metric reader imported in a
    fresh process; no top-level module name loaded is JAX's or the JAX
    package's (compared whole: csmom_tpu_torch passes)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    __import__(m)\n"
        "from perfbench.run import load_reader\n"
        f"for p in {sorted(str(p.stem) for p in (PB / 'metrics').glob('*.py'))!r}:\n"
        "    if not p.startswith('_'):\n"
        "        load_reader(p)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "csmom_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_file_names_jax_and_the_reference_names_no_program(path):
    top = _imported(path)
    assert not top & set(FORBIDDEN)
    if "reference" in path.relative_to(PB).parts:
        assert "csmom_tpu_torch" not in top


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import perfbench.reference.grid, perfbench.reference.event\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'csmom_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "jt93_crsp.grid_rank",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_refuses_to_run_without_the_program(tmp_path):
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    r = _run(ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"engine_call_ms", "setup_s"} <= set(res["metrics"])
