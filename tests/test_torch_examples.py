"""The port's six example scripts (``csmom_tpu_torch.examples``) against
the JAX package's ``examples/``: on the same arguments both print the
same numbers, timing lines aside.  The two synthetic-panel scripts run at
48 assets x 4 years; the four ``--data-dir`` scripts run on one seeded
synthetic 20-ticker directory, on which ``replicate_reference`` stops at
its golden-mean assert in both packages after printing the same line.
With the reference data mounted, the port's scripts also pass their own
golden asserts."""

import contextlib
import io
import os
import runpy
import sys

import pytest
import torch

from tests.conftest import REFERENCE_DATA, requires_reference

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(_REPO, "examples")


def _ref(script, argv):
    """The JAX script's stdout, and the exception it stopped on (or None)."""
    path = os.path.join(EXAMPLES, f"{script}.py")
    old, buf, err = sys.argv, io.StringIO(), None
    sys.argv = [path] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except AssertionError as e:
        err = e
    finally:
        sys.argv = old
    return buf.getvalue(), err


def _port(script, argv):
    import importlib

    mod = importlib.import_module(f"csmom_tpu_torch.examples.{script}")
    buf, err = io.StringIO(), None
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(argv + ["--device", "cpu"])
    except AssertionError as e:
        err = e
    return buf.getvalue(), err


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from csmom_tpu_torch.examples._synthetic_data import write_data_dir

    d = tmp_path_factory.mktemp("synthetic_reference_data")
    write_data_dir(str(d))
    return str(d)


@pytest.mark.parametrize("impl,ref_impl", [("matmul", "matmul"), ("plain", "xla")])
def test_north_star_grid_prints_the_references_table(impl, ref_impl):
    args = ["--assets", "48", "--years", "4"]
    got, gerr = _port("north_star_grid", args + ["--impl", impl])
    want, werr = _ref("north_star_grid", args + ["--impl", ref_impl])
    assert gerr is None and werr is None
    g, w = got.splitlines(), want.splitlines()
    # the first line carries the wall; its words before the timing equal
    assert g[0].split(": 16-cell grid in")[0] == \
        w[0].split(": 16-cell grid in")[0].replace(ref_impl, impl)
    assert g[1:] == w[1:] and any(ln.startswith("walk-forward:") for ln in g)
    assert sum(ln.startswith("J=") for ln in g) == 4


def test_pack_at_scale_prints_the_references_numbers(tmp_path):
    args = ["--assets", "48", "--years", "4"]
    got, gerr = _port("pack_at_scale", args + ["--keep", str(tmp_path / "p")])
    want, werr = _ref("pack_at_scale", args + ["--keep", str(tmp_path / "r")])
    assert gerr is None and werr is None
    g, w = got.splitlines(), want.splitlines()
    assert g[0].split(" MB ")[0] == w[0].split(" MB ")[0]  # size; walls aside
    assert g[1] == w[1] and "bit-identical" in g[1]
    assert g[2] == w[2].replace(str(tmp_path / "r"), str(tmp_path / "p"))
    # the kept pack is a drop-in --data-dir of the monthly pipeline
    from csmom_tpu_torch.api import monthly_price_panel

    prices, volume = monthly_price_panel(str(tmp_path / "p"), None, device="cpu")
    assert prices.n_assets == 48 and volume.n_times == prices.n_times


@pytest.mark.parametrize("script", ["replicate_reference", "strategy_zoo",
                                    "cost_frontier", "causal_scoring"])
def test_data_dir_script_prints_the_references_lines(script, data_dir):
    got, gerr = _port(script, ["--data-dir", data_dir])
    want, werr = _ref(script, ["--data-dir", data_dir])
    assert got == want and got.strip()
    if script == "replicate_reference":
        # the synthetic data is not the reference's: both stop at the
        # golden mean, after the same monthly line
        assert str(gerr) == str(werr) == "golden mean drifted"
        assert got.startswith("monthly mean spread ")
    else:
        assert gerr is None and werr is None


@pytest.mark.parametrize("script", ["north_star_grid", "pack_at_scale",
                                    "replicate_reference", "strategy_zoo",
                                    "cost_frontier", "causal_scoring"])
def test_each_example_runs_as_a_module_and_keeps_its_flags(script):
    import importlib

    mod = importlib.import_module(f"csmom_tpu_torch.examples.{script}")
    with pytest.raises(SystemExit) as e:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            mod.main(["--help"])
    assert e.value.code == 0
    text = out.getvalue()
    assert "--device" in text and "--platform" not in text
    ref = open(os.path.join(EXAMPLES, f"{script}.py")).read()
    for flag in ("--assets", "--years", "--impl", "--keep", "--data-dir",
                 "--n-bins", "--bands", "--tc-bps"):
        assert (flag in text) == (f'"{flag}"' in ref), flag


@requires_reference
def test_replicate_reference_passes_its_golden_asserts():
    got, err = _port("replicate_reference", ["--data-dir", REFERENCE_DATA])
    assert err is None and "parity OK" in got


@requires_reference
def test_cost_frontier_passes_its_sanity_asserts():
    got, err = _port("cost_frontier", ["--data-dir", REFERENCE_DATA])
    assert err is None and "frontier sanity checks passed" in got
