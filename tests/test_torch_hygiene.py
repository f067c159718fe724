"""Package rules of the port: no JAX and no csmom_tpu module anywhere in it,
no file of csmom_tpu read by it either, its native build in its own build
directory, and no silent CPU fallback when no card is present."""

import ast
import importlib
import json
import os
import re
import subprocess
import sys
import textwrap

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
    assert {os.path.basename(f) for f in files
            if os.sep + "examples" + os.sep in f} >= {
        "north_star_grid.py", "pack_at_scale.py", "replicate_reference.py",
        "strategy_zoo.py", "cost_frontier.py", "causal_scoring.py"}
    bad = [(os.path.relpath(f, _REPO), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


# a "file:line" citation of a reference kernel (the smoke's "replaces"
# field) names a file without opening it
_CITATION = re.compile(r"^csmom_tpu/[\w/]+\.py:\d+(-\d+)?$")


def _reference_paths(path):
    """String constants of ``path`` (docstrings aside) that name a file or
    directory of csmom_tpu: a path under ``csmom_tpu/``, or ``csmom_tpu``
    as a path component to join."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            v = node.value
            if v.strip("/") == "csmom_tpu" or (
                    re.search(r"(^|[/\\])csmom_tpu[/\\]", v) and not _CITATION.match(v)):
                yield v


def test_the_scan_covers_the_serving_tier():
    """The import scan walks every subpackage of the port, the serving
    tier's included."""
    rel = {os.path.relpath(f, _REPO) for f in _port_files()}
    for sub in ("registry", "serve", "obs", "chaos", "utils"):
        assert os.path.join("csmom_tpu_torch", sub, "__init__.py") in rel
    assert os.path.join("csmom_tpu_torch", "cli", "serve.py") in rel
    for mod in ("proto", "health", "worker", "supervisor", "router",
                "fabric", "fleet"):
        assert os.path.join("csmom_tpu_torch", "serve", f"{mod}.py") in rel
    for sub in ("obs", "cli"):
        assert os.path.join("csmom_tpu_torch", sub, "fleet.py") in rel
    for mod in ("__init__", "ring", "ingest", "incremental", "replay"):
        assert os.path.join("csmom_tpu_torch", "stream", f"{mod}.py") in rel
    for mod in ("trace", "replay", "registry", "rehearse", "timeline"):
        assert os.path.join("csmom_tpu_torch", "cli", f"{mod}.py") in rel
    assert os.path.join("csmom_tpu_torch", "obs", "timeline.py") in rel


def test_stream_import_loads_neither_torch_nor_pandas():
    """The stream data plane (ring, ingest, incremental) is numpy only, as
    the reference keeps it free of its engine: a replay with the stub
    engine never needs torch."""
    code = ("import sys, csmom_tpu_torch.stream; "
            "print(sorted({'torch', 'pandas'} & set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                         env={**os.environ, "PYTHONPATH": _REPO},
                         capture_output=True, text=True, timeout=60).stdout
    assert out.strip() == "[]"


def test_port_names_no_file_of_the_reference():
    bad = [(os.path.relpath(f, _REPO), v) for f in _port_files()
           for v in _reference_paths(f)]
    assert bad == []


def test_port_reads_no_file_of_the_reference(tmp_path):
    """The data path and one CLI command run under an audit hook: every
    file they open, every library they load and every program they start
    lies outside csmom_tpu/, and the CSV parser is loaded from
    build/csmom_tpu_torch/."""
    code = textwrap.dedent(f"""
        import json, os, sys
        seen = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                seen.append(("open", os.fsdecode(args[0])))
            elif event == "ctypes.dlopen" and args[0]:
                seen.append(("dlopen", os.fsdecode(args[0])))
            elif event == "subprocess.Popen":
                seen.append(("popen", " ".join(map(os.fsdecode, args[1]))))
        sys.addaudithook(hook)
        import numpy as np, torch
        from csmom_tpu_torch.api import monthly_price_panel
        from csmom_tpu_torch.analytics.tearsheet import tearsheet
        from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
        from csmom_tpu_torch.panel.pack import pack_csv_cache
        from csmom_tpu_torch import native
        uni = {os.path.join(_REPO, "tests", "fixtures", "universe")!r}
        tk = sorted(n.split("_")[0] for n in os.listdir(uni))
        pack_csv_cache(uni, tk, {str(tmp_path / "pack")!r})
        p, _ = monthly_price_panel(uni, tk, device="cpu")
        q, _ = monthly_price_panel({str(tmp_path / "pack")!r}, None, device="cpu")
        v, m = p.tensors(device="cpu")
        b = banded_monthly_backtest(v, m, lookback=3, n_bins=4, band=1)
        tearsheet(b.spread, b.spread_valid)
        from csmom_tpu_torch.cli.main import main
        rc = main(["replicate", "--data-dir", {str(tmp_path / "pack")!r},
                   "--device", "cpu", "--out", {str(tmp_path / "out")!r},
                   "--lookback", "3", "--n-bins", "4", "--strategy",
                   "volume_z_momentum", "--tables", "--band", "1"])
        assert rc == 0
        print(json.dumps({{"seen": seen, "native": native.available(),
                          "lib": str(native.library_path())}}))
    """)
    env = {**os.environ, "PYTHONPATH": _REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         check=True, capture_output=True, text=True, timeout=300).stdout
    rec = json.loads(out.strip().splitlines()[-1])
    ref_dir = os.path.join(_REPO, "csmom_tpu") + os.sep
    touched = [(kind, p) for kind, p in rec["seen"]
               if ref_dir in os.path.abspath(p) or ref_dir in p]
    assert touched == []
    assert rec["native"]
    build_dir = os.path.join(_REPO, "build", "csmom_tpu_torch") + os.sep
    assert rec["lib"].startswith(build_dir)
    loaded = [p for kind, p in rec["seen"] if kind == "dlopen" and "fastcsv" in p]
    assert loaded and all(p.startswith(build_dir) for p in loaded)


def test_intraday_reads_no_file_of_the_reference(tmp_path):
    """One intraday pipeline and one intraday command of the port's CLI run
    under the audit hook: no file, library or program they touch lies under
    csmom_tpu/."""
    import numpy as np
    import pandas as pd

    from csmom_tpu_torch.api import synthetic_minute_frame
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(3, 40, seed=4)
    stamps = pd.DatetimeIndex(daily.times).strftime("%Y-%m-%d")
    tickers = ["HA", "HB", "HC"]
    for i, t in enumerate(tickers):
        v = daily.values[i]
        pd.DataFrame({"date": stamps, "open": v, "high": v, "low": v, "close": v,
                      "adj_close": v, "volume": 1e6}).to_csv(
            tmp_path / f"{t}_daily.csv", index=False)
    last = pd.DataFrame({"date": np.repeat(daily.times[-2:], 3), "ticker": tickers * 2,
                         "open": daily.values[:, -2:].T.ravel(),
                         "close": daily.values[:, -2:].T.ravel(), "volume": 1e6})
    for t, g in synthetic_minute_frame(last, seed=1).groupby("ticker"):
        pd.DataFrame({"datetime": g["datetime"].dt.strftime("%Y-%m-%d %H:%M:%S"),
                      "open": g["price"], "high": g["price"], "low": g["price"],
                      "close": g["price"], "volume": g["volume"]}).to_csv(
            tmp_path / f"{t}_intraday.csv", index=False)
    code = textwrap.dedent(f"""
        import json, os, sys
        seen = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                seen.append(("open", os.fsdecode(args[0])))
            elif event == "ctypes.dlopen" and args[0]:
                seen.append(("dlopen", os.fsdecode(args[0])))
            elif event == "subprocess.Popen":
                seen.append(("popen", " ".join(map(os.fsdecode, args[1]))))
        sys.addaudithook(hook)
        from csmom_tpu_torch.api import intraday_pipeline
        from csmom_tpu_torch.panel.ingest import load_daily, load_intraday
        d, tk = {str(tmp_path)!r}, {tickers!r}
        res, *_ = intraday_pipeline(load_intraday(d, tk), load_daily(d, tk),
                                    model="elastic_net", latency_bars=1, device="cpu")
        from csmom_tpu_torch.cli.main import main
        rc = main(["intraday", "--data-dir", d, "--tickers", ",".join(tk),
                   "--device", "cpu", "--out", {str(tmp_path / "out")!r},
                   "--threshold-hi", "1e-4", "--threshold-lo", "2e-5"])
        assert rc == 0 and int(res.n_trades) > 0
        print(json.dumps({{"seen": seen}}))
    """)
    env = {**os.environ, "PYTHONPATH": _REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         check=True, capture_output=True, text=True, timeout=300).stdout
    seen = json.loads(out.strip().splitlines()[-1])["seen"]
    ref_dir = os.path.join(_REPO, "csmom_tpu") + os.sep
    assert [(kind, p) for kind, p in seen
            if ref_dir in os.path.abspath(p) or ref_dir in p] == []
    assert any(p.endswith("HA_intraday.csv") for kind, p in seen if kind == "open")


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

    from csmom_tpu_torch import monthly_price_panel, run_grid, run_monthly
    from csmom_tpu_torch.device import resolve_device
    from csmom_tpu_torch.models import ElasticNetFit, OnlineRidgeFit, RidgeFit
    from csmom_tpu_torch.models.mlp import params_from_numpy
    from csmom_tpu_torch.panel.panel import Panel, to_tensors
    from csmom_tpu_torch.serve.engine import TorchEngine, make_engine
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService
    from csmom_tpu_torch.stream.replay import ReplayConfig, run_replay
    from csmom_tpu_torch.workloads import month_panel
    from csmom_tpu_torch.compile.aot import warmup
    from csmom_tpu_torch.compile.workloads import grid_month_inputs

    examples = [importlib.import_module(f"csmom_tpu_torch.examples.{n}")
                for n in ("north_star_grid", "pack_at_scale",
                          "replicate_reference", "strategy_zoo",
                          "cost_frontier", "causal_scoring")]

    panel = Panel(values=np.ones((3, 4)), mask=np.ones((3, 4), bool),
                  tickers=("a", "b", "c"), times=np.arange(4).astype("datetime64[D]"))
    for call in (lambda: run_monthly(panel), lambda: run_grid(panel),
                 lambda: to_tensors(panel.values, panel.mask),
                 lambda: panel.tensors(),
                 lambda: monthly_price_panel(
                     os.path.join(_REPO, "tests", "fixtures", "universe"), ["SYNAA"]),
                 lambda: month_panel(3, 40), lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: params_from_numpy([(np.ones((2, 1)), np.zeros(1))]),
                 lambda: RidgeFit.from_numpy(coef=np.zeros(2)),
                 lambda: ElasticNetFit.from_numpy(coef=np.zeros(2)),
                 lambda: OnlineRidgeFit.from_numpy(coef=np.zeros(2)),
                 lambda: TorchEngine(), lambda: make_engine("torch"),
                 lambda: SignalService(ServeConfig(engine="torch")),
                 lambda: run_replay(ReplayConfig(engine="torch")),
                 lambda: warmup(("smoke",), write_report=False),
                 lambda: grid_month_inputs(3, 40, torch.float32),
                 *(lambda m=m: m.main([]) for m in examples)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_pool_worker_raises_without_a_card(tmp_path):
    """A pool worker on its default ``--device cuda`` with no card exits
    non-zero naming ``--device cpu`` before it binds; nothing runs on the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from csmom_tpu_torch.serve.worker import RC_NO_DEVICE

    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.serve.worker",
         "--socket", str(tmp_path / "w.sock")],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": _REPO})
    assert p.returncode == RC_NO_DEVICE, p.stderr
    assert "--device cpu" in p.stderr
    assert not (tmp_path / "w.sock").exists()
