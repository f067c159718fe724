"""The port's CLI (``python -m csmom_tpu_torch.cli``) against ``csmom``, each
run in-process on the same inputs, on the CPU.

Inputs: (a) the committed 8-ticker CSV universe (``tests/fixtures/universe``),
(b) a two-field f64 pack of ``synthetic_daily_panel(60, 1260, seed=7,
listing_gaps=True)`` with a seeded volume, and (c) for ``intraday`` and
``run``, a CSV cache of 6 tickers (300 daily bars, one file in the
second dialect; 3 days of minute bars with 4% of the minutes missing).  Every command's stdout must be
the reference's, line for line, once the program name and the engine label
are mapped; where a line differs, its text outside the numbers must be equal
(whitespace aside, as pandas pads columns to the widest value) and every
number must agree within one unit of its last printed digit.  Error paths
must exit with the reference's code, or raise its exception.
"""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from csmom_tpu.cli.main import main as jax_main
from csmom_tpu_torch.cli.main import PROG
from csmom_tpu_torch.cli.main import main as port_main

torch.set_num_threads(2)

UNIVERSE = os.path.join(os.path.dirname(__file__), "fixtures", "universe")
TICKERS = ",".join(sorted(n.split("_")[0] for n in os.listdir(UNIVERSE)))
BUILTIN = ("high_52w", "intermediate_momentum", "low_volatility", "momentum",
           "residual_momentum", "reversal", "volume_z_momentum", "zscore_combo")

_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _run(main, argv, extra):
    """``(rc, stdout, stderr)`` of ``main(argv + extra)``, or the exception
    it raised in place of rc."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(argv) + list(extra))
        except (SystemExit, KeyError, ValueError) as e:
            rc = e
    return rc, out.getvalue(), err.getvalue()


def _port_text(text):
    """The port's output in the reference's names: program and engine."""
    return (text.replace(PROG, "csmom")
            .replace("monthly spread (torch)", "monthly spread (tpu)"))


def _decimals(tok):
    mant = tok.lower().split("e")[0]
    return len(mant.split(".")[1]) if "." in mant else 0


def assert_same_output(got, want):
    """Line for line; a differing line keeps its text outside the numbers
    and each number within one unit of its last printed digit."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines), (got, want)
    for g, w in zip(g_lines, w_lines):
        if g == w:
            continue
        g_nums, w_nums = _NUM.findall(g), _NUM.findall(w)
        assert "".join(_NUM.split(g)).split() == "".join(_NUM.split(w)).split(), (g, w)
        assert len(g_nums) == len(w_nums), (g, w)
        for a, b in zip(g_nums, w_nums):
            unit = 10.0 ** -max(_decimals(a), _decimals(b))
            assert abs(float(a) - float(b)) <= unit * (1 + 1e-9), (g, w)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The two data directories, each with the common arguments of both
    sides, and the result directories."""
    from csmom_tpu_torch.panel.pack import save_packed
    from csmom_tpu_torch.panel.panel import Panel, PanelBundle
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    d = tmp_path_factory.mktemp("cli")
    daily = synthetic_daily_panel(60, 1260, seed=7, listing_gaps=True)
    vol = np.random.default_rng(70).integers(10_000, 5_000_000,
                                             size=daily.shape).astype(np.float64)
    vol[~daily.mask] = np.nan
    bundle = PanelBundle(
        panels={f: Panel(values=x, mask=daily.mask, tickers=daily.tickers,
                         times=daily.times, name=f)
                for f, x in (("adj_close", daily.values), ("volume", vol))},
        tickers=daily.tickers, times=daily.times)
    pack = str(d / "pack")
    save_packed(bundle, pack)
    sectors = d / "sectors.csv"
    rng = np.random.default_rng(5)
    rows = [f"{t},S{rng.integers(0, 3)}" for t in daily.tickers[:-5]]
    sectors.write_text("ticker,sector\n" + "\n".join(rows) + "\n")
    return {
        "universe": ["--data-dir", UNIVERSE, "--tickers", TICKERS, *_SMALL],
        "pack": ["--data-dir", pack],
        "pack_dir": pack,
        "sectors": str(sectors),
        "ref_out": str(d / "ref"),
        "port_out": str(d / "port"),
        "dir": d,
    }


def _argv(inputs, source, args):
    return [args[0]] + inputs[source] + list(args[1:])


def _both(inputs, argv, outdir=True):
    """Both CLIs on ``argv``: ``(port, reference)`` results."""
    ref = ["--platform", "cpu"] + (["--out", inputs["ref_out"]] if outdir else [])
    port = ["--device", "cpu"] + (["--out", inputs["port_out"]] if outdir else [])
    return _run(port_main, argv, port), _run(jax_main, argv, ref)


# (command and its arguments) by input: the pack (58 months of 60 names)
# runs every flag at the defaults; the universe (23 months of 8 tickers)
# each command once, at J=6 and four bins
_SMALL = ("--lookback", "6", "--n-bins", "4")
COMMANDS = {
    "replicate": ("replicate", "--tables", "--tc-bps", "10", "--band", "1",
                  "--bootstrap", "200", "--tearsheet"),
    "replicate_extras": ("replicate", "--band-sweep", "0,1,2", "--band-select",
                         "0,1,2", "--vol-target", "12", "--tc-bps", "5",
                         "--bootstrap", "100", "--band", "2"),
    "replicate_pandas": ("replicate", "--backend", "pandas", "--tables",
                         "--band", "1"),
    "strategy_momentum": ("replicate", "--strategy", "momentum"),
    "strategy_low_volatility": ("replicate", "--strategy", "low_volatility",
                                "--strategy-arg", "min_obs=6"),
    "strategy_volume_z": ("replicate", "--strategy", "volume_z_momentum"),
    "strategy_residual": ("replicate", "--strategy", "residual_momentum",
                          "--strategy-arg", "est_window=24", "--mode", "rank"),
    "strategy_pandas": ("replicate", "--strategy", "reversal", "--backend", "pandas"),
    "grid": ("grid", "--mode", "rank", "--tc-bps", "5", "--tc-sweep", "0,5,25",
             "--tearsheet"),
    "grid_plain": ("grid", "--impl", "xla", "--js", "3,6", "--ks", "1,3",
                   "--bootstrap", "0"),
    "grid_hist": ("grid", "--mode", "hist", "--impl", "matmul", "--bootstrap", "20",
                  "--block-len", "3"),
    "sweep": ("sweep", "--mode", "rank", "--min-months", "12"),
    "sweep_net": ("sweep", "--tc-bps", "5", "--min-months", "12"),
    "horizons": ("horizons", "--max-h", "12"),
    "horizons_36": ("horizons",),
    "horizons_by_volume": ("horizons", "--by-volume", "--max-h", "24",
                           "--group", "4"),
    "doublesort": ("doublesort", "--tc-bps", "10"),
    "doublesort_rank": ("doublesort", "--turnover-lookback", "6", "--mode", "rank"),
    # no cell has est_window == lookback (ROADMAP.md, known differences)
    "residual": ("residual", "--est-windows", "15,24,36", "--tearsheet",
                 "--sweep", "--min-months", "12"),
    "replicate_plain": ("replicate",),
    "grid_small": ("grid", "--mode", "rank", "--js", "3,6", "--ks", "1,3",
                   "--bootstrap", "0"),
}
# the commands that print tables run in test_torch_cli_tables.py, so the
# two halves (each compiling the reference's engines anew) can run apart
TABLE_COMMANDS = ("grid", "grid_plain", "grid_hist", "sweep", "sweep_net", "horizons",
                  "horizons_36", "horizons_by_volume", "doublesort", "doublesort_rank",
                  "residual", "grid_small")
UNIVERSE_COMMANDS = ("replicate_plain", "grid_small", "sweep", "horizons",
                     "doublesort_rank")
CASES = ([("pack", n) for n in COMMANDS
          if n not in TABLE_COMMANDS and n != "replicate_plain"]
         + [("universe", n) for n in UNIVERSE_COMMANDS if n not in TABLE_COMMANDS])


def command_outputs(inputs, cases):
    """Every case's (port, reference) results, run once."""
    return {(src, name): _both(inputs, _argv(inputs, src, COMMANDS[name]))
            for src, name in cases}


@pytest.fixture(scope="module")
def outputs(inputs):
    return command_outputs(inputs, CASES)


def check_case(outputs, src, name):
    (p_rc, p_out, _), (r_rc, r_out, _) = outputs[src, name]
    assert r_rc == 0 and p_rc == 0
    assert_same_output(_port_text(p_out), r_out)


@pytest.mark.parametrize("src,name", CASES, ids=[f"{s}-{n}" for s, n in CASES])
def test_command_prints_what_the_reference_prints(outputs, src, name):
    check_case(outputs, src, name)


def _unfused_strategy_backtest(prices, mask, strategy, n_bins=10, mode="qcut",
                               freq=12, impl="xla", sector_ids=None,
                               n_sectors=None, **panels):
    """The reference's strategy engine with its signal evaluated on its own
    (csmom_tpu's functions, not fused into one program)."""
    from csmom_tpu.backtest.monthly import _assemble_result
    from csmom_tpu.ops.ranking import decile_assign_panel
    from csmom_tpu.signals.momentum import monthly_returns

    ret, ret_valid = monthly_returns(prices, mask)
    score, valid = strategy.signal(prices, mask, **panels)
    labels, _ = decile_assign_panel(score, valid, n_bins=n_bins, mode=mode)
    return _assemble_result(ret, ret_valid, labels, n_bins, freq, impl=impl)


@pytest.mark.parametrize("src", ["pack", "universe"])
def test_zscore_combo_prints_what_the_reference_prints(inputs, src, monkeypatch):
    """The combo ranks a score that lands data points exactly on qcut's bin
    edges; the reference's fused engine assigns some of them to the other
    bin than its own signal and ranking do (ROADMAP.md, known differences),
    so the reference side runs them one after the other."""
    import csmom_tpu.strategy

    monkeypatch.setattr(csmom_tpu.strategy, "strategy_backtest",
                        _unfused_strategy_backtest)
    argv = _argv(inputs, src, ("replicate", "--strategy", "zscore_combo",
                               "--strategy-arg",
                               "components=momentum:0.6,reversal:0.4"))
    (p_rc, p_out, _), (r_rc, r_out, _) = _both(inputs, argv)
    assert p_rc == r_rc == 0
    assert p_out.startswith("strategy: ZScoreCombo(components=((Momentum(lookback=")
    assert_same_output(_port_text(p_out), r_out)


def test_sector_map_prints_what_the_reference_prints(inputs):
    argv = _argv(inputs, "pack", ("replicate", "--sector-map", inputs["sectors"],
                                  "--strategy", "momentum", "--tc-bps", "10"))
    (p_rc, p_out, _), (r_rc, r_out, _) = _both(inputs, argv)
    assert p_rc == r_rc == 0
    assert "sector-neutral ranking: 3 sectors (signal: momentum)" in p_out
    assert_same_output(_port_text(p_out), r_out)


@pytest.mark.parametrize("args", [
    ("grid", "--tc-sweep", "0,5"),
    ("replicate", "--band", "5"),
    ("replicate", "--band-select", "1"),
    ("replicate", "--band-sweep", "0,x"),
    ("replicate", "--vol-target", "-3"),
    ("replicate", "--sector-map", "{nomatch}"),
    ("replicate", "--sector-map", "{sectors}", "--backend", "pandas"),
    ("replicate", "--strategy", "no_such_strategy"),
], ids=["tc_sweep_alone", "band", "band_select_one", "band_sweep_text",
        "vol_target", "sector_map_nomatch", "sector_map_pandas", "unknown_strategy"])
def test_error_paths_match_the_reference(inputs, args):
    nomatch = inputs["dir"] / "nomatch.csv"
    nomatch.write_text("ticker,sector\nNOPE,S0\n")
    args = [a.format(nomatch=nomatch, sectors=inputs["sectors"]) for a in args]
    (p_rc, _, p_err), (r_rc, _, r_err) = _both(inputs, _argv(inputs, "pack", args))
    if isinstance(r_rc, BaseException):
        assert type(p_rc) is type(r_rc)
        if isinstance(r_rc, KeyError):
            assert str(p_rc).startswith("\"unknown strategy 'no_such_strategy'")
            assert str(r_rc).startswith("\"unknown strategy 'no_such_strategy'")
        else:
            assert str(p_rc) == str(r_rc)
    else:
        assert p_rc == r_rc != 0
        assert p_err.strip() and r_err.strip()


def _builtin_blocks(text):
    """The ``strategies`` listing cut to the built-in entries (the reference's
    registry also holds what other test modules registered)."""
    lines = text.splitlines()
    keep, blocks = False, []
    for line in lines:
        if not line.startswith(" "):
            keep = line.split("(")[0] in BUILTIN
        if keep:
            blocks.append(line)
    return blocks, lines[-1]


def test_strategies_and_pack_info_print_what_the_reference_prints(inputs):
    (p_rc, p_out, _), (r_rc, r_out, _) = _both(inputs, ["strategies"], outdir=False)
    assert p_rc == r_rc == 0
    assert _builtin_blocks(_port_text(p_out)) == _builtin_blocks(r_out)
    assert len(_builtin_blocks(p_out)[0]) == 2 * len(BUILTIN)
    p = _run(port_main, ["pack-info", inputs["pack_dir"]], [])
    r = _run(jax_main, ["pack-info", inputs["pack_dir"]], [])
    assert p[0] == r[0] == 0 and p[1] == r[1]
    assert "field volume: dtype float64" in p[1]
    p = _run(port_main, ["pack-info", str(inputs["dir"])], [])
    r = _run(jax_main, ["pack-info", str(inputs["dir"])], [])
    assert p[0] == r[0] == 2 and p[2] == r[2]


@pytest.fixture
def no_network(monkeypatch):
    """Every vendor fetcher of both packages raises: a cache miss fails
    without a network call."""
    import csmom_tpu.panel.fetch as jf
    import csmom_tpu_torch.panel.fetch as tf

    def refuse(*a, **k):
        raise RuntimeError("no network in tests")

    for mod in (jf, tf):
        monkeypatch.setattr(mod, "_default_daily_fetcher", refuse)
        monkeypatch.setattr(mod, "_default_intraday_fetcher", refuse)


def test_fetch_cache_hit_and_miss(inputs, tmp_path, no_network):
    cache = tmp_path / "cache"
    cache.mkdir()
    for t in ("SYNAA", "SYNBB"):
        shutil.copy(os.path.join(UNIVERSE, f"{t}_daily.csv"), cache)
    hit = ["fetch", "--data-dir", str(cache), "--tickers", "synaa,SYNBB",
           "--kind", "daily"]
    p, r = _run(port_main, hit, ["--device", "cpu"]), _run(jax_main, hit, ["--platform", "cpu"])
    assert p[0] == r[0] == 0 and p[1] == r[1]
    assert p[1].startswith("daily: 2/2 tickers cached in")
    # the cache packed, each side into its own directory, in f64 and f32
    for f32 in ([], ["--pack-f32"]):
        pp, rp = _run(port_main, hit + ["--pack", str(tmp_path / "pp")] + f32, []), \
            _run(jax_main, hit + ["--pack", str(tmp_path / "rp")] + f32, [])
        assert pp[0] == rp[0] == 0
        assert pp[1].replace(str(tmp_path / "pp"), "P") == rp[1].replace(str(tmp_path / "rp"), "P")
        pi = _run(port_main, ["pack-info", str(tmp_path / "pp")], [])
        ri = _run(jax_main, ["pack-info", str(tmp_path / "rp")], [])
        assert pi[1].replace(str(tmp_path / "pp"), "P") == ri[1].replace(str(tmp_path / "rp"), "P")
        assert ("dtype float32" in pi[1]) == bool(f32)
        shutil.rmtree(tmp_path / "pp")
        shutil.rmtree(tmp_path / "rp")
    miss = ["fetch", "--data-dir", str(tmp_path / "empty"), "--tickers", "ZZZZ",
            "--kind", "daily"]
    p, r = _run(port_main, miss, []), _run(jax_main, miss, [])
    assert p[0] == r[0] == 1 and p[1] == r[1]
    assert "daily: 0/1" in p[1]
    # a partial fetch does not pack
    p = _run(port_main, miss + ["--pack", str(tmp_path / "no")], [])
    r = _run(jax_main, miss + ["--pack", str(tmp_path / "no")], [])
    assert p[0] == r[0] == 1 and not os.path.exists(tmp_path / "no")


def test_default_device_exits_2_without_a_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for argv in (["replicate"], ["grid"], ["horizons", "--by-volume"], ["intraday"],
                 ["run"]):
        rc, out, err = _run(port_main, argv + inputs["universe"], [])
        assert rc == 2 and out == ""
        assert "--device cpu" in err


def test_multi_device_flags_exit_2_naming_the_roadmap(inputs):
    """``--mode rank_hist`` is the grid's alone (exit 2 naming the form
    to use), as in the reference; ``grid --shards N`` runs (its tables in
    ``test_torch_parallel_cli.py``)."""
    rc, out, err = _run(port_main, ["replicate", "--mode", "rank_hist"]
                        + inputs["universe"], ["--device", "cpu"])
    assert rc == 2 and out == ""
    assert "grid --shards N --mode rank_hist" in err


def test_config_backend_tpu_means_the_card_engine(inputs, tmp_path):
    cfg = tmp_path / "run.toml"
    cfg.write_text('backend = "tpu"\n[momentum]\nlookback = 12\n')
    argv = ["replicate", "--config", str(cfg), "--tearsheet"] + inputs["pack"]
    (p_rc, p_out, _), (r_rc, r_out, _) = _both(inputs, argv)
    assert p_rc == r_rc == 0
    assert "-- tearsheet: monthly spread (torch) --" in p_out
    assert_same_output(_port_text(p_out), r_out)
    again = _run(port_main, argv, ["--device", "cpu", "--backend", "torch",
                                   "--out", inputs["port_out"]])
    assert again[1] == p_out


def test_help_lists_the_ported_commands():
    rc, out, _ = _run(port_main, [], [])
    assert rc == 0
    assert "subcommands (18):" in out
    for name in ("doublesort", "fetch", "fleet", "grid", "horizons", "intraday",
                 "loadgen", "pack-info", "registry", "replay", "replicate",
                 "residual", "run", "serve", "strategies", "sweep", "trace",
                 "warmup"):
        assert f"\n  {name}" in out


def test_replicate_without_matplotlib_prints_the_same_and_writes_no_plot(
        inputs, tmp_path, monkeypatch, caplog):
    """Where matplotlib is not installed the tables are printed all the
    same and the plot is left out, with a warning naming it."""
    import importlib.util

    argv = ["replicate", "--device", "cpu"] + inputs["universe"]
    with_plot = _run(port_main, argv, ["--out", str(tmp_path / "a")])
    assert (tmp_path / "a" / "monthly_mom_cum.png").exists()
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    without = _run(port_main, argv, ["--out", str(tmp_path / "b")])
    assert without[0] == with_plot[0] == 0 and without[1] == with_plot[1]
    assert not (tmp_path / "b").exists()
    assert "matplotlib is not installed: monthly_mom_cum.png not written" in caplog.text


INTRADAY_TICKERS = ("IAA", "IBB", "ICC", "IDD", "IEE", "IFF")


def _write_intraday_cache(d):
    """Daily CSVs (IFF in the second dialect, which the reference's own
    loader loses) and minute CSVs in the reference's naming."""
    import pandas as pd

    from csmom_tpu_torch.api import synthetic_minute_frame
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(len(INTRADAY_TICKERS), 300, seed=11)
    stamps = pd.DatetimeIndex(daily.times).strftime("%Y-%m-%d")
    rng = np.random.default_rng(12)
    for i, t in enumerate(INTRADAY_TICKERS):
        v = daily.values[i]
        vol = rng.integers(200_000, 2_000_000, len(v))
        if t == "IFF":
            rows = "\n".join(f"{dd},{c:.6f},{c * 1.01:.6f},{c * 0.99:.6f},{c:.6f},{n}"
                             for dd, c, n in zip(stamps, v, vol))
            (d / f"{t}_daily.csv").write_text(
                f"Price,Close,High,Low,Open,Volume\nTicker,{t},{t},{t},{t},{t}\n"
                f"Date,,,,,\n{rows}\n")
        else:
            pd.DataFrame({"date": stamps, "open": v * 0.998, "high": v * 1.01,
                          "low": v * 0.99, "close": v, "adj_close": v,
                          "volume": vol}).to_csv(d / f"{t}_daily.csv", index=False)
    last = pd.DataFrame({"date": np.repeat(daily.times[-3:], len(INTRADAY_TICKERS)),
                         "ticker": np.tile(INTRADAY_TICKERS, 3),
                         "open": daily.values[:, -3:].T.ravel() * 0.998,
                         "close": daily.values[:, -3:].T.ravel(), "volume": 1e6})
    minutes = synthetic_minute_frame(last, seed=2)
    minutes = minutes[rng.random(len(minutes)) > 0.04]
    for t, g in minutes.groupby("ticker"):
        pd.DataFrame({"datetime": g["datetime"].dt.strftime("%Y-%m-%d %H:%M:%S"),
                      "open": g["price"], "high": g["price"], "low": g["price"],
                      "close": g["price"], "volume": g["volume"]}).to_csv(
            d / f"{t}_intraday.csv", index=False)


@pytest.fixture(scope="module")
def intraday_cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("intraday_cache")
    _write_intraday_cache(d)
    return ["--data-dir", str(d), "--tickers", ",".join(INTRADAY_TICKERS)], d


INTRADAY_COMMANDS = {
    **{m: ("intraday", "--model", m)
       for m in ("ridge", "online_ridge", "elastic_net", "lasso", "mlp")},
    "flags": ("intraday", "--threshold-sweep", "1e-6,1e-5,1e-4", "--threshold-hi",
              "1e-4", "--threshold-lo", "2e-5", "--latency-bars", "2", "--tearsheet"),
    "parity": ("intraday", "--parity", "--alpha", "3", "--l1-ratio", "0.7"),
    "run": ("run", "--lookback", "6", "--n-bins", "4"),
}


def _intraday_text(text, port_dir, ref_dir):
    """The port's output in the reference's words: its program name, its
    results directory, and the sweep's header (the port runs the engine
    once a threshold where the reference vmaps it)."""
    return (_port_text(text).replace(str(port_dir), str(ref_dir))
            .replace("(one engine run a threshold)", "(one vmapped call)"))


@pytest.mark.parametrize("name", list(INTRADAY_COMMANDS))
def test_intraday_and_run_print_what_the_reference_prints(intraday_cache, name):
    import pandas as pd

    args, d = intraday_cache
    port_dir, ref_dir = d / f"port_{name}", d / f"ref_{name}"
    argv = list(INTRADAY_COMMANDS[name][:1]) + args + list(INTRADAY_COMMANDS[name][1:])
    p = _run(port_main, argv, ["--device", "cpu", "--out", str(port_dir)])
    r = _run(jax_main, argv, ["--platform", "cpu", "--out", str(ref_dir)])
    assert p[0] == r[0] == 0, (p, r)
    assert_same_output(_intraday_text(p[1], port_dir, ref_dir), r[1])
    assert "Trades:" in p[1] and "Costs:" in p[1]
    logs = ["trades.csv"] + (["trades_hysteresis.csv"] if name == "flags" else [])
    for log_name in logs:
        got = pd.read_csv(port_dir / log_name)
        want = pd.read_csv(ref_dir / log_name)
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("args", [
    ("--latency-bars", "-1"),
    ("--threshold-hi", "1e-4"),
    ("--threshold-hi", "1e-5", "--threshold-lo", "1e-4"),
    ("--data-dir", "{pack}"),
], ids=["negative_latency", "hi_without_lo", "lo_above_hi", "packed_data_dir"])
def test_intraday_error_paths_match_the_reference(intraday_cache, inputs, args):
    cache_args, d = intraday_cache
    args = [a.format(pack=inputs["pack_dir"]) for a in args]
    argv = ["intraday"] + cache_args + args
    p = _run(port_main, argv, ["--device", "cpu", "--out", str(d / "err_port")])
    r = _run(jax_main, argv, ["--platform", "cpu", "--out", str(d / "err_ref")])
    assert p[0] == r[0] == 2
    assert p[2].strip().splitlines()[-1] == r[2].strip().splitlines()[-1]
    assert_same_output(p[1], r[1])
