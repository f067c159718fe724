"""The port's run configuration against csmom_tpu's: defaults, a TOML with
every table, and the refusals of unknown keys give equal results."""

import dataclasses

import pytest

from csmom_tpu import config as jconfig
from csmom_tpu_torch import config
from csmom_tpu_torch import load_config as lazy_load_config

FULL = """
results_dir = "out"
backend = "gpu"

[universe]
tickers = ["AAA", "BBB", "CCC"]
start = "2019-01-01"
end = "2020-12-31"
data_dir = "cache"

[momentum]
lookback = 6
skip = 0
n_bins = 5
mode = "rank"
holding = 3
turnover_lookback = 6

[grid]
Js = [3, 6]
Ks = [1, 12]
walk_forward_min_months = 36

[costs]
impact_k = 0.2
impact_expo = 0.6
spread = 0.002
half_spread_monthly = 0.001

[intraday]
window_minutes = 15
n_splits = 4
alpha = 0.5
train_frac = 0.6
size_shares = 100
threshold = 2e-5
cash0 = 500000.0
"""


def test_defaults_equal():
    assert dataclasses.asdict(config.RunConfig()) == dataclasses.asdict(jconfig.RunConfig())
    assert config.DEFAULT_TICKERS == jconfig.DEFAULT_TICKERS
    assert lazy_load_config is config.load_config


@pytest.mark.parametrize("text", [FULL, "[momentum]\nlookback = 9\n", "",
                                  '[universe]\nstart = "2001-01-01"\n'])
def test_toml_loads_equal(tmp_path, text):
    p = tmp_path / "run.toml"
    p.write_text(text)
    got, want = config.load_config(str(p)), jconfig.load_config(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got.grid.Js, tuple)


@pytest.mark.parametrize("text,match", [
    ("[momentum]\nlookbak = 9\n", r"unknown key\(s\) \['lookbak'\] in \[momentum\]"),
    ("resultsdir = 'x'\n", r"unknown top-level key\(s\) \['resultsdir'\]"),
    ("[costs]\nspred = 1.0\nspread = 2.0\n", r"\['spred'\] in \[costs\]"),
])
def test_unknown_keys_raise_as_the_reference(tmp_path, text, match):
    p = tmp_path / "bad.toml"
    p.write_text(text)
    with pytest.raises(ValueError, match=match) as got:
        config.load_config(str(p))
    with pytest.raises(ValueError) as want:
        jconfig.load_config(str(p))
    assert str(got.value) == str(want.value)
