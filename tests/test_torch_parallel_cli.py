"""``grid --shards N`` and ``--mode rank_hist`` on logical CPU shards
against ``csmom grid --shards N`` on the suite's host devices, in-process,
under ``test_torch_cli.py``'s comparison rule (the text line for line,
each number within one unit of its last printed digit)."""

import pytest
import torch

from test_torch_cli import (  # noqa: F401  (inputs is a fixture)
    _argv,
    _both,
    _port_text,
    _run,
    assert_same_output,
    inputs,
)
from csmom_tpu_torch.cli.main import main as port_main

torch.set_num_threads(2)

CASES = {
    "shards_rank": ("universe", ("grid", "--shards", "2", "--mode", "rank",
                                 "--js", "3,6", "--ks", "1,3", "--bootstrap", "0")),
    "rank_hist": ("pack", ("grid", "--mode", "rank_hist", "--js", "3,6,9,12",
                           "--ks", "1,3", "--bootstrap", "20", "--tc-bps", "5")),
    "shards_qcut_net": ("pack", ("grid", "--shards", "4", "--js", "6,12",
                                 "--ks", "1,3,6", "--tc-bps", "5",
                                 "--bootstrap", "0")),
    "shards_hist": ("universe", ("grid", "--shards", "2", "--mode", "hist",
                                 "--js", "3,6", "--ks", "1,3", "--bootstrap", "0")),
}


@pytest.fixture(scope="module")
def outputs(inputs):  # noqa: F811
    return {name: _both(inputs, _argv(inputs, src, args))
            for name, (src, args) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_grid_prints_what_the_reference_prints(outputs, name):
    (p_rc, p_out, p_err), (r_rc, r_out, r_err) = outputs[name]
    assert r_rc == 0 and p_rc == 0, (p_err, r_err)
    assert_same_output(_port_text(p_out), r_out)
    if name == "rank_hist":
        assert "no rank_hist form" in p_err and "no rank_hist form" in r_err
    if name == "shards_hist":
        assert "labels are identical to rank" in p_err


def test_shards_above_the_visible_cards_exit_2(inputs, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _run(port_main, ["grid", "--shards", "3"] + inputs["pack"],
                        ["--device", "cuda"])
    assert rc == 2 and out == ""
    assert "--shards 3 exceeds the 1 visible device(s)" in err
    assert "--device cpu" in err
