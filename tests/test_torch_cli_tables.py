"""The port's table-printing CLI commands (``grid``, ``sweep``,
``horizons``, ``doublesort``, ``residual``) against ``csmom``'s, in-process
on the inputs and under the comparison rule of ``test_torch_cli.py``: the
text line for line after mapping the program name and engine label, each
number within one unit of its last printed digit."""

import pytest
import torch

from test_torch_cli import (  # noqa: F401  (inputs is a fixture)
    TABLE_COMMANDS,
    UNIVERSE_COMMANDS,
    check_case,
    command_outputs,
    inputs,
)

torch.set_num_threads(2)

CASES = ([("pack", n) for n in TABLE_COMMANDS
          if n not in ("grid_small", "horizons", "doublesort_rank")]
         + [("universe", n) for n in UNIVERSE_COMMANDS if n in TABLE_COMMANDS])


@pytest.fixture(scope="module")
def outputs(inputs):  # noqa: F811
    return command_outputs(inputs, CASES)


@pytest.mark.parametrize("src,name", CASES, ids=[f"{s}-{n}" for s, n in CASES])
def test_table_command_prints_what_the_reference_prints(outputs, src, name):
    check_case(outputs, src, name)
