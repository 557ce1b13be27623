"""The cells ``prompt-chain`` and ``lockstep`` on the card: each proves
correct at its own size, and its control, the reference at 16-bit integers
in the program's place, does not. Run on one H100 with ``python -m pytest
portbench/tests -m cuda -s``; without a card these skip."""

import json

import pytest

from portbench import run

pytestmark = pytest.mark.cuda
CELLS = ["prompt-chain", "lockstep"]


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_on_the_card(cell):
    card()
    line = run.run_cell(cell, 2**31 + 103, 2.0, False)
    print(cell, json.dumps(line))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("seed", [2**31 + 7, 2**32 + 11, 3**20])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, seed):
    """At the cell's own size and load, over a short window that checks
    as many rows as a run does."""
    card()
    line = run.run_cell(cell, seed, 5.0, False, control_bits=16)
    print(cell, seed, "control", json.dumps(line["checks"]))
    assert not line["correct"]
