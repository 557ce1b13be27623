"""What decides ``correct`` in the cells ``prompt-chain`` and
``lockstep``, on the CPU at a small batch: a sound run is correct, and the
control and the planted faults of ``test_portbench_correctness.py`` are
not. The card runs the same at each cell's own size
(``test_portbench_card_prompt_chain_and_lockstep.py``)."""

import pytest

from portbench import run
from portbench.tests.test_portbench_correctness import FAULTS, break_engines

CELLS = ["prompt-chain", "lockstep"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
    line = run.run_cell(cell, 2**31 + 17, 0.3, False, device="cpu",
                        instances=8)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert set(line["metrics"]) == {"tasks_per_s", "round_p95_ms",
                                    "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference at 16-bit integers in the program's place."""
    line = run.run_cell(cell, 2**31 + 17, 0.3, False, device="cpu",
                        instances=8, control_bits=16)
    assert not line["correct"]
    assert line["checks"]["sample_unlike_reference"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    break_engines(monkeypatch, fault)
    line = run.run_cell(cell, 2**31 + 23, 0.05, False, device="cpu",
                        instances=8)
    assert not line["correct"], (fault, line["checks"])


def test_lockstep_starts_every_row_from_one_fresh_state():
    """One state: the spine's default, at order index 1, but for its
    score, drawn from the seed in 100,000-998,999."""
    import json
    from portbench.programs import adventure
    from portbench.reference import parse_json5
    traffic = run.load_cell("lockstep")["traffic"]
    text = run.program_text(traffic)
    default = parse_json5(adventure.source())["default_state"]
    for seed in (3, 2**31 + 5, 2**33 + 1):
        (state,) = run.start_states(traffic, text, seed)
        assert state["order_index"] == default["order_index"] == 1
        assert 100_000 <= state["inserts"]["acc"] < 999_000
        assert dict(state["inserts"], acc=0) == default["inserts"]
    assert json.loads(json.dumps(state)) == state
