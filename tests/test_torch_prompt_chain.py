"""The prompt-chain rollout (``portbench/programs/prompt_chain.py``, the
``prompt-chain`` cell's program) on the turbo engine's plain step, on the
CPU: at the widths the normal entry sizes for it, which its configuration
writes out, the exported states of rows resumed from the traffic's states
equal the plain reference's after every launch, through the summarization;
and every string stays within its slot."""

import dataclasses
import json
from pathlib import Path

import pytest

from interpolation_engine_tpu_torch._shared import planner
from interpolation_engine_tpu_torch.vm.turbo import (TurboConfig,
                                                     TurboEngine,
                                                     base_config)
from portbench import run
from portbench.programs import prompt_chain
from portbench.reference import Machine

BENCH = Path(run.__file__).resolve().parent
CONFIG = json.loads((BENCH / "configs" / "prompt-chain.turbo.json")
                    .read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "resumed-prompt-chain.json")
                     .read_text())
TEXT = run.program_text(TRAFFIC)
TCFG = TurboConfig(**CONFIG["turbo_config"])
# the strata are room-major, then task (12), then history length (1-9)
TASKS = TRAFFIC["strata"]["at"]


def compiled():
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader, validator)
    program = json5.loads(loader.add_line_numbers(TEXT))
    validator.validate_program(program)
    return compile_program(program)


def states(seed: int = 2**31 + 41) -> list:
    return run.start_states(TRAFFIC, TEXT, seed)


def pick(all_states, room: int, task: int, hlen: int, variant: int = 0):
    k = (room * len(TASKS) + TASKS.index(task)) * 9 + hlen - 1
    return all_states[k + variant * len(all_states) // 2]


def test_the_literals_have_the_sizes_the_program_states():
    assert len(prompt_chain.STORY) == 640
    assert [len(r) for r in prompt_chain.ROOMS] == [224] * 6
    assert "{" not in prompt_chain.STORY + "".join(prompt_chain.ROOMS)


def test_the_configuration_is_what_the_entry_sizes():
    """``turbo_config`` written out is ``base_config`` of the program: its
    longest literal (the story and the prompt's first glue, 656 bytes)
    passes width 512."""
    plan = planner.plan_turbo(compiled())
    assert dataclasses.asdict(base_config(plan)) == CONFIG["turbo_config"]
    assert TCFG.width == 2048 and TCFG.elem_width == 512


def test_the_traffic_covers_every_top_level_task_but_the_summary():
    labels = Machine(TEXT).labels
    for r in range(6):
        at = labels[f"@room-{r}"]
        top = [k - at for k in range(at + 1, labels[f"@hop-{r}"] + 2)
               if "name" not in Machine(TEXT).order[k]]
        assert [k for k in top if k not in (10, 11)] == TASKS
    assert len(states()) == 6 * len(TASKS) * 9 * 2


def test_every_string_stays_within_its_slot_at_a_six_digit_turn():
    """From every stratum's state with its turn at 999,990, through two
    room visits each: the prompt under the slot width, a reply under the
    element width, and the output under half the output row between
    ``clear``s, so that no row parks."""
    longest = {"prompt": 0, "reply": 0, "output": 0}
    for st in states()[::5]:
        st = dict(st, inserts=dict(st["inserts"], turn=999_990))
        m = Machine(TEXT, state=st)
        for _ in range(40):
            m.step()
            for key in ("prompt", "reply"):
                longest[key] = max(longest[key],
                                   len(m.inserts.get(key, "").encode()))
            longest["output"] = max(longest["output"],
                                    len(m.output.encode()))
    assert 1_700 < longest["prompt"] < TCFG.width
    assert 450 < longest["reply"] < TCFG.elem_width
    assert longest["output"] < TCFG.out_width // 2


@pytest.fixture(scope="module")
def engine():
    return TurboEngine(compiled(), TCFG, device="cpu")


def test_the_plain_step_equals_the_reference_through_the_summary(engine):
    """24 rows from the traffic's states, in every room and at every task,
    with histories that reach 10 in the first launch (at the append, the
    length, its dispatch) or later, over four launches of the
    configuration's 32 steps: each row's exported state equals the
    reference's after every launch, and rows that pass the summarization
    (their history trimmed to 5) are among them."""
    all_states = states()
    picks = [pick(all_states, r, t, h, v) for r, t, h, v in [
        (0, 1, 9, 0), (1, 6, 9, 1), (2, 7, 9, 0), (3, 8, 9, 1),
        (4, 5, 9, 0), (5, 4, 8, 1), (0, 13, 9, 1), (1, 17, 2, 0),
        (2, 2, 1, 1), (3, 3, 5, 0), (4, 14, 7, 1), (5, 15, 3, 0),
        (0, 17, 9, 0), (1, 1, 4, 1), (2, 13, 6, 0), (3, 14, 8, 1),
        (4, 2, 9, 1), (5, 6, 5, 0), (0, 3, 7, 1), (1, 4, 2, 0),
        (2, 15, 9, 0), (3, 7, 1, 1), (4, 8, 6, 0), (5, 5, 4, 1)]]
    batch = engine.load_batch(picks)
    machines = [Machine(TEXT, state=s) for s in picks]
    step = engine.step_fn(len(picks))
    trimmed = set()
    for launch in range(4):
        batch = step(batch)
        for i, m in enumerate(machines):
            for _ in range(TCFG.k_steps):
                if m.lane is None and m.order[m.k]["cmd"] == "list_slice":
                    trimmed.add(i)
                m.step()
            assert engine.export_state(batch, i) == m.export(), (launch, i)
    assert len(trimmed) >= 8
