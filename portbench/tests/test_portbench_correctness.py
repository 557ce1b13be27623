"""What decides ``correct``: the control comes out not correct, and so
does a run whose timed path is broken underneath, on the CPU at a small
batch. The card runs the same at each cell's own size
(``test_portbench_card.py``)."""

import pytest

from portbench import run
from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
from interpolation_engine_tpu_torch.vm.state import T_INT
from interpolation_engine_tpu_torch.vm.turbo import TurboEngine


def unchanged(step, batch, cols):
    return batch


def half_left_out(step, batch, cols):
    """The step on the first half of the rows; the second half keeps its
    state."""
    keep = [t.clone() for t in batch]
    out = step(batch)
    for name, t, k in zip(out._fields, out, keep):
        if name in ("sbuf", "meta"):     # the turbo engine's (R, n, W)
            n = t.shape[1]
            t[:, n // 2:] = k[:, n // 2:]
        else:
            n = t.shape[0]
            t[n // 2:] = k[n // 2:]
    return out


def altered(step, batch, cols):
    """The step, then every integer that every row holds one more: an
    answer altered where the step produces it."""
    out = step(batch)
    if cols is None:                     # the general engine
        out.vint.add_((out.vtype == T_INT).to(out.vint.dtype))
    else:                                # the turbo engine's registers
        s0, S = cols.stype(0), cols.S
        types, ints = out.regs[:, s0:s0 + S], out.regs[:, s0 + S:s0 + 2 * S]
        ints.add_((types == T_INT).to(ints.dtype))
    return out


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "altered": altered}


def break_engines(monkeypatch, fault):
    make = TurboEngine.step_fn

    def step_fn(self, n):
        step = make(self, n)
        return lambda batch: FAULTS[fault](step, batch, self.cols)
    monkeypatch.setattr(TurboEngine, "step_fn", step_fn)
    launch = DeviceRunner.launch

    def broken_launch(self, batch, steps):
        return FAULTS[fault](lambda b: launch(self, b, steps), batch, None)
    monkeypatch.setattr(DeviceRunner, "launch", broken_launch)


@pytest.mark.parametrize("cell", ["adventure", "general"])
def test_sound_runs_are_correct(cell):
    line = run.run_cell(cell, 2**31 + 17, 0.3, False, device="cpu",
                        instances=8)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", ["adventure", "general"])
def test_the_control_is_not_correct(cell):
    """The reference at 16-bit integers in the program's place."""
    line = run.run_cell(cell, 2**31 + 17, 0.3, False, device="cpu",
                        instances=8, control_bits=16)
    assert not line["correct"]
    assert line["checks"]["sample_unlike_reference"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["adventure", "general"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    break_engines(monkeypatch, fault)
    line = run.run_cell(cell, 2**31 + 23, 0.05, False, device="cpu",
                        instances=8)
    assert not line["correct"], (fault, line["checks"])


def test_the_exchange_between_chips_has_no_fault_to_plant():
    """Every cell runs on one chip: no exchange between chips exists."""
    import json
    bench = json.loads((run.BENCHMARK).read_text())
    assert {w["chips"] for w in bench["workloads"]} == {1}
