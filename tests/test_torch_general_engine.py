"""The port's general engine against the JAX package's DeviceRunner on the
CPU, field for field after every launch, through both rings; then at DONE
against the exact host engine. The bench's programs (cut to a few loop
turns), ``for`` loops and parallel_wait/parallel_race blocks.

JAX runs its eager mode: the same state after each launch as its jit mode
(instances do not interact), with handlers compiled once per VMConfig."""

import numpy as np
import pytest
import torch

import bench
import test_turbo_eligibility as te
import torch_programs as tp
from torch_helpers import (ANSWERS, GEN_CFG, assert_same_state, compile_port,
                           general_pair, jax_snapshot, prog, run_general_both,
                           run_host)

from interpolation_engine_tpu.vm.config import DONE, PARKED, RUNNING
from interpolation_engine_tpu_torch._shared import isa, planner
from interpolation_engine_tpu_torch.ops import interp_kernel as ik
from interpolation_engine_tpu_torch.vm import driver
from interpolation_engine_tpu_torch.vm import state as port_state


PROGRAMS = tp.general_programs(bench)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_equals_jax_after_every_launch_and_host_at_done(name, tmp_path,
                                                        capsys):
    src = PROGRAMS[name]
    out = run_general_both(src, n=2)
    assert out is not None
    jres, pres, _runner = out
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    want = (host["output"], dict(host["inserts"]))
    for j, p in zip(jres, pres):
        assert p.status == DONE
        assert (p.output, p.inserts, p.steps) == (j.output, j.inserts,
                                                  j.steps)
        assert (p.output, p.inserts) == want


def test_ring_parks_and_capacity_parks_counted():
    """The ring program parks on user_input three times per instance; the
    adventure's 1,024-byte arena fills every few turns (capacity parks)."""
    _, _, ring = run_general_both(PROGRAMS["ring"], n=2)
    assert ring.ring_stats["parks"] == 6
    _, _, adv = run_general_both(PROGRAMS["adventure"], n=2)
    assert adv.ring_stats["capacity_parks"] >= 4
    assert adv.ring_stats["parks"] > adv.ring_stats["capacity_parks"]


def test_output_past_out_size_raises_the_jax_error():
    """An output that outgrows out_size parks as a capacity park, and the
    ring's re-encode cannot hold it either: both engines raise the same
    HostCodecError, after the same launches."""
    jr, pr = general_pair(tp.OUTPUT_OVERFLOW)
    assert run_general_both(tp.OUTPUT_OVERFLOW, n=2) is None
    jb = jr.make_instances(2)
    with pytest.raises(port_state.HostCodecError,
                       match="output buffer overflow while encoding"):
        pr.run(port_state.from_jax(jb._asdict()), inner_steps=16)
    assert pr.snaps[-1]["last_err"].tolist() == [ik.ERR_CAPACITY] * 2


def test_non_running_rows_are_masked_and_pcs_grouped():
    """A batch out of lockstep: one row PARKED, one DONE, one at another
    pc. One launch of each engine from that state leaves the same
    batch."""
    jr, pr = general_pair(PROGRAMS["adventure"])
    jb = jr.make_instances(4)
    status = np.asarray(jb.status).copy()
    pc = np.asarray(jb.pc).copy()
    status[1], status[2] = PARKED, DONE
    pc[3] = 3
    jb = jb._replace(status=jb.status.at[:].set(status),
                     pc=jb.pc.at[:].set(pc))
    pb = port_state.from_jax(jb._asdict())
    for k in range(3):
        jb = jr._jitted(jb, 5)
        pb = pr.launch(pb, 5)
        assert_same_state(jax_snapshot(jb), pb.to_numpy(), f"launch {k}")
    assert int(pb.steps[1]) == int(pb.steps[2]) == 0


def test_lane_yield_only_in_programs_with_parallel_blocks():
    _, spine = general_pair(PROGRAMS["spine"])
    _, par = general_pair(PROGRAMS["par_race"])
    assert not spine.step.has_threads
    assert par.step.has_threads


def test_launch_leaves_its_input_unchanged():
    """Steps are functional, as the JAX step is: a launch returns a new
    batch and the ring's gathered rows stay valid."""
    _, pr = general_pair(PROGRAMS["adventure"])
    b0 = pr.make_instances(3)
    before = b0.to_numpy()
    b1 = pr.launch(b0, 8)
    assert_same_state(before, b0.to_numpy(), "input")
    assert not torch.equal(b1.steps, b0.steps)



# ---------------------------------------------------------------------------
# programs the turbo planner rejects (the JAX package's
# tests/test_turbo_eligibility.py), and the CLI's route for them
# ---------------------------------------------------------------------------

INELIGIBLE = {cid: src for cid, src, _ in te.INELIGIBLE}


@pytest.mark.parametrize("cid", sorted(INELIGIBLE))
def test_not_turbo_program_equals_jax_and_host(cid, tmp_path, capsys,
                                               monkeypatch):
    """Every construct the planner rejects runs on the general engine as
    JAX runs it: equal after every launch, equal to the host at DONE, or
    the same error where JAX raises while encoding a value. The host_only
    one runs on the host engine, as in the JAX package."""
    src = INELIGIBLE[cid]
    compiled = compile_port(src)
    with pytest.raises(planner.NotTurbo):
        planner.plan_turbo(compiled)
    if compiled.host_only:
        ran = []
        monkeypatch.setattr(driver.runtime, "async_main",
                            lambda path, args, io: _record(ran, path))
        path = tmp_path / "p.json5"
        path.write_text(src)
        assert driver.run_program_on_device(str(path), [], io=None) == 0
        assert ran == [str(path)]
        return
    out = run_general_both(src, n=2)
    if out is None:
        return
    jres, pres, _ = out
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    for j, p in zip(jres, pres):
        assert (p.status, p.output, p.inserts, p.steps) == (
            j.status, j.output, j.inserts, j.steps)
        assert p.status == DONE
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))


async def _record(ran: list, path: str):
    ran.append(path)


def test_encoding_errors_are_the_jax_package_errors():
    """bool, dict and nested-list inserts: JAX raises HostCodecError while
    encoding; the port raises the same class with the same message."""
    seen = set()
    for cid in ("bool_default_insert", "dict_default_insert",
                "nested_list_insert"):
        jr, pr = general_pair(INELIGIBLE[cid])
        with pytest.raises(Exception) as jerr:
            jr.make_instances(2)
        with pytest.raises(port_state.HostCodecError) as perr:
            pr.make_instances(2)
        assert type(jerr.value).__name__ == "HostCodecError"
        assert str(perr.value) == str(jerr.value)
        seen.add(str(perr.value))
    assert len(seen) == 3


def test_cli_routes_not_turbo_to_the_general_engine(tmp_path, capsys,
                                                    monkeypatch):
    """--engine device: a program the planner accepts goes to the turbo
    engine at any batch past 1 (no batch >= 256 threshold), one it rejects
    to the general engine; both print what the host CLI prints (batch 1
    is the interactive run, ``tests/test_torch_device_menu.py``). The entry
    plans the program first, to size the turbo engine's widths, so a
    program the planner rejects makes no TurboEngine. The engines run
    on the CPU here, in place of the card."""
    from interpolation_engine_tpu_torch import cli
    made = []

    def on_cpu(cls):
        def make(*args, device, **kw):
            made.append(cls.__name__)
            return cls(*args, device="cpu", **kw)
        return make

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(driver, "DeviceRunner", on_cpu(driver.DeviceRunner))
    monkeypatch.setattr(driver, "TurboEngine", on_cpu(driver.TurboEngine))
    cases = [("dynamic_output_name", tp.NOT_TURBO["dynamic_output_name"],
              ["DeviceRunner"]),
             ("list_then_scalar", tp.NOT_TURBO["list_then_scalar"],
              ["DeviceRunner"]),
             ("math_replace_map", tp.NOT_TURBO["math_replace_map"],
              ["DeviceRunner"]),
             ("copy_types", tp.COPY_TYPES, ["TurboEngine"])]
    for name, src, engines in cases:
        path = tmp_path / f"{name}.json5"
        path.write_text(src)
        assert cli.main([str(path)]) == 0
        host = capsys.readouterr().out
        made.clear()
        assert cli.main(["--engine", "device", "--batch", "2",
                         str(path)]) == 0
        assert capsys.readouterr().out == host
        assert made == engines, name


def test_list_slice_int_string_bound_equals_jax(tmp_path, capsys):
    """A bound that is a string holding a signed decimal int at run time
    ('2', '-1', '+3') runs on the device, as the JAX step's byte math
    evaluator runs it: equal after every launch, no park, and equal to the
    host at DONE. So does a template holding an int (the adventure's
    to_index:'{hlen}')."""
    src = prog("{l: ['a', 'b', 'c'], k: '2', m: '-1', p: '+3', n: 3}",
               "{cmd:'list_slice', list:'{l}', from_index:'{k}', "
               "to_index:'{n}', output_name:'s'}",
               "{cmd:'list_slice', list:'{l}', from_index:'{m}', "
               "to_index:'{p}', output_name:'t'}",
               "{cmd:'list_slice', list:'{l}', from_index:1, "
               "to_index:'{n}', output_name:'u'}")
    jres, pres, runner = run_general_both(src, n=2)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    assert runner.ring_stats["parks"] == 0
    for j, p in zip(jres, pres):
        assert p.status == j.status == DONE
        assert (p.output, p.inserts, p.steps) == (j.output, j.inserts,
                                                  j.steps)
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))
        assert (p.inserts["s"], p.inserts["t"], p.inserts["u"]) == (
            ["b", "c"], ["c"], ["a", "b", "c"])


def test_list_slice_expression_bound_equals_jax(tmp_path, capsys):
    """A string bound that is an expression at run time ('1+1', ' 2',
    'length(l)', 'max(1, 2)', '7//2') is interpolated again and evaluated
    on the device by the byte math evaluator, as the JAX step's
    _math_operand does: equal to JAX after every launch, no park at a
    slice, equal to the host at DONE."""
    jres, pres, runner = run_general_both(tp.LIST_SLICE_EXPR, n=2,
                                          inner=2)
    host = run_host(tp.LIST_SLICE_EXPR, tmp_path, ANSWERS)
    capsys.readouterr()
    # one park per instance: the print of list values (a list's repr is
    # the host's); no slice parks
    assert runner.ring_stats["parks"] == 2
    for j, p in zip(jres, pres):
        assert p.status == j.status == DONE
        assert (p.output, p.inserts, p.steps) == (j.output, j.inserts,
                                                  j.steps)
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))
        assert (p.inserts["s"], p.inserts["t"], p.inserts["u"]) == (
            ["b", "c"], ["b", "c", "d"], ["b", "c"])


# ---------------------------------------------------------------------------
# where a port of this code is likely to go wrong: one test per hazard
# ---------------------------------------------------------------------------

def test_int32_wrap_python_floor_and_inexact_division(tmp_path, capsys):
    """RPN add/sub/mul wrap at 32 bits (held against JAX only: the host's
    ints grow); // and % take the divisor's sign; an inexact / parks as
    ERR_HOST and the host raises its exact error, in both engines."""
    jres, pres, _ = run_general_both(tp.INT32_OVERFLOW, n=2)
    assert [(p.output, p.inserts) for p in pres] == [
        (j.output, j.inserts) for j in jres]
    assert pres[0].output == "-2147483648 2147483647 1 -2147483648"
    jres, pres, _ = run_general_both(tp.FLOOR_DIV_MOD, n=2)
    assert pres[0].output == "2 -2 -1 -4 2"
    jr, pr = general_pair(tp.INEXACT_DIV)
    jb = jr.make_instances(2)
    pb = port_state.from_jax(jb._asdict())
    jb, pb = jr._jitted(jb, 4), pr.launch(pb, 4)
    assert_same_state(jax_snapshot(jb), pb.to_numpy(), "inexact")
    assert pb.last_err.tolist() == [ik.ERR_HOST] * 2
    assert pb.status.tolist() == [PARKED] * 2
    assert run_general_both(tp.INEXACT_DIV, n=2) is None


def test_commit_only_on_success():
    """A failed instruction keeps the old state but bumps steps and sets
    last_err; halt bumps nothing; park bumps steps only when ready."""
    too_long = "x" * (GEN_CFG.max_str + 4)
    src = prog("{a: 'keep'}", "{cmd:'set', item:'%s', output_name:'b'}"
               % too_long)
    jr, pr = general_pair(src)
    jb = jr.make_instances(2)
    pb0 = port_state.from_jax(jb._asdict())
    jb, pb = jr._jitted(jb, 3), pr.launch(pb0, 3)
    assert_same_state(jax_snapshot(jb), pb.to_numpy(), "capacity")
    assert pb.last_err.tolist() == [ik.ERR_CAPACITY] * 2
    assert pb.steps.tolist() == [1, 1] and pb.pc.tolist() == [0, 0]
    for f in ("arena", "arena_top", "occ", "key_hash", "vtype", "voff"):
        assert torch.equal(getattr(pb, f), getattr(pb0, f)), f

    halt = pr.launch(pr.make_instances(2)._replace(
        pc=torch.tensor([1, 1], dtype=torch.int32)), 3)
    assert halt.status.tolist() == [DONE] * 2
    assert halt.steps.tolist() == [0, 0]

    for src, steps, status in ((tp.AWAIT_READY, 2, DONE),
                               (tp.AWAIT_NOT_READY, 1, PARKED)):
        jr, pr = general_pair(src)
        jb = jr.make_instances(2)
        jb, pb = jr._jitted(jb, 6), pr.launch(port_state.from_jax(
            jb._asdict()), 6)
        assert_same_state(jax_snapshot(jb), pb.to_numpy(), "park")
        assert pb.steps.tolist() == [steps] * 2
        assert pb.status.tolist() == [status] * 2


def test_argmax_of_all_false_is_masked():
    """An empty candidate set gives slot or row 0 (JAX's argmax of
    all-False), and every caller masks it: a label that does not exist
    resolves to -1, and a block with no runnable lane picks none."""
    _, pr = general_pair(PROGRAMS["par_wait"])
    step = pr.step
    n = 3
    name = torch.zeros((n, GEN_CFG.max_str), dtype=torch.uint8)
    name[:, :6] = torch.tensor(list(b"@nopes"), dtype=torch.uint8)
    pc, cont = step._resolve_label(0, name, torch.full((n,), 6,
                                                       dtype=torch.int32),
                                   torch.zeros(n, dtype=torch.int32))
    assert pc.tolist() == [-1] * n and not cont.any()
    b = pr.make_instances(n)
    any_run, lane = step._pick(b, torch.zeros((n, GEN_CFG.max_threads),
                                              dtype=torch.bool))
    assert not any_run.any() and lane.tolist() == [0] * n


LABEL_WORDS = ["zeta", "yak", "xylophone", "wombat", "vulture", "unicorn",
               "end"]
LABELS = prog("{i: 0}", *[
    f"{{cmd:'label', name:'@{w}'}}, {{cmd:'math', input:'{{i}} + 1', "
    f"output_name:'i'}}, {{cmd:'goto_map', text:'{{i}}', target_maps:["
    f"{{'{k + 1}': '@{LABEL_WORDS[k + 1]}'}}]}}"
    for k, w in enumerate(LABEL_WORDS[:-1])],
    "{cmd:'label', name:'@end'}", "{cmd:'print', text:'i={i}'}")


def test_label_hash_compares_as_uint32(tmp_path, capsys):
    """Label hashes at or above 2^31 are negative in the int32 table and
    match the uint32 hash of the name bytes."""
    compiled = compile_port(LABELS)
    hashes = np.asarray(compiled.labels, np.int32).reshape(-1, 5)[:, 1]
    assert (hashes < 0).any() and (hashes >= 0).any()
    jres, pres, _ = run_general_both(LABELS, n=2)
    host = run_host(LABELS, tmp_path, ANSWERS)
    capsys.readouterr()
    assert [p.output for p in pres] == [host["output"]] * 2 == \
        [j.output for j in jres]


def test_ring_order_launch_gather_launch_scatter():
    """One ring round: launch, gather the parked rows, launch again for the
    RUNNING rows while the host services them, scatter back. A resumed row
    has steps + 1."""
    _, pr = general_pair(tp.USER_INPUT)
    code = np.asarray(pr.compiled.code).reshape(-1, 4)
    park_pc = int(np.nonzero(code[:, 0] == isa.OP_PARK)[0][0])
    log = []
    launch, take = pr.launch, port_state.VMBatch.take
    stack = driver.vs.stack_rows

    in_launch = []

    def rec_launch(b, k):
        log.append(("launch", b.status.tolist()))
        in_launch.append(True)   # the step's own per-pc gathers: not logged
        try:
            return launch(b, k)
        finally:
            in_launch.pop()

    def rec_take(self, idx):
        if not in_launch:
            log.append(("gather", idx.tolist()))
        return take(self, idx)

    def rec_stack(rows, device="cpu"):
        log.append(("scatter", [int(r["steps"]) for r in rows]))
        return stack(rows, device)

    # rows 0 and 1 start at the user_input, row 2 one instruction before
    b = pr.make_instances(3)
    b = b._replace(pc=torch.tensor([park_pc, park_pc, park_pc - 1],
                                   dtype=torch.int32))
    pr.launch = rec_launch
    port_state.VMBatch.take = rec_take
    driver.vs.stack_rows = rec_stack
    try:
        final = pr.run(b, inner_steps=1)
    finally:
        port_state.VMBatch.take = take
        driver.vs.stack_rows = stack
    assert log[:4] == [("launch", [RUNNING] * 3), ("gather", [0, 1]),
                       ("launch", [PARKED, PARKED, RUNNING]),
                       ("scatter", [1, 1])]
    assert all(r.status == DONE for r in pr.results(final))


GENERAL_BLOCKED_RUN = """
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "interpolation_engine_tpu")

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name.split(".")[0])
        return None

for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, NoJax())
sys.path.insert(0, sys.argv[1])

from interpolation_engine_tpu_torch._shared import (
    compile_program, json5, loader, vm_config)
from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
for src in sys.argv[2:]:
    runner = DeviceRunner(compile_program(json5.loads(
        loader.add_line_numbers(src))), vm_config.VMConfig(), device="cpu")
    results = runner.results(runner.run(runner.make_instances(2)))
    assert all(r.status == vm_config.DONE for r in results), results
    print(results[0].output)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
"""


def test_general_engine_runs_with_jax_blocked(tmp_path, capsys):
    """The general engine (step, interpolation, brace scan, ring) imports
    neither JAX nor the JAX package."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    srcs = [tp.NOT_TURBO["list_then_scalar"], bench.adventure_program(t_max=3)]
    proc = subprocess.run(
        [sys.executable, "-c", GENERAL_BLOCKED_RUN, str(root), *srcs],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    want = [run_host(src, tmp_path)["output"] for src in srcs]
    capsys.readouterr()
    assert proc.stdout.split("\n")[:2] == want
