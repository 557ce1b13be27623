"""Parallel thread lanes on the port (the plain version of the step, on the
CPU): the block entry, the lane switch at each lane's end, the lane yield on
a park inside a block, and the ring's lane servicing through the shared
LaneRing, against the exact host engine and the JAX engine."""

import asyncio

import pytest

import bench
import torch_programs as tp
from torch_helpers import (PORT_TCFG, agree_with_host, jax_engine,
                           port_engine, prog, run_jax, run_port, summary)

from interpolation_engine_tpu.vm.config import (DONE, PARKED, PM_DRAIN,
                                                PM_WAIT, RUNNING, T_DONE,
                                                T_FREE, T_NEW, T_WAIT)
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import turbo as port_turbo
from interpolation_engine_tpu_torch.vm.turbo import (
    C_CURTID, C_PARJOIN, C_PARMODE, C_PAREPOCH, C_PC, C_STATUS, C_STEPS)

RACE_IO = bench.race_io_program(t_max=3)
RACE_IO_OUT = ("gen-scene-2-3;fin turn=3 acc=6 "
               "hist=['seed', 'h0.1', 'h1.2', 'h2.3']")
# lane 0 loops; the block resets its loop counter on entry
LOOP_IN_LANE = prog(
    "{}", "{cmd:'parallel_wait', tasks:["
    "{cmd:'for', name_list_map:{x:['a','b']}, tasks:["
    "{cmd:'print', text:'{x}'}]}, {cmd:'set', item:'s', output_name:'y'}]}",
    "{cmd:'print', text:'!'}")


def lanes(eng, batch, col) -> list:
    cols = eng.cols
    return [int(batch.regs[0, col(cols, l)]) for l in range(cols.nt)]


def tstates(eng, batch):
    return lanes(eng, batch, port_turbo._Cols.tstate)


@pytest.mark.parametrize("mode", ["wait", "race"])
def test_compute_lanes_agree_with_host_and_jax(mode, tmp_path, capsys):
    src = tp.PAR_RACE % {"mode": mode}
    r = agree_with_host(src, tmp_path, capsys, n=3)
    assert r.output == "[0:lane0][1]after x=lane0 y=lane1 z=leaf"
    assert [summary(p) for p in run_port(src, 3)] == \
        [summary(j) for j in run_jax(src, 3)]


@pytest.mark.parametrize("mode", ["wait", "race"])
def test_midblock_lane_park_rides_the_ring(mode, tmp_path, capsys):
    src = tp.MIDBLOCK_PARK % {"mode": mode}
    responses = ["one", "two", "three"]
    r = agree_with_host(src, tmp_path, capsys, n=3, responses=responses)
    assert r.output == ("[gen-1]<one>[gen-2]<two>[gen-3]<three>"
                        "fin gen-3 three")
    eng = port_engine(src, responses=responses)
    eng.run(eng.make_batch(3), max_rounds=500)
    assert eng.ring_stats["parks"] == 9       # one per instance per turn
    assert not eng._lanering.pending


@pytest.fixture(scope="module")
def race_io_jax():
    """The JAX engine's one build of the race-io kernel (about 30 s in
    interpret mode), run through its exact slow ring (the ring the port
    has) and through its fast park path: (results, parks) of each."""
    eng = jax_engine(RACE_IO, responses=["cgo"] * 3)
    runs = {}
    for fast in (False, True):
        eng._fast_enabled = fast
        eng._ios.clear()             # fresh canned answers per run
        parks0 = eng.ring_stats["parks"]
        res = eng.results(eng.run(eng.make_batch(8), max_rounds=500), 8)
        runs[fast] = res, eng.ring_stats["parks"] - parks0
    return runs


def test_race_io_agrees_with_jax(race_io_jax):
    """The port's fast park path and its exact ring both count as the JAX
    exact ring: 47 steps and 24 parks, every lane park of the fast run on
    the fast path."""
    jax_res, jax_parks = race_io_jax[False]
    for fast in (True, False):
        eng = port_engine(RACE_IO, responses=["cgo"] * 3, fast=fast)
        res = eng.results(eng.run(eng.make_batch(8), max_rounds=500))
        assert eng.ring_stats["parks"] == jax_parks == 24  # 3 per instance
        assert eng.ring_stats["fast_parks"] == (24 if fast else 0)
        assert [summary(r) for r in res] == [summary(j) for j in jax_res]
        for r in res:
            assert (r.status, r.steps, r.output) == (DONE, 47, RACE_IO_OUT)
    # the JAX fast park path resumes a drained race at its join without
    # the lane's thread end: the same results, one step fewer per turn
    fast_res, fast_parks = race_io_jax[True]
    assert fast_parks == 24
    assert [(r.output, r.inserts, r.steps + 3) for r in fast_res] == \
        [(r.output, r.inserts, r.steps) for r in res]


def test_race_io_agrees_with_host(tmp_path, capsys):
    r = agree_with_host(RACE_IO, tmp_path, capsys, n=3,
                        responses=["cgo"] * 3)
    assert r.output == RACE_IO_OUT


@pytest.mark.parametrize("mode,pm", [("race", PM_DRAIN), ("wait", PM_WAIT)])
def test_lane_yield_suspends_the_lane_and_never_switches(mode, pm):
    src = tp.MIDBLOCK_PARK % {"mode": mode}
    eng = port_engine(src)
    batch = eng.step_fn(1)(eng.make_batch(1))
    regs = batch.regs[0]
    pc = int(regs[C_PC])
    # lane 0 ran to its end; lane 1 parked on its user_input
    assert int(regs[C_STATUS]) == PARKED and int(regs[C_CURTID]) == 1
    assert int(regs[C_PARMODE]) == pm
    assert tstates(eng, batch) == [T_DONE, T_WAIT]
    assert lanes(eng, batch, port_turbo._Cols.tpc)[1] == pc
    assert lanes(eng, batch, port_turbo._Cols.tparg)[1] == pc


@pytest.mark.parametrize("src", [tp.USER_INPUT, tp.PARKED_FREEZE_PAR],
                         ids=["top_level", "in_block"])
def test_parked_rows_stay_frozen_under_an_extra_step(src):
    eng = port_engine(src)
    batch = eng.step_fn(3)(eng.make_batch(3))
    assert batch.regs[:, C_STATUS].tolist() == [PARKED] * 3
    frozen = [t.clone() for t in batch]
    ts.turbo_step_reference(eng.tables, batch, PORT_TCFG.k_steps)
    for a, b in zip(frozen, batch):
        assert a.equal(b)


def test_output_spill_survives_a_parallel_park(tmp_path, capsys):
    tiny = port_turbo.TurboConfig(tile=8, width=64, out_width=24,
                                  k_steps=16)
    r = agree_with_host(tp.SPILL_PARALLEL, tmp_path, capsys, tcfg=tiny,
                        responses=["go"])
    assert len(r.output) > tiny.out_width
    assert r.output.endswith("A=go;B;end")


# ---- the block entry and the lane switch, one step at a time -------------------

def test_par_begin_spawns_every_lane_and_resets_block_loops():
    eng = port_engine(LOOP_IN_LANE)
    batch = eng.make_batch(1)
    cols = eng.cols
    batch.regs[0, cols.loop(0)] = 5
    for l in range(cols.nt):
        batch.regs[0, cols.tparg(l)] = 99
    ts.turbo_step_reference(eng.tables, batch, 1)
    regs = batch.regs[0]
    (entry0, entry1), join = (1, 5), 7
    assert [int(regs[c]) for c in (C_PC, C_STEPS, C_CURTID, C_PARMODE,
                                   C_PARJOIN)] == [entry0, 1, 0, PM_WAIT,
                                                   join]
    assert lanes(eng, batch, port_turbo._Cols.tpc) == [entry0, entry1]
    assert tstates(eng, batch) == [T_NEW, T_NEW]
    assert lanes(eng, batch, port_turbo._Cols.tparg) == [0, 0]
    assert int(regs[cols.loop(0)]) == 0


def thread_end(mode: str, cur: int, states: list):
    """One step of PAR_RACE's lane `cur` at its thread end, the lanes in
    `states`; returns (engine, batch, registers before)."""
    eng = port_engine(tp.PAR_RACE % {"mode": mode})
    batch = eng.make_batch(1)
    ts.turbo_step_reference(eng.tables, batch, 1)      # the block entry
    cols = eng.cols
    batch.regs[0, C_CURTID] = cur
    batch.regs[0, C_PC] = (3, 6, 8)[cur]
    for l, st in enumerate(states):
        batch.regs[0, cols.tstate(l)] = st
    before = batch.regs[0].clone()
    ts.turbo_step_reference(eng.tables, batch, 1)
    return eng, batch, before


@pytest.mark.parametrize("mode,pm", [("race", PM_DRAIN), ("wait", PM_WAIT)])
def test_thread_end_picks_the_next_lane_cyclically(mode, pm):
    eng, batch, before = thread_end(mode, 1, [T_NEW, T_NEW, T_NEW])
    regs = batch.regs[0]
    # from cur + 1: lane 2 before lane 0
    assert int(regs[C_CURTID]) == 2 and int(regs[C_PC]) == 7
    assert int(regs[C_PARMODE]) == pm
    assert tstates(eng, batch) == [T_NEW, T_DONE, T_NEW]
    assert int(regs[C_STEPS]) == int(before[C_STEPS]) + 1
    assert int(regs[C_PAREPOCH]) == int(before[C_PAREPOCH])
    # wrapping around: lane 2 ends, lane 0 is next
    eng, batch, _ = thread_end(mode, 2, [T_NEW, T_DONE, T_NEW])
    assert int(batch.regs[0, C_CURTID]) == 0
    assert int(batch.regs[0, C_PC]) == 1


@pytest.mark.parametrize("mode", ["race", "wait"])
def test_thread_end_completes_the_block(mode):
    eng, batch, before = thread_end(mode, 0, [T_NEW, T_DONE, T_DONE])
    regs = batch.regs[0]
    assert [int(regs[c]) for c in (C_PC, C_STATUS, C_CURTID, C_PARMODE,
                                   C_PARJOIN)] == [9, RUNNING, -1, 0, 0]
    assert int(regs[C_PAREPOCH]) == int(before[C_PAREPOCH]) + 1
    assert tstates(eng, batch) == [T_FREE] * 3


def test_thread_end_parks_while_a_lane_waits_on_host_io():
    # wait mode parks the instance; a race drains, and also parks while no
    # lane is runnable
    for mode, pm in (("wait", PM_WAIT), ("race", PM_DRAIN)):
        eng, batch, before = thread_end(mode, 0, [T_NEW, T_WAIT, T_DONE])
        regs = batch.regs[0]
        assert int(regs[C_STATUS]) == PARKED and int(regs[C_CURTID]) == -1
        assert int(regs[C_PARMODE]) == pm
        assert int(regs[C_PC]) == int(before[C_PC])
        assert int(regs[C_STEPS]) == int(before[C_STEPS]) + 1
        assert tstates(eng, batch) == [T_DONE, T_WAIT, T_DONE]
    # a race whose other lanes are done completes at its join
    eng, batch, _ = thread_end("race", 2, [T_DONE, T_DONE, T_NEW])
    assert [int(batch.regs[0, c]) for c in (C_PC, C_CURTID, C_PARMODE)] \
        == [9, -1, 0]


def test_finished_blocks_lose_their_pending_host_io():
    """A block the device finished (its epoch moved on) cancels the lane IO
    still pending on the host, at the top of the next round."""
    eng = port_engine(tp.PAR_RACE % {"mode": "race"})

    async def go():
        waiting = asyncio.ensure_future(asyncio.sleep(60))
        eng._lanering.pending[0] = {"epoch": 7, "tasks": {1: waiting},
                                    "errors": {}, "failed": set()}
        await eng.run_async(eng.make_batch(2))
        return waiting

    waiting = asyncio.run(go())
    assert waiting.cancelled()
    assert not eng._lanering.pending
