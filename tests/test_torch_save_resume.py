"""Save and resume in the port against the JAX package, on the CPU: the
cursor chains (``emit_cursors``, ``emit_par_cursors``, ``pc_of_state``),
``TurboEngine.export_state``, ``load_state`` and ``load_batch``, and
``DeviceRunner.export_state``, ``save_to_program``, ``load_state`` and
``pc_of_order_index``; then saves resumed across engines and the host.

Both packages read the same batch: the port's steps it, and the JAX side
reads a numpy copy of it (``to_jax_batch``, ``VMInstance``), so an export
is compared at the very same park. Exact equality throughout (ints and
bytes)."""

import asyncio
import itertools
import json
import types

import numpy as np
import pytest
import torch

import bench
import torch_programs as tp
from torch_helpers import (GEN_CFG, PORT_TCFG, PortMenuBackend,
                           compile_port, compile_src, jax_engine, port_cfg,
                           port_engine, port_host_from_state, port_scripted,
                           run_host, same_error)

from interpolation_engine_tpu.vm import driver as jd
from interpolation_engine_tpu.vm import turbo as jt
from interpolation_engine_tpu.vm.config import (DONE, PARKED, RUNNING,
                                                T_DONE, T_FREE, T_NEW,
                                                T_READY, T_WAIT)
from interpolation_engine_tpu.vm.state import VMInstance
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch import bench as port_bench
from interpolation_engine_tpu_torch.parallel.mesh import unshard
from interpolation_engine_tpu_torch.vm import driver as pd
from interpolation_engine_tpu_torch.vm import state as vs
from interpolation_engine_tpu_torch.vm import turbo as pt

PROGRAMS = {
    "save": tp.SAVE_SRC, "nested": tp.NESTED_SRC, "wait": tp.WAIT_SRC,
    "par_save": tp.PAR_SAVE_SRC, "for_input": tp.FOR_INPUT,
    "run_task": tp.RUN_TASK_CHAIN, "adventure": bench.adventure_program(),
    "race_io": bench.race_io_program(),
}
STEP1 = pt.TurboConfig(tile=8, width=64, out_width=192, k_steps=1)


# ---- the cursor chains -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cursor_chains_equal_jax_and_invert(name):
    """At every pc, with loop counters from a seed, the port's
    ``emit_cursors`` writes JAX's keys, its ``pc_of_state`` resolves them to
    JAX's pc, counters and lanes, and emitting again at that pc gives the
    same state: the two invert each other on the cursors' granularity."""
    src = PROGRAMS[name]
    j, p = compile_src(src), compile_port(src)
    rng = np.random.default_rng(0)
    for pc in range(p.n_instr):
        counters = rng.integers(0, 4, size=8).astype(np.int32)
        js, ps = {}, {}
        jd.emit_cursors(j, js, pc, counters.copy())
        pd.emit_cursors(p, ps, pc, counters.copy())
        assert ps == js, pc
        jc, pc_ = np.zeros(8, np.int32), np.zeros(8, np.int32)
        want = jd.pc_of_state(j, js, jc)
        got = pd.pc_of_state(p, ps, pc_)
        assert got == want and np.array_equal(pc_, jc), pc
        again = {}
        pd.emit_cursors(p, again, got[0], pc_)
        assert again == ps, pc


@pytest.mark.parametrize("name", ["wait", "par_save", "adventure"])
def test_par_cursors_equal_jax_for_every_lane_state(name):
    """Inside each parallel block, for every pair of lane states, the
    running lane or none, and either lane current: the port's
    ``emit_par_cursors`` writes JAX's per-lane chains (nothing for a lane
    that is T_NEW, T_DONE or T_FREE)."""
    src = PROGRAMS[name]
    j, p = compile_src(src), compile_port(src)
    assert p.par_blocks
    lane_states = (T_FREE, T_NEW, T_READY, T_WAIT, T_DONE)
    counters = np.arange(1, 9, dtype=np.int32)
    seen = set()
    for join_pc, block in p.par_blocks.items():
        k = len(block["lanes"])
        entry = [e for _, e, _ in block["lanes"]]
        for ts, status, cur, off in itertools.product(
                itertools.product(lane_states, repeat=k), (RUNNING, PARKED),
                range(k), (0, 1, 2)):
            tpc = np.asarray([e + off for e in entry], np.int32)
            st = {"pc": int(tpc[cur]), "status": status, "cur_tid": cur,
                  "par_join": join_pc, "tpc": tpc,
                  "tstate": np.asarray(ts, np.int32)}
            js, ps = {}, {}
            jd.emit_par_cursors(j, js, types.SimpleNamespace(**st), counters)
            pd.emit_par_cursors(p, ps, st, counters)
            assert ps == js, st
            seen.add(len(ps))
    assert len(seen) > 1


def test_cursor_out_of_range_raises_the_jax_error():
    j, p = compile_src(tp.NESTED_SRC), compile_port(tp.NESTED_SRC)
    serial = next(k for k in p.block_task_pcs
                  if k.split("/")[-1].startswith("serial"))
    state = {}
    pd.emit_cursors(p, state, p.block_task_pcs[serial][0],
                    np.ones(8, np.int32))
    state[f"order_index/{serial}"] = 7
    with pytest.raises(ValueError) as err:
        jd.pc_of_state(j, state, np.zeros(8, np.int32))
    same_error(lambda: pd.pc_of_state(p, state, np.zeros(8, np.int32)),
               err.value)


# ---- the turbo engine ------------------------------------------------------------

def _to_jax(eng, batch):
    regs, sbuf, out = pt.to_jax_batch(eng.cols, batch)
    return jt.TurboBatch(regs=regs, sbuf=sbuf, out=out)


def _turbo_park(case: str):
    """(source, port engine, its batch at the case's park, JAX engine)."""
    if case == "top_park":
        src, eng = tp.SAVE_SRC, port_engine(tp.SAVE_SRC)
        batch = eng.make_batch(2)
        eng.step_fn(2)(batch)
    elif case == "mid_for":
        src, eng = tp.FOR_INPUT, port_engine(tp.FOR_INPUT, responses=["A"])
        batch = eng.run(eng.make_batch(1), max_rounds=1)
    elif case == "nested":
        src, eng = tp.NESTED_SRC, port_engine(tp.NESTED_SRC)
        batch = eng.make_batch(1)
        eng.step_fn(1)(batch)
    elif case == "mid_parallel":
        src, eng = tp.PAR_SAVE_SRC, port_engine(tp.PAR_SAVE_SRC, STEP1)
        batch = eng.make_batch(1)
        step = eng.step_fn(1)
        for _ in range(64):
            step(batch)
            if int(batch.regs[0, pt.C_PARMODE]) > 0:
                break
        for _ in range(3):   # a few steps into lane 0
            step(batch)
        assert int(batch.regs[0, pt.C_PARMODE]) > 0
    elif case == "spill":
        src, eng = tp.SAVE_SRC, port_engine(tp.SAVE_SRC)
        batch = eng.make_batch(2)
        eng.step_fn(2)(batch)
        eng._out_prefix[0] = ("spilled;" * 30, 0)
    je = jax_engine(src, jt.TurboConfig(tile=8, width=64, out_width=192,
                                        k_steps=eng.tcfg.k_steps))
    je._out_prefix.update(eng._out_prefix)
    return src, eng, batch, je


TURBO_CASES = ["top_park", "mid_for", "nested", "mid_parallel", "spill"]


@pytest.mark.parametrize("case", TURBO_CASES)
def test_turbo_export_equals_jax(case, capsys):
    """At the same park, the port's ``export_state`` equals JAX's state dict:
    inserts, output (the spill folded in), order_index and cursors."""
    _, eng, batch, je = _turbo_park(case)
    capsys.readouterr()
    got = eng.export_state(batch, 0)
    assert got == je.export_state(_to_jax(eng, batch), 0)
    if case in ("mid_for", "nested", "mid_parallel"):
        assert any(k.startswith("order_index/") for k in got), got
    if case == "spill":
        assert got["output"].startswith("spilled;" * 30)


def _same_turbo_row(eng, prow: dict, jrow: dict) -> None:
    """A port row equals a JAX row: regs; the byte rows with the meta rows
    moved into ``meta``; the output bytes."""
    from interpolation_engine_tpu_torch.vm.turbo import _meta_rows
    assert np.array_equal(prow["regs"], jrow["regs"])
    sbuf = np.asarray(jrow["sbuf"], np.int32).copy()
    rows = _meta_rows(eng.cols)
    assert np.array_equal(prow["meta"], sbuf[rows, :3 * eng.cols.E])
    sbuf[rows] = 0
    assert np.array_equal(prow["sbuf"].astype(np.int32), sbuf)
    assert np.array_equal(prow["out"].astype(np.int32), jrow["out"])


@pytest.mark.parametrize("case", TURBO_CASES)
def test_turbo_load_state_rows_equal_jax(case, capsys):
    """Each exported state, and the same with an output past half the
    buffer, encodes to JAX's row byte for byte (lanes re-seeded T_NEW at
    their resume pcs inside a parallel block), with the same spill."""
    src, eng, batch, je = _turbo_park(case)
    capsys.readouterr()
    state = eng.export_state(batch, 0)
    for st in (state, dict(state, output="o" * 150)):
        fresh, jfresh = port_engine(src, eng.tcfg), jax_engine(
            src, jt.TurboConfig(tile=8, width=64, out_width=192,
                                k_steps=eng.tcfg.k_steps))
        _same_turbo_row(fresh, fresh.load_state(st, i=3),
                        jfresh.load_state(st, i=3))
        assert fresh._out_prefix == jfresh._out_prefix
    if case == "mid_parallel":
        row = fresh.load_state(state)
        cols = fresh.cols
        assert [int(row["regs"][cols.tstate(lane)])
                for lane in range(cols.nt)] == [T_NEW] * cols.nt


def test_turbo_load_state_rejects_cursors_below_a_host_op():
    state = {"order_index": 1, "inserts": {},
             "order_index/serial-1/print-2": 2}
    with pytest.raises(ValueError) as err:
        jax_engine(tp.SAVE_SRC).load_state(state)
    same_error(lambda: port_engine(tp.SAVE_SRC).load_state(state), err.value)


DEDUP_SRC = """
{
    default_state: {order_index: 1, inserts: {i: 0, tag: 'x'}},
    order: [
        {cmd:'math', input:'{i} * 2', output_name:'d'},
        {cmd:'print', text:'+{tag}{d};'},
    ],
    named_tasks: {}, save_states: {},
}
"""
BIG = "o" * 150
DEDUP_STATES = [
    {"inserts": {"i": 3, "tag": "a"}, "output": "", "order_index": 1},
    {"inserts": {"tag": "a", "i": 3}, "output": "", "order_index": 1},
    {"inserts": {"i": 5, "tag": "b"}, "output": BIG, "order_index": 1},
    {"inserts": {"i": 5, "tag": "b"}, "output": BIG, "order_index": 1},
    {"inserts": {"i": 4, "tag": "c"}, "output": "", "order_index": 1},
    {"inserts": {"i": 3, "tag": "a"}, "output": "", "order_index": 1},
]


def _count_uniques(eng) -> list:
    calls = []
    load = eng.load_state

    def counted(state, i=None):
        calls.append(i)
        return load(state, i)
    eng.load_state = counted
    return calls


def test_load_batch_equals_jax_and_dedups(capsys):
    """The port's batch equals JAX's (its live rows), from the same three
    distinct states of six; every long-output instance has its own spill;
    the run ends as the host would end each state."""
    eng, je = port_engine(DEDUP_SRC), jax_engine(DEDUP_SRC)
    pu, ju = _count_uniques(eng), _count_uniques(je)
    batch = eng.load_batch([dict(s) for s in DEDUP_STATES])
    jb = je.load_batch([dict(s) for s in DEDUP_STATES])
    assert pu == ju == [0, 2, 4]
    n = len(DEDUP_STATES)
    want = pt.from_jax_batch(eng.cols, *(np.asarray(t)[:n] if k != 1 else
                                         np.asarray(t)[:, :n]
                                         for k, t in enumerate(jb)),
                             device="cpu")
    for a, b in zip(batch, want):
        assert torch.equal(a, b)
    assert eng._out_prefix == je._out_prefix and set(eng._out_prefix) == \
        {2, 3}
    final = eng.run(batch, max_rounds=100)
    capsys.readouterr()
    for r, s in zip(eng.results(final), DEDUP_STATES):
        d = s["inserts"]["i"] * 2
        assert r.status == DONE
        assert r.output == s["output"] + f"+{s['inserts']['tag']}{d};"
        assert r.inserts == dict(s["inserts"], d=d)


LIST_SRC = """
{
    default_state: {order_index: 1, inserts: {hist: ['a'], n: 0}},
    order: [{cmd:'list_append', list:'{hist}', item:'b',
             output_name:'hist'},
            {cmd:'math', input:'{n} + 1', output_name:'n'},
            {cmd:'print', text:'{hist} {n}'}],
    named_tasks: {}, save_states: {},
}
"""
GOOD = {"inserts": {"hist": ["a", "c"], "n": 1}, "output": "",
        "order_index": 1}


@pytest.mark.parametrize("bad", [{"hist": ("a", "c")}, {"n": True},
                                 {"n": np.int32(1)}],
                         ids=["tuple", "bool", "np_int32"])
def test_load_batch_rejects_what_the_jax_key_rejects(bad):
    """A state that json would merge with an accepted one (a tuple with a
    list) or that only its type tells apart (a bool, an np.int32 for an
    int) is its own state after the accepted one, and the encoder rejects
    it, in both packages with the same error; alone, the accepted state
    loads."""
    state = dict(GOOD, inserts=dict(GOOD["inserts"], **bad))
    tcfg = dict(tile=8, width=64, out_width=96, k_steps=8)
    port_engine(LIST_SRC, pt.TurboConfig(**tcfg)).load_batch([GOOD, GOOD])
    with pytest.raises(Exception) as err:
        jax_engine(LIST_SRC, jt.TurboConfig(**tcfg)).load_batch([GOOD, state])
    assert type(err.value).__name__ == "TurboEncodeError"
    same_error(lambda: port_engine(LIST_SRC, pt.TurboConfig(
        **tcfg)).load_batch([GOOD, state]), err.value)


def test_load_batch_under_a_mesh_is_the_sharded_batch():
    one = port_engine(DEDUP_SRC)
    four = port_engine(DEDUP_SRC, mesh=["cpu"] * 4)
    sharded = four.load_batch([dict(s) for s in DEDUP_STATES])
    assert isinstance(sharded, pt.ShardedTurboBatch)
    assert sharded.offsets == (0, 2, 4, 5, 6)
    for a, b in zip(unshard(sharded), one.load_batch(DEDUP_STATES)):
        assert torch.equal(a, b)
    assert set(four._out_prefix) == {2, 3}


# ---- the general engine ----------------------------------------------------------

def _runners(src: str, responses=()):
    """The port's DeviceRunner and JAX's (jit mode: nothing compiles until
    a launch, and these tests only export and encode)."""
    jr = jd.DeviceRunner(compile_src(src), GEN_CFG, mode="jit")
    pr = pd.DeviceRunner(compile_port(src), port_cfg(GEN_CFG),
                         io_factory=port_scripted(responses), device="cpu")
    return pr, jr


class _Blocking(port.io_manager.ScriptedBackend):
    async def user_input(self, prompt, default=""):
        await asyncio.Event().wait()


def _general_park(case: str):
    """(source, port runner, its batch at the case's park, JAX runner)."""
    src = {"top_park": tp.SAVE_SRC, "nested": tp.NESTED_SRC,
           "mid_parallel": tp.WAIT_SRC}[case]
    pr, jr = _runners(src)
    batch = pr.make_instances(2)
    if case == "top_park":
        batch = pr.launch(batch, 16)
    elif case == "nested":
        for _ in range(4):
            batch = pr.launch(batch, 8)
    else:
        pr.io_factory = lambda i: port.io_manager.IOManager(_Blocking([]))

        async def snapshot(b):
            # lane 0 runs and parks; one service switches to lane 1, which
            # runs and parks: both lanes waiting
            for _ in range(4):
                b = pr.launch(b, 8)
            sub, idx = pd._gather(b, np.asarray([0]))
            out = await pr._service_instance(vs.row_of(sub, 0), 0, {})
            b = pd._scatter(b, idx, [out])
            for _ in range(4):
                b = pr.launch(b, 8)
            await pr._lanering.cancel(0)
            return b
        batch = asyncio.run(snapshot(batch))
    assert int(batch.status[0]) == PARKED
    return src, pr, batch, jr


def _jax_instance(batch) -> VMInstance:
    return VMInstance(**batch.to_numpy())


GENERAL_CASES = ["top_park", "nested", "mid_parallel"]


@pytest.mark.parametrize("case", GENERAL_CASES)
def test_runner_export_equals_jax(case):
    _, pr, batch, jr = _general_park(case)
    got = pr.export_state(batch, 0)
    assert got == jr.export_state(_jax_instance(batch), 0)
    if case == "mid_parallel":
        par = "parallel_wait-6/parallel_wait-6"
        assert sorted(k for k in got if k.startswith("order_index/")) == [
            f"order_index/{par}/serial-12", f"order_index/{par}/serial-7"]
        assert got["output"] == "a;t0;t1;"


@pytest.mark.parametrize("case", GENERAL_CASES)
def test_runner_load_state_rows_equal_jax(case):
    """The exported state, and the same with another seed, encodes to
    JAX's instance field for field (a parallel block's lanes T_NEW at
    their resume pcs)."""
    src, pr, batch, jr = _general_park(case)
    state = pr.export_state(batch, 0)
    for seed in (0, 7):
        row = pr.load_state(state, seed=seed)
        want = jr.load_state(state, seed=seed)
        for f in vs.FIELDS:
            a = np.asarray(getattr(want, f))
            assert row[f].dtype == a.dtype and np.array_equal(row[f], a), f
    if case == "mid_parallel":
        assert row["tstate"][:2].tolist() == [T_NEW, T_NEW]
        assert int(row["pc"]) == int(row["tpc"][0])


def test_runner_load_state_rejects_unresolvable_cursors():
    pr, jr = _runners(tp.SAVE_SRC)
    state = {"order_index": 1, "inserts": {},
             "order_index/serial-1/print-2": 2}
    with pytest.raises(ValueError) as err:
        jr.load_state(state)
    assert "host-op task" in str(err.value)
    same_error(lambda: pr.load_state(state), err.value)


@pytest.mark.parametrize("name", ["nested", "run_task", "adventure"])
def test_pc_of_order_index_equals_jax(name):
    pr, jr = _runners(PROGRAMS[name])
    for k in range(1, len(pr.compiled.program["order"]) + 3):
        assert pr.pc_of_order_index(k) == jr.pc_of_order_index(k)


def test_save_to_program_splices_as_jax_does(tmp_path):
    """Both packages splice the same text into the same file, comments and
    formatting kept, and the port's loader reads the slot back."""
    _, pr, batch, jr = _general_park("nested")
    src = tp.NESTED_SRC.replace("save_states: {},",
                                "// slots below\n    save_states: {},")
    paths = [tmp_path / "port.json5", tmp_path / "jax.json5"]
    for path in paths:
        path.write_text(src)
    pr.save_to_program(batch, 0, "1", "midway", str(paths[0]))
    jr.save_to_program(_jax_instance(batch), 0, "1", "midway", str(paths[1]))
    assert paths[0].read_text() == paths[1].read_text()
    assert "// slots below" in paths[0].read_text()
    port.loader.invalidate_cache()
    program, _ = port.loader.load(str(paths[0]))
    assert program["save_states"]["1"] == dict(pr.export_state(batch, 0),
                                               label="midway")


def test_export_splice_load_resumes_to_the_end(tmp_path, capsys):
    """The JAX package's round trip on the port: park, splice into the file,
    reload through the loader, load_state on a fresh runner, run to DONE."""
    _, pr, batch, _ = _general_park("top_park")
    path = tmp_path / "prog.json5"
    path.write_text(tp.SAVE_SRC)
    pr.save_to_program(batch, 0, "1", "midway", str(path))
    port.loader.invalidate_cache()
    program, _ = port.loader.load(str(path))
    loaded = {k: v for k, v in program["save_states"]["1"].items()
              if k != "label"}
    assert loaded["order_index"] == 3 and loaded["inserts"] == {"a": "v1"}
    runner = pd.DeviceRunner(port.compile_program(program), port_cfg(GEN_CFG),
                             io_factory=port_scripted(["answer"]),
                             device="cpu")
    final = runner.run(vs.stack_rows([runner.load_state(loaded)]),
                       inner_steps=16)
    r = runner.results(final)[0]
    capsys.readouterr()
    assert (r.status, r.output) == (DONE, "[v1][answer]")


# ---- across engines and the host ---------------------------------------------------

def _general_resume(src, state, responses=()):
    runner = pd.DeviceRunner(compile_port(src), port_cfg(GEN_CFG),
                             io_factory=port_scripted(responses),
                             device="cpu")
    final = runner.run(vs.stack_rows([runner.load_state(state)]),
                       inner_steps=8, max_rounds=200)
    return runner.results(final)[0]


def _turbo_resume(src, state, responses=(), tcfg=PORT_TCFG):
    eng = port_engine(src, tcfg, responses)
    return eng.results(eng.run(eng.load_batch([state]), max_rounds=200))[0]


def test_turbo_save_resumes_on_the_general_engine_and_back(capsys):
    """tests/test_turbo.py:1020-1060 on the port: a turbo export resumes on
    the general engine, and a general export on the turbo engine."""
    eng = port_engine(tp.SAVE_SRC)
    batch = eng.make_batch(1)
    eng.step_fn(1)(batch)
    state = eng.export_state(batch, 0)
    assert state == {"inserts": {"a": "v1"}, "output": "[v1]",
                     "order_index": 3}
    r = _general_resume(tp.SAVE_SRC, state, ["ans"])
    assert (r.status, r.output) == (DONE, "[v1][ans]")
    runner = pd.DeviceRunner(compile_port(tp.SAVE_SRC), port_cfg(GEN_CFG),
                             device="cpu")
    b2 = runner.launch(runner.make_instances(1), 16)
    r2 = _turbo_resume(tp.SAVE_SRC, runner.export_state(b2, 0), ["two"])
    capsys.readouterr()
    assert (r2.status, r2.output) == (DONE, "[v1][two]")


def test_mid_parallel_save_resumes_to_the_host_on_both_engines(tmp_path,
                                                               capsys):
    """A turbo export inside a parallel block carries per-lane chains and
    resumes, on the general engine, the turbo engine and the host, to the
    uninterrupted host's result."""
    host = run_host(tp.PAR_SAVE_SRC, tmp_path)
    _, eng, batch, _ = _turbo_park("mid_parallel")
    state = eng.export_state(batch, 0)
    want = (DONE, host["output"], dict(host["inserts"]))
    for r in (_general_resume(tp.PAR_SAVE_SRC, state),
              _turbo_resume(tp.PAR_SAVE_SRC, state)):
        assert (r.status, r.output, r.inserts) == want
    back = port_host_from_state(tp.PAR_SAVE_SRC, tmp_path, state)
    capsys.readouterr()
    assert (back["output"], dict(back["inserts"])) == want[1:]


def test_mid_block_device_save_resumes_on_the_port_host(tmp_path, capsys):
    """tests/test_device_save_load.py:161-200 on the port: a general-engine
    export inside for > serial resumes through the port's host menu (Load
    State of a seeded slot) and on both device engines to the same
    output."""
    _, pr, batch, _ = _general_park("nested")
    state = pr.export_state(batch, 0)
    assert any(k.endswith("/counter") and v == 1 for k, v in state.items())
    assert state["output"] == "start;<a"
    want = "start;<a=one><b=two><c=three>;end"
    answers = ["one", "two", "three"]
    path = tmp_path / "resume_host.json5"
    path.write_text(tp.NESTED_SRC.replace(
        "save_states: {}",
        "save_states: {'1': " + port.json5.dumps(
            {**state, "label": "mid"}) + "}"))
    holder: dict = {}
    backend = PortMenuBackend(["2", "1"], 1, holder)
    run = port.runtime.ProgramRun(str(path), [],
                                  port.io_manager.IOManager(backend))
    holder["run"] = run

    async def drive():
        task = asyncio.create_task(run.run())
        while len(backend.exchanges) < 2:
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        backend.responses.extend(answers)
        run.toggle_menu()
        return await task
    port.loader.invalidate_cache()
    assert asyncio.run(drive())["output"] == want
    assert _general_resume(tp.NESTED_SRC, state, answers).output == want
    assert _turbo_resume(tp.NESTED_SRC, state, answers).output == want
    capsys.readouterr()


def test_host_mid_block_save_resumes_on_both_device_engines(tmp_path,
                                                            capsys):
    """tests/test_device_save_load.py:205-245 on the port: the port's host
    menu saves inside for > serial at the second iteration's input; the
    slot resumes on the general and the turbo engine."""
    path = tmp_path / "mid_host.json5"
    path.write_text(tp.NESTED_SRC)
    holder: dict = {}
    backend = PortMenuBackend(["one", "1", "1", "mid", "4"], 2, holder)
    run = port.runtime.ProgramRun(str(path), [],
                                  port.io_manager.IOManager(backend))
    holder["run"] = run
    port.loader.invalidate_cache()
    asyncio.run(run.run())
    port.loader.invalidate_cache()
    program, _ = port.loader.load(str(path))
    saved = dict(program["save_states"]["1"])
    saved.pop("label")
    assert any(k.startswith("order_index/") for k in saved), saved
    want = "start;<a=one><b=two><c=three>;end"
    for r in (_general_resume(tp.NESTED_SRC, saved, ["two", "three"]),
              _turbo_resume(tp.NESTED_SRC, saved, ["two", "three"])):
        assert (r.status, r.output) == (DONE, want)
    capsys.readouterr()


def test_divergent_and_ring_cells_build_with_load_batch(capsys):
    """bench.py's divergent (8 states at spread order indexes) and ring (one
    in ten at sel 'park') batches: load_batch dedups them to 8 and 2 rows
    and each instance ends as the host resumed from its class's state."""
    src = bench.adventure_program(t_max=3)
    eng = port_engine(src, pt.TurboConfig(tile=8, width=64, out_width=192,
                                          k_steps=24))
    states = port_bench.divergent_states(eng.compiled, eng.plan.slot_of,
                                         16, 8)
    calls = _count_uniques(eng)
    batch = eng.load_batch(states)
    assert len(calls) == 8
    res = eng.results(eng.run(batch, max_rounds=200))
    ring_src = bench.RING_PROGRAM.replace("'1073741824'", "'3'")
    ring = port_engine(ring_src, responses=["ok"] * 8)
    ring_states = port_bench.ring_states(ring.compiled, 20, 0.10)
    rcalls = _count_uniques(ring)
    rres = ring.results(ring.run(ring.load_batch(ring_states),
                                 max_rounds=200))
    assert len(rcalls) == 2
    capsys.readouterr()
    for source, sts, results in ((src, states, res),
                                 (ring_src, ring_states, rres)):
        want = {}
        for st, r in zip(sts, results):
            key = json.dumps(st, sort_keys=True)
            if key not in want:
                import tempfile
                import pathlib
                with tempfile.TemporaryDirectory() as d:
                    host = port_host_from_state(source, pathlib.Path(d), st,
                                                ["ok"] * 8)
                want[key] = (DONE, host["output"], dict(host["inserts"]))
            assert (r.status, r.output, r.inserts) == want[key]
    capsys.readouterr()
