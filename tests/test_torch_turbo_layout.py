"""The port's register and row layout is the JAX package's: the same
``_Cols`` columns and rows (element kinds, element cells and thread-lane
columns included), the same literal rows, the same encoded rows and decodes,
and a batch carried from one engine to the other mid-run finishes with the
same results. The JAX package's int32 meta row of a list slot is the port's
``meta`` plane."""

import numpy as np
import pytest

import jax.numpy as jnp

import bench
import torch_programs as tp
from torch_helpers import (JAX_TCFG, PORT_TCFG, jax_engine, plans,
                           port_engine, run_host, summary)

from interpolation_engine_tpu.vm import config as jax_config
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch.ops import turbo_step as port_step
from interpolation_engine_tpu_torch.vm import turbo as port_turbo

BENCH_LIKE = bench.BENCH_PROGRAM.replace("'spin-512'", "'spin-12'")
ADVENTURE = bench.adventure_program(t_max=12)
PROGRAMS = dict(tp.AGREEING, bench_like=BENCH_LIKE,
                interp=bench.INTERP_PROGRAM, ring=bench.RING_PROGRAM,
                adventure=bench.adventure_program(),
                race_io=bench.race_io_program(),
                list_spine=tp.LIST_SPINE, list_edges=tp.LIST_EDGES,
                par_race=tp.PAR_RACE % {"mode": "race"},
                midblock=tp.MIDBLOCK_PARK % {"mode": "wait"})


def _layout(cols):
    return dict(
        regw=cols.regw, n_rows=cols.n_rows, str_row=cols.str_row,
        meta_row=cols.meta_row, list_row0=cols.list_row0, kinds=cols.kinds,
        slots=[(cols.stype(s), cols.sint(s), cols.slen(s))
               for s in range(cols.S)],
        loops=[cols.loop(i) for i in range(cols.n_loops)],
        bases=(cols._threads0, cols._slots0, cols._loops0),
        ekinds={s: cols.ekind(s) for s in cols.list_ord},
        elem_pos={s: [cols.elem_pos(s, e) for e in range(cols.E)]
                  for s in cols.list_ord},
        lanes=[(cols.tpc(l), cols.tstate(l), cols.tparg(l))
               for l in range(cols.nt)])


CONTROL = ("C_PC", "C_STATUS", "C_STEPS", "C_OUTLEN", "C_CURTID",
           "C_PARMODE", "C_PARJOIN", "C_PAREPOCH", "C_CLREPOCH", "C_BASE",
           "RUNNING", "DONE", "PARKED", "T_FREE", "T_NEW", "T_READY",
           "T_WAIT", "T_DONE", "PM_NONE", "PM_WAIT", "PM_DRAIN")


@pytest.mark.parametrize("name", CONTROL)
def test_control_columns_and_codes_equal_jax(name):
    """The control columns (kept in ``ops/turbo_step.py``) and the status,
    lane and block codes (kept in ``vm/config.py``), as the step wrapper
    and the engine (those it reads) take them, are the JAX package's."""
    want = getattr(jax_turbo, name, None)
    if want is None:
        want = getattr(jax_config, name)
    assert isinstance(want, int)
    assert getattr(port_step, name) == want
    assert getattr(port_turbo, name, want) == want


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cols_equal_jax(name):
    jplan, pplan = plans(PROGRAMS[name])
    for width in (64, 128, 512):
        j = jax_turbo._make_cols(jplan, jax_turbo.TurboConfig(width=width))
        p = port_turbo._make_cols(pplan, port_turbo.TurboConfig(width=width))
        assert _layout(p) == _layout(j)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_literal_rows_equal_jax(name):
    jplan, pplan = plans(PROGRAMS[name])
    j, p = jax_turbo._LitTable(128), port_turbo._LitTable(128)
    j.collect(jplan.instrs)
    p.collect(pplan.instrs)
    assert p.index == j.index
    assert (p.array() == j.array()).all()
    assert p.lengths().tolist() == [len(d) for d in p.index]


@pytest.mark.parametrize("name", ["bench_like", "copy_types", "parse_digits",
                                  "brace_in_hole", "list_spine",
                                  "list_edges", "race_io"])
def test_make_batch_and_decode_equal_jax(name):
    src = PROGRAMS[name]
    jax_eng, port_eng = jax_engine(src), port_engine(src)
    jb, pb = jax_eng.make_batch(3), port_eng.make_batch(3)
    jax_np = [np.asarray(x) for x in jb]
    for got, want in zip(port_turbo.to_jax_batch(port_eng.cols, pb),
                         (jax_np[0][:3], jax_np[1][:, :3], jax_np[2][:3])):
        assert (got == want).all()
    jsub = dict(zip(("regs", "sbuf", "out"), jax_np))
    psub = {k: v.numpy() for k, v in pb._asdict().items()}
    for j in range(3):
        assert port_eng._decode_row(psub, j) == jax_eng._decode_row(jsub, j)


def test_jax_batch_round_trips_the_meta_planes():
    # a list of both element kinds, and ints past a byte in the meta cells
    src = tp.LIST_EDGES.replace("[3,1,'x']", "[3000000,-1,'x']")
    jax_eng, port_eng = jax_engine(src), port_engine(src)
    cols = port_eng.cols
    jb = [np.asarray(x)[..., :3, :] if i == 1 else np.asarray(x)[:3]
          for i, x in enumerate(jax_eng.make_batch(3))]
    pb = port_turbo.from_jax_batch(cols, *jb, device="cpu")
    assert pb.meta.shape == (len(cols.list_ord), 3, 3 * cols.E)
    s = port_eng.plan.slot_of["l"]
    assert pb.meta[cols.list_ord[s], :, cols.E].tolist() == [3000000] * 3
    for row in cols.meta_row.values():
        assert not pb.sbuf[row].any()    # the meta rows stay zero here
    for got, want in zip(port_turbo.to_jax_batch(cols, pb), jb):
        assert (got == want).all()
    again = port_turbo.from_jax_batch(cols, *port_turbo.to_jax_batch(
        cols, pb), device="cpu")
    assert all(bool((a == b).all()) for a, b in zip(again, pb))


@pytest.fixture(scope="module")
def bench_engines():
    # 241 steps: more than one launch of either engine
    src = bench.BENCH_PROGRAM.replace("'spin-512'", "'spin-60'")
    return jax_engine(src), port_engine(src)


def _to_jax(eng, pb):
    return jax_turbo.TurboBatch(*(jnp.asarray(x) for x in
                                  port_turbo.to_jax_batch(eng.cols, pb)))


def test_state_carried_from_jax_to_port(bench_engines):
    jax_eng, port_eng = bench_engines
    step = jax_eng.step_fn(8)
    jb = step(jax_eng.make_batch(8))
    pb = port_turbo.from_jax_batch(port_eng.cols,
                                   *(np.asarray(x) for x in jb),
                                   device="cpu")
    assert int(pb.regs[:, 1].eq(DONE).sum()) == 0   # stopped mid-run
    port_res = port_eng.results(port_eng.run(pb), 8)
    jax_res = jax_eng.results(jax_eng.run(jb), 8)
    assert [summary(r) for r in port_res] == [summary(r) for r in jax_res]
    assert all(r.status == DONE for r in port_res)


def test_state_carried_from_port_to_jax(bench_engines):
    jax_eng, port_eng = bench_engines
    step = port_eng.step_fn(8)
    pb = step(step(port_eng.make_batch(8)))
    jb = _to_jax(port_eng, pb)
    jax_eng._n_live = 8
    jax_res = jax_eng.results(jax_eng.run(jb), 8)
    port_res = port_eng.results(port_eng.run(pb), 8)
    assert [summary(r) for r in port_res] == [summary(r) for r in jax_res]
    assert all(r.status == DONE for r in jax_res)


@pytest.fixture(scope="module")
def adventure_engines():
    """The JAX engine's one build of the 100-instruction adventure kernel
    (about 30 s in interpret mode) serves every test below."""
    return jax_engine(ADVENTURE), port_engine(ADVENTURE)


def test_adventure_state_carried_from_jax_to_port(adventure_engines):
    jax_eng, port_eng = adventure_engines
    step = jax_eng.step_fn(8)
    jb = step(step(jax_eng.make_batch(8)))
    pb = port_turbo.from_jax_batch(port_eng.cols,
                                   *(np.asarray(x) for x in jb),
                                   device="cpu")
    assert int(pb.regs[:, 1].eq(DONE).sum()) == 0   # stopped mid-run
    assert int(pb.meta[:, :, :port_eng.cols.E].ne(0).sum()) > 0
    port_res = port_eng.results(port_eng.run(pb), 8)
    jax_res = jax_eng.results(jax_eng.run(jb), 8)
    assert [summary(r) for r in port_res] == [summary(r) for r in jax_res]
    assert all(r.status == DONE for r in port_res)


def test_tables_raise_not_ported_for_lists(adventure_engines, tmp_path,
                                           capsys):
    """No list or lane instruction raises: the adventure program (lists,
    a parallel race, a loop) runs to DONE equal to the host and to JAX."""
    host = run_host(ADVENTURE, tmp_path)
    capsys.readouterr()
    jax_eng, port_eng = adventure_engines
    port_res = port_eng.results(port_eng.run(port_eng.make_batch(2)))
    jax_res = jax_eng.results(jax_eng.run(jax_eng.make_batch(2)), 2)
    assert [summary(r) for r in port_res] == [summary(r) for r in jax_res]
    for r in port_res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    assert JAX_TCFG.width == PORT_TCFG.width
