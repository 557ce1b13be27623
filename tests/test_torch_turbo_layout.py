"""The port's register and row layout is the JAX package's: the same
``_Cols`` columns and rows, the same literal rows, the same encoded rows and
decodes, and a batch carried from one engine to the other mid-run finishes
with the same results."""

import numpy as np
import pytest

import jax.numpy as jnp

import bench
import torch_programs as tp
from torch_helpers import (JAX_TCFG, PORT_TCFG, compile_src, jax_engine,
                           port_engine, summary)

from interpolation_engine_tpu.compiler.turbo import plan_turbo
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch.vm import turbo as port_turbo

BENCH_LIKE = bench.BENCH_PROGRAM.replace("'spin-512'", "'spin-12'")
PROGRAMS = dict(tp.AGREEING, bench_like=BENCH_LIKE,
                interp=bench.INTERP_PROGRAM, ring=bench.RING_PROGRAM,
                adventure=bench.adventure_program(),
                race_io=bench.race_io_program())


def _layout(cols):
    return dict(
        regw=cols.regw, n_rows=cols.n_rows, str_row=cols.str_row,
        meta_row=cols.meta_row, list_row0=cols.list_row0, kinds=cols.kinds,
        slots=[(cols.stype(s), cols.sint(s), cols.slen(s))
               for s in range(cols.S)],
        loops=[cols.loop(i) for i in range(cols.n_loops)],
        bases=(cols._threads0, cols._slots0, cols._loops0))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cols_equal_jax(name):
    plan = plan_turbo(compile_src(PROGRAMS[name]))
    for width in (64, 128, 512):
        j = jax_turbo._make_cols(plan, jax_turbo.TurboConfig(width=width))
        p = port_turbo._make_cols(plan, port_turbo.TurboConfig(width=width))
        assert _layout(p) == _layout(j)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_literal_rows_equal_jax(name):
    plan = plan_turbo(compile_src(PROGRAMS[name]))
    j, p = jax_turbo._LitTable(128), port_turbo._LitTable(128)
    j.collect(plan.instrs)
    p.collect(plan.instrs)
    assert p.index == j.index
    assert (p.array() == j.array()).all()
    assert p.lengths().tolist() == [len(d) for d in p.index]


@pytest.mark.parametrize("name", ["bench_like", "copy_types",
                                  "parse_digits", "brace_in_hole"])
def test_make_batch_and_decode_equal_jax(name):
    src = PROGRAMS[name]
    jax_eng, port_eng = jax_engine(src), port_engine(src)
    jb, pb = jax_eng.make_batch(3), port_eng.make_batch(3)
    jax_np = [np.asarray(x) for x in jb]
    assert (pb.regs.numpy() == jax_np[0][:3]).all()
    assert (pb.sbuf.numpy() == jax_np[1][:, :3]).all()
    assert (pb.out.numpy() == jax_np[2][:3]).all()
    jsub = dict(zip(("regs", "sbuf", "out"), jax_np))
    psub = {k: v.numpy() for k, v in pb._asdict().items()}
    for j in range(3):
        assert port_eng._decode_row(psub, j) == jax_eng._decode_row(jsub, j)


@pytest.fixture(scope="module")
def bench_engines():
    # 241 steps: more than one launch of either engine
    src = bench.BENCH_PROGRAM.replace("'spin-512'", "'spin-60'")
    return jax_engine(src), port_engine(src)


def test_state_carried_from_jax_to_port(bench_engines):
    jax_eng, port_eng = bench_engines
    step = jax_eng.step_fn(8)
    jb = step(jax_eng.make_batch(8))
    pb = port_turbo.from_jax_batch(*(np.asarray(x) for x in jb),
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
    regs, sbuf, out = port_turbo.to_jax_batch(pb)
    jb = jax_turbo.TurboBatch(jnp.asarray(regs), jnp.asarray(sbuf),
                              jnp.asarray(out))
    jax_eng._n_live = 8
    jax_res = jax_eng.results(jax_eng.run(jb), 8)
    port_res = port_eng.results(port_eng.run(pb), 8)
    assert [summary(r) for r in port_res] == [summary(r) for r in jax_res]
    assert all(r.status == DONE for r in jax_res)


def test_tables_raise_not_ported_for_lists():
    from interpolation_engine_tpu_torch.vm.turbo_tables import NotPorted
    with pytest.raises(NotPorted, match="list"):
        port_turbo.TurboEngine(compile_src(bench.adventure_program()),
                               PORT_TCFG, device="cpu")
    assert JAX_TCFG.width == PORT_TCFG.width
