"""The port's turbo step on the CPU (its plain PyTorch version) against the
JAX TurboEngine (Pallas interpret mode) and the exact host executor: equal
output, inserts, status and steps at DONE or at the same park. Exact: every
value is a byte or an int32.

The port runs each lane at its own pc, the TPU kernel the lowest live pc,
so the two are compared only where an instance has stopped."""

import numpy as np
import pytest
import torch

import bench
import torch_programs as tp
from torch_helpers import (SIZES, port_engine, jax_engine, run_host,
                           run_jax, run_port, summary)

from interpolation_engine_tpu.core.interp import InterpolationException
from interpolation_engine_tpu_torch._shared import host_interp, planner
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE, PARKED
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import turbo as port_turbo
from interpolation_engine_tpu_torch.vm.turbo import C_CLREPOCH, C_PC, C_STEPS
from interpolation_engine_tpu_torch.vm.turbo_tables import NotPorted

BENCH_LIKE = bench.BENCH_PROGRAM.replace("'spin-512'", "'spin-12'")
INTERP_SMALL = bench.INTERP_PROGRAM.replace("'1073741824'", "'9'")
RING_SMALL = bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'") \
    .replace("'1073741824'", "'3'")

DIFFERENTIAL = dict(tp.AGREEING, bench_like=BENCH_LIKE)


def assert_three_agree(src, tmp_path, capsys, responses=(), n=2, width=64):
    host = run_host(src, tmp_path, responses)
    capsys.readouterr()
    sizes = dict(SIZES, width=width)
    jax_res = run_jax(src, n, jax_turbo.TurboConfig(**sizes), responses)
    port_res = run_port(src, n, port_turbo.TurboConfig(**sizes), responses)
    for j, p in zip(jax_res, port_res):
        assert summary(p) == summary(j)
        assert p.status == DONE
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))
    return port_res


@pytest.mark.parametrize("name", sorted(DIFFERENTIAL))
def test_port_agrees_with_jax_and_host(name, tmp_path, capsys):
    assert_three_agree(DIFFERENTIAL[name], tmp_path, capsys)


def test_interp_program_at_its_width(tmp_path, capsys):
    # its 100-byte line outgrows the small config's 64-byte slots
    assert_three_agree(INTERP_SMALL, tmp_path, capsys, width=128)


def test_ring_program_parks_three_times(tmp_path, capsys):
    assert_three_agree(RING_SMALL, tmp_path, capsys,
                       responses=["a", "b", "c"])


# ---- one test per hazard of a hand port of the TPU kernel --------------------

def test_negative_floor_div_and_mod(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.FLOOR_DIV_MOD, tmp_path, capsys)
    assert r.output == "2 -2 -1 -4 2"


def test_inexact_division_parks_to_the_host_error(tmp_path, capsys):
    with pytest.raises(AssertionError) as host_err:
        run_host(tp.INEXACT_DIV, tmp_path)
    with pytest.raises(AssertionError) as jax_err:
        run_jax(tp.INEXACT_DIV, 1)
    with pytest.raises(AssertionError) as port_err:
        run_port(tp.INEXACT_DIV, 1)
    assert str(port_err.value) == str(jax_err.value) == str(host_err.value)


def test_int32_wraparound_as_the_jax_kernel():
    # the TPU kernel wraps at 32 bits; the host's Python ints grow, so the
    # port is held to the JAX engine here (ROADMAP, known divergences)
    (p,) = run_port(tp.INT32_OVERFLOW, 1)
    (j,) = run_jax(tp.INT32_OVERFLOW, 1)
    assert summary(p) == summary(j)
    assert p.output == "-2147483648 2147483647 1 -2147483648"


def test_int32_min_prints_like_python(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.INT32_MIN_PRINT, tmp_path, capsys)
    assert r.output == "[-2147483648|0|-2147483647] -2147483648"


def test_ten_digit_string_parks_for_the_host(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.PARSE_DIGITS, tmp_path, capsys)
    assert r.inserts["p10"] == 1234567891


def test_brace_in_hole_value_parks(tmp_path, capsys):
    assert_three_agree(tp.BRACE_IN_HOLE, tmp_path, capsys)
    eng = port_engine(tp.BRACE_IN_HOLE)
    batch = eng.step_fn(1)(eng.make_batch(1))
    # the first print ran in the kernel; the second parks on the escape
    assert int(batch.regs[0, 1]) == PARKED and int(batch.regs[0, C_PC]) == 1


def test_render_longer_than_width_parks():
    wide = """
    {default_state: {order_index: 1, inserts: {v: '%s'}},
     order: [{cmd:'set', item:'{v}{v}', output_name:'w'}],
     named_tasks: {}, save_states: {}}""" % ("x" * 40)
    eng = port_engine(wide)
    batch = eng.step_fn(1)(eng.make_batch(1))
    assert int(batch.regs[0, 1]) == PARKED and int(batch.regs[0, C_STEPS]) == 1


def test_output_overflow_parks_and_spills(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.OUTPUT_OVERFLOW, tmp_path, capsys)
    assert len(r.output) > 192


def test_single_non_string_hole_print_raises_as_host(tmp_path, capsys):
    with pytest.raises(AttributeError) as host_err:
        run_host(tp.SINGLE_HOLE_INT, tmp_path)
    with pytest.raises(AttributeError) as port_err:
        run_port(tp.SINGLE_HOLE_INT, 1)
    assert str(port_err.value) == str(host_err.value)


def test_missing_key_raises_as_host(tmp_path, capsys):
    with pytest.raises(InterpolationException):
        run_host(tp.MISSING_KEY, tmp_path)
    with pytest.raises(host_interp.InterpolationException):
        run_port(tp.MISSING_KEY, 1)


def test_int_dispatch_skips_non_canonical_keys(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.INT_DISPATCH, tmp_path, capsys)
    assert r.output == "three 3"
    eng = port_engine(tp.INT_DISPATCH)
    ents = eng.tables.host.ents
    # '01' and '002' never match an int; '-1', '3' and '*' stay
    assert ents[:, 1].tolist() == [-1, 3, 0]


def test_await_ready_continues_in_kernel(tmp_path, capsys):
    (r, _) = assert_three_agree(tp.AWAIT_READY, tmp_path, capsys)
    eng = port_engine(tp.AWAIT_READY)
    batch = eng.step_fn(1)(eng.make_batch(1))
    assert int(batch.regs[0, 1]) == DONE and int(batch.regs[0, C_STEPS]) == 2


def test_await_not_ready_parks_without_a_step():
    port = port_engine(tp.AWAIT_NOT_READY)
    pb = port.step_fn(1)(port.make_batch(1))
    jax = jax_engine(tp.AWAIT_NOT_READY)
    jb = jax.step_fn(8)(jax.make_batch(1))
    for regs in (pb.regs.numpy(), np.asarray(jb.regs)):
        assert regs[0, 1] == PARKED and regs[0, C_PC] == 1
        assert regs[0, C_STEPS] == 1     # the print; the park adds none
    assert port.results(pb)[0].output == jax.results(jb, 1)[0].output


def test_clear_bumps_the_clear_epoch():
    port = port_engine(tp.DELETE_CLEAR)
    pb = port.run(port.make_batch(1))
    jax = jax_engine(tp.DELETE_CLEAR)
    jb = jax.run(jax.make_batch(1))
    assert int(pb.regs[0, C_CLREPOCH]) == int(jb.regs[0, C_CLREPOCH]) == 1


def test_halt_takes_no_step():
    src = """{default_state: {order_index: 1, inserts: {}},
              order: [{cmd:'print', text:'x'}],
              named_tasks: {}, save_states: {}}"""
    (p,) = run_port(src, 1)
    (j,) = run_jax(src, 1)
    assert p.steps == j.steps == 1 and p.status == DONE


def test_adventure_raises_not_ported(tmp_path, capsys):
    """No list or lane instruction raises NotPorted (a class nothing on the
    turbo path raises, and no NotTurbo): the adventure program runs to DONE
    equal to the host and to JAX."""
    assert_three_agree(bench.adventure_program(t_max=12), tmp_path, capsys)
    assert not issubclass(NotPorted, planner.NotTurbo)


# ---- the plain version's helpers against Python --------------------------------

def test_int_to_dec_is_python_str():
    rng = torch.Generator().manual_seed(0)
    vals = torch.randint(-2**31, 2**31, (256,), generator=rng,
                         dtype=torch.int64)
    vals = torch.cat([vals, torch.tensor([0, -1, 9, 10, -2**31, 2**31 - 1])])
    buf, ln = ts._int_to_dec(vals)
    for v, b, n in zip(vals.tolist(), buf, ln.tolist()):
        assert bytes(b[:n].tolist()).decode() == str(v)
        assert not b[n:].any()


@pytest.mark.parametrize("text,value", [
    ("0", 0), ("-0", 0), ("+7", 7), ("007", 7), ("999999999", 999999999),
    ("-123456789", -123456789), ("1234567890", None), ("", None),
    ("-", None), ("1a", None), (" 1", None), ("+-1", None)])
def test_parse_dec_takes_at_most_nine_digits(text, value):
    buf = torch.zeros((1, 16), dtype=torch.uint8)
    data = text.encode()
    buf[0, :len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    got, ok = ts._parse_dec(buf, torch.tensor([len(data)]))
    assert bool(ok) == (value is not None)
    if value is not None:
        assert int(got) == value
