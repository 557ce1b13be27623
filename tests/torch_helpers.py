"""Run one program through the host engine, the JAX turbo engine (Pallas in
interpret mode, as tests/test_turbo.py runs it) and the PyTorch port on the
CPU, at the JAX package's small test size."""

import asyncio

import pytest

from interpolation_engine_tpu import json5
from interpolation_engine_tpu.compiler import compile_program
from interpolation_engine_tpu.core.runtime import async_main
from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.programs.loader import add_line_numbers
from interpolation_engine_tpu.programs.validator import validate_program
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu_torch.vm import turbo as port_turbo

SIZES = dict(tile=8, width=64, out_width=192, k_steps=24)
JAX_TCFG = jax_turbo.TurboConfig(**SIZES)
PORT_TCFG = port_turbo.TurboConfig(**SIZES)


def compile_src(src: str):
    program = json5.loads(add_line_numbers(src))
    validate_program(program)
    return compile_program(program)


def scripted(responses):
    return lambda i: IOManager(ScriptedBackend(list(responses)))


def run_host(src: str, tmp_path, responses=()) -> dict:
    path = tmp_path / "prog.json5"
    path.write_text(src)
    return asyncio.run(async_main(str(path), [],
                                  IOManager(ScriptedBackend(list(responses)))))


def port_engine(src: str, tcfg=PORT_TCFG, responses=()):
    return port_turbo.TurboEngine(compile_src(src), tcfg,
                                  io_factory=scripted(responses),
                                  device="cpu")


def jax_engine(src: str, tcfg=JAX_TCFG, responses=()):
    return jax_turbo.TurboEngine(compile_src(src), tcfg,
                                 io_factory=scripted(responses),
                                 interpret=True)


def run_port(src: str, n: int = 2, tcfg=PORT_TCFG, responses=()) -> list:
    eng = port_engine(src, tcfg, responses)
    return eng.results(eng.run(eng.make_batch(n), max_rounds=500))


def run_jax(src: str, n: int = 2, tcfg=JAX_TCFG, responses=()) -> list:
    eng = jax_engine(src, tcfg, responses)
    return eng.results(eng.run(eng.make_batch(n), max_rounds=500))


def summary(r) -> tuple:
    """What the port and the JAX engine must agree on at DONE or a park."""
    return (r.output, r.inserts, r.status, r.steps)


def prog(inserts: str, *tasks: str) -> str:
    """A program source from its inserts and its tasks, as JSON5 text."""
    return ("{default_state: {order_index: 1, inserts: %s}, order: [%s], "
            "named_tasks: {}, save_states: {}}" % (inserts, ", ".join(tasks)))


def agree_with_host(src, tmp_path, capsys, n=2, tcfg=PORT_TCFG,
                    responses=()):
    """The port runs n instances to DONE with the host's output and inserts
    (returns instance 0's result), or raises the host's error (returns
    None)."""
    try:
        host = run_host(src, tmp_path, responses)
    except Exception as e:
        capsys.readouterr()
        with pytest.raises(type(e)) as err:
            run_port(src, n, tcfg, responses)
        assert str(err.value) == str(e)
        return None
    capsys.readouterr()
    res = run_port(src, n, tcfg, responses)
    for r in res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    return res[0]
