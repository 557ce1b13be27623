"""Random scalar programs (``torch_programs.random_scalar_program``) through
the port on the CPU and the exact host engine: the same output and inserts
at DONE, or the same error; every eighth also against the JAX engine."""

import asyncio
import random

import pytest

import torch_programs as tp
from torch_helpers import compile_src, run_jax, run_port, summary

from interpolation_engine_tpu import json5
from interpolation_engine_tpu.compiler.turbo import plan_turbo
from interpolation_engine_tpu.core.runtime import async_main
from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm.config import DONE

# brace, escape, sign and 10-digit answers hit the park paths
RESPONSES = ["ada", "17", "x y", "{brace", "-3", "tail", "z}",
             "9999999999"] * 4


def program(idx: int) -> str:
    src = json5.dumps(tp.random_scalar_program(random.Random(7000 + idx)),
                      indent=2)
    plan_turbo(compile_src(src))   # scalar by construction; NotTurbo fails
    return src


@pytest.mark.parametrize("idx", range(40))
def test_random_program_agrees_with_host(idx, tmp_path, capsys):
    src = program(idx)
    path = tmp_path / "p.json5"
    path.write_text(src)
    try:
        state = asyncio.run(async_main(
            str(path), [], IOManager(ScriptedBackend(list(RESPONSES)))))
        host = (state["output"], dict(state["inserts"]))
    except Exception as e:   # the host's error is the expected result
        host = type(e)
    capsys.readouterr()
    if isinstance(host, type):
        with pytest.raises(host):
            run_port(src, 2, responses=RESPONSES)
        return
    port = run_port(src, 2, responses=RESPONSES)
    for r in port:
        assert r.status == DONE
        assert (r.output, r.inserts) == host
    if idx % 8 == 0:
        jax_res = run_jax(src, 2, responses=RESPONSES)
        assert [summary(r) for r in port] == [summary(r) for r in jax_res]
