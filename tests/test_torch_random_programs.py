"""Random programs through the port on the CPU and the exact host engine: the
same output and inserts at DONE, or the same error; every eighth also
against the JAX engine. Scalar ones (``torch_programs.random_scalar_program``)
and ones with list ops and parallel blocks whose lanes may block on input
(``torch_programs.random_program``)."""

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
# "1", "beta" and "2" answer a user_choice; "7" is out of its range
LANE_RESPONSES = ["ada", "1", "x y", "beta", "{brace", "2", "tail", "3",
                  "gm", "plain", "7", "z}"] * 4


def program(make, seed: int) -> str:
    src = json5.dumps(make(random.Random(seed)), indent=2)
    plan_turbo(compile_src(src))   # turbo by construction; NotTurbo fails
    return src


def agree(src, idx, responses, tmp_path, capsys):
    path = tmp_path / "p.json5"
    path.write_text(src)
    try:
        state = asyncio.run(async_main(
            str(path), [], IOManager(ScriptedBackend(list(responses)))))
        host = (state["output"], dict(state["inserts"]))
    except Exception as e:   # the host's error is the expected result
        host = type(e)
    capsys.readouterr()
    if isinstance(host, type):
        with pytest.raises(host):
            run_port(src, 2, responses=responses)
        return
    port = run_port(src, 2, responses=responses)
    for r in port:
        assert r.status == DONE
        assert (r.output, r.inserts) == host
    if idx % 8 == 0:
        jax_res = run_jax(src, 2, responses=responses)
        assert [summary(r) for r in port] == [summary(r) for r in jax_res]


@pytest.mark.parametrize("idx", range(40))
def test_random_program_agrees_with_host(idx, tmp_path, capsys):
    src = program(tp.random_scalar_program, 7000 + idx)
    agree(src, idx, RESPONSES, tmp_path, capsys)


@pytest.mark.parametrize("idx", range(24))
def test_random_list_and_lane_program_agrees_with_host(idx, tmp_path,
                                                       capsys):
    src = program(tp.random_program, 9000 + idx)
    agree(src, idx, LANE_RESPONSES, tmp_path, capsys)
