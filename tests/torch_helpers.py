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


# ---------------------------------------------------------------------------
# the general engine: JAX DeviceRunner (eager) against the port's, on the CPU
# ---------------------------------------------------------------------------

from interpolation_engine_tpu.vm.config import VMConfig  # noqa: E402
from interpolation_engine_tpu.vm import driver as jax_driver  # noqa: E402
from interpolation_engine_tpu_torch.vm import driver as port_driver  # noqa: E402,E501
from interpolation_engine_tpu_torch.vm import state as port_state  # noqa: E402,E501

# the bench's general VMConfig (bench.py:699-701): one config for every
# general-engine test, so JAX's eager handlers compile once per worker
GEN_CFG = VMConfig(max_str=96, max_key=24, n_slots=12, arena_size=1024,
                   pool_size=32, out_size=192, max_subst=6, max_stars=2,
                   max_list=16, max_fix=4)
ANSWERS = ["ok"] * 24


def jax_snapshot(batch) -> dict:
    import numpy as np
    return {f: np.asarray(getattr(batch, f)) for f in batch._fields}


def general_pair(src: str, responses=ANSWERS, cfg=GEN_CFG):
    """A JAX DeviceRunner (eager: the same state after each launch as jit,
    at a fraction of the CPU compile) and the port's, on one program, each
    recording its batch after every launch in ``.snaps``."""
    compiled = compile_src(src)
    jr = jax_driver.DeviceRunner(compiled, cfg, io_factory=scripted(
        responses), mode="eager")
    pr = port_driver.DeviceRunner(compiled, cfg, io_factory=scripted(
        responses), device="cpu")
    jr.snaps, pr.snaps = [], []
    j_launch, p_launch = jr._jitted, pr.launch

    def j_rec(batch, k):
        batch = j_launch(batch, k)
        jr.snaps.append(jax_snapshot(batch))
        return batch

    def p_rec(batch, k):
        batch = p_launch(batch, k)
        pr.snaps.append(batch.to_numpy())
        return batch

    jr._jitted, pr.launch = j_rec, p_rec
    return jr, pr


def assert_same_state(j: dict, p: dict, where: str = "") -> None:
    """Every field of two batches equal (the port's in JAX dtypes)."""
    import numpy as np
    for f in j:
        assert p[f].dtype == j[f].dtype, (where, f, p[f].dtype, j[f].dtype)
        if not np.array_equal(j[f], p[f]):
            rows = np.nonzero(np.any((j[f] != p[f]).reshape(
                j[f].shape[0], -1), axis=1))[0]
            raise AssertionError(f"{where}: field {f} differs in rows "
                                 f"{rows.tolist()}: jax {j[f][rows[0]]} "
                                 f"port {p[f][rows[0]]}")


def run_general_both(src: str, n: int = 2, inner: int = 16,
                     responses=ANSWERS, cfg=GEN_CFG):
    """Run both general engines from the same state through their rings;
    hold them equal after every launch. Returns (jax results, port results,
    port runner), or None where JAX raised and the port raised an error of
    the same class name with the same message."""
    jr, pr = general_pair(src, responses, cfg)
    try:
        jb = jr.make_instances(n)
    except Exception as e:
        _same_error(e, lambda: pr.make_instances(n))
        return None
    pb = port_state.from_jax(jb._asdict())
    assert_same_state(jax_snapshot(jb), pb.to_numpy(), "start")
    try:
        jf = jr.run(jb, inner_steps=inner, max_rounds=400)
    except Exception as e:
        _same_error(e, lambda: pr.run(pb, inner_steps=inner, max_rounds=400))
        _same_snaps(jr, pr)
        return None
    pf = pr.run(pb, inner_steps=inner, max_rounds=400)
    _same_snaps(jr, pr)
    assert jr.ring_stats["parks"] == pr.ring_stats["parks"]
    assert jr.ring_stats["capacity_parks"] == pr.ring_stats["capacity_parks"]
    return jr.results(jf), pr.results(pf), pr


def _same_snaps(jr, pr) -> None:
    assert len(jr.snaps) == len(pr.snaps)
    for k, (a, b) in enumerate(zip(jr.snaps, pr.snaps)):
        assert_same_state(a, b, f"launch {k + 1}")


def _same_error(e: Exception, port_call) -> None:
    with pytest.raises(Exception) as err:
        port_call()
    assert type(err.value).__name__ == type(e).__name__
    assert str(err.value) == str(e)
