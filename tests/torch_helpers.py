"""Run one program through the host engine, the JAX turbo engine (Pallas in
interpret mode, as tests/test_turbo.py runs it) and the PyTorch port on the
CPU, at the JAX package's small test size.

Each package compiles with its own compiler and serves IO with its own
classes: the port keeps its own copy of the host layers, so its singletons
(``CTX``, ``EVENTS``), exception classes and IO backends are not the JAX
package's. ``compile_port`` holds the two ``CompiledProgram``s equal."""

import asyncio
import contextlib
import dataclasses

import numpy as np
import pytest

from interpolation_engine_tpu import json5
from interpolation_engine_tpu.compiler import compile_program
from interpolation_engine_tpu.core.runtime import async_main
from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.programs.loader import add_line_numbers
from interpolation_engine_tpu.programs.validator import validate_program
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.vm import turbo as port_turbo

SIZES = dict(tile=8, width=64, out_width=192, k_steps=24)
JAX_TCFG = jax_turbo.TurboConfig(**SIZES)
PORT_TCFG = port_turbo.TurboConfig(**SIZES)


def compile_src(src: str):
    """The JAX package's CompiledProgram."""
    program = json5.loads(add_line_numbers(src))
    validate_program(program)
    return compile_program(program)


def assert_same_compiled(j, p) -> None:
    """Every field of two CompiledPrograms equal (arrays by value)."""
    assert type(j).__name__ == type(p).__name__
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(p, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert j.n_instr == p.n_instr


def compile_port(src: str):
    """The port's CompiledProgram, held equal to the JAX package's."""
    program = port.json5.loads(port.loader.add_line_numbers(src))
    port.validator.validate_program(program)
    compiled = port.compile_program(program)
    assert_same_compiled(compile_src(src), compiled)
    return compiled


def plain(x):
    """A value of either package's planner or compiler as nested tuples of
    class names and field values, so that the two packages' objects
    compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((repr(k), plain(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    return x


def plans(src: str) -> tuple:
    """(the JAX package's plan, the port's), held equal: instructions, slot
    names and kinds, park kinds and lanes."""
    from interpolation_engine_tpu.compiler.turbo import plan_turbo
    j = plan_turbo(compile_src(src))
    p = port.planner.plan_turbo(compile_port(src))
    for f in ("instrs", "slot_names", "slot_of", "n_parks", "park_kind_of",
              "slot_kinds", "elem_kinds", "needs_threads"):
        assert plain(getattr(p, f)) == plain(getattr(j, f)), f
    return j, p


def scripted(responses):
    return lambda i: IOManager(ScriptedBackend(list(responses)))


def port_scripted(responses):
    io = port.io_manager
    return lambda i: io.IOManager(io.ScriptedBackend(list(responses)))


def run_host(src: str, tmp_path, responses=()) -> dict:
    path = tmp_path / "prog.json5"
    path.write_text(src)
    return asyncio.run(async_main(str(path), [],
                                  IOManager(ScriptedBackend(list(responses)))))


def same_error(port_call, e: Exception, message: bool = True):
    """The port's call raises an error of the class name (and, with
    ``message``, the message) of ``e``, raised by the JAX package or its
    host engine; returns it."""
    with pytest.raises(Exception) as err:
        port_call()
    assert type(err.value).__name__ == type(e).__name__
    if message:
        assert str(err.value) == str(e)
    return err.value


@contextlib.contextmanager
def fast_ring(on: bool):
    """``IE_TPU_FAST_RING`` for the port's engines made inside: each reads
    it when it is made (a promotion sibling takes its parent's switch), so
    ``fast_ring(False)`` sends every park of theirs the exact way."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("IE_TPU_FAST_RING", "1" if on else "0")
        yield


def port_engine(src: str, tcfg=PORT_TCFG, responses=(), fast: bool = True,
                **kw):
    """The port's turbo engine on the CPU, or over ``mesh=``, with its fast
    park path on or off."""
    if "mesh" not in kw:
        kw["device"] = "cpu"
    with fast_ring(fast):
        return port_turbo.TurboEngine(compile_port(src), tcfg,
                                      io_factory=port_scripted(responses),
                                      **kw)


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
        same_error(lambda: run_port(src, n, tcfg, responses), e)
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


def port_cfg(cfg):
    """The port's VMConfig with the fields of the JAX package's."""
    return port.vm_config.VMConfig(**dataclasses.asdict(cfg))


def jax_snapshot(batch) -> dict:
    import numpy as np
    return {f: np.asarray(getattr(batch, f)) for f in batch._fields}


def general_pair(src: str, responses=ANSWERS, cfg=GEN_CFG):
    """A JAX DeviceRunner (eager: the same state after each launch as jit,
    at a fraction of the CPU compile) and the port's, on one program, each
    recording its batch after every launch in ``.snaps``."""
    jr = jax_driver.DeviceRunner(compile_src(src), cfg, io_factory=scripted(
        responses), mode="eager")
    pr = port_driver.DeviceRunner(compile_port(src), port_cfg(cfg),
                                  io_factory=port_scripted(responses),
                                  device="cpu")
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
    same_error(port_call, e)


# ---------------------------------------------------------------------------
# save and resume: the port's menu-driving backend and its host engine
# ---------------------------------------------------------------------------

class PortMenuBackend(port.io_manager.ScriptedBackend):
    """The port's twin of ``tests/test_menu.py``'s MenuScriptedBackend: the
    ``menu_at_input``-th user_input opens the run's menu (Esc) and waits to
    be cancelled; an empty script waits too, until cancelled."""

    def __init__(self, responses, menu_at_input: int, run_holder: dict):
        super().__init__(list(responses))
        self.n_inputs = 0
        self.menu_at_input = menu_at_input
        self.run_holder = run_holder

    async def user_input(self, prompt: str, default: str = "") -> str:
        self.n_inputs += 1
        if self.n_inputs == self.menu_at_input:
            self.run_holder["run"].toggle_menu()
            await asyncio.Event().wait()
        if not self.responses:
            await asyncio.Event().wait()
        return await super().user_input(prompt, default)

    async def select_index(self, options, description=None) -> int:
        if not self.responses:
            await asyncio.Event().wait()
        return await super().select_index(options, description)


def port_host_from_state(src: str, tmp_path, state: dict, responses=()):
    """The port's host engine resumed from ``state`` (its default_state
    replaced, line numbers kept: ``torch_programs.with_state``)."""
    from torch_programs import with_state
    path = tmp_path / "resumed_host.json5"
    path.write_text(with_state(src, state))
    io = port.io_manager
    port.loader.invalidate_cache()
    return asyncio.run(port.runtime.async_main(
        str(path), [], io.IOManager(io.ScriptedBackend(list(responses)))))
