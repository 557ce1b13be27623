"""The port's own host layers against the JAX package's: the compiler, the
turbo planner, the exact host runtime and the JSON5 parser give the same
results on every program the tests hold (the repo's bench programs, the
port's test programs, the planner's ineligible constructs and seeded random
programs)."""

import asyncio
import difflib
import math
import pathlib
import random

import pytest

import bench
import test_native_json5 as tnj
import test_turbo_eligibility as te
import torch_programs as tp
from torch_helpers import ANSWERS, compile_port, compile_src, plain, plans

from interpolation_engine_tpu import json5 as jax_json5
from interpolation_engine_tpu.compiler.turbo import NotTurbo, plan_turbo
from interpolation_engine_tpu.core.runtime import async_main
from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.native.build import load_json5c


def repo_programs() -> dict:
    progs = {name: val for name, val in vars(tp).items()
             if isinstance(val, str) and "order:" in val and "%(" not in val}
    for group, table in (("general", tp.general_programs(bench)),
                         ("agree", tp.AGREEING),
                         ("list", tp.LIST_AGREEING),
                         ("ineligible", {c: s for c, s, _ in te.INELIGIBLE})):
        progs.update({f"{group}:{k}": v for k, v in table.items()})
    progs.update({
        "bench:spine": bench.BENCH_PROGRAM, "bench:interp":
        bench.INTERP_PROGRAM, "bench:ring": bench.RING_PROGRAM,
        "bench:adventure": bench.adventure_program(),
        "bench:race_io": bench.race_io_program()})
    for i in range(6):
        progs[f"random:scalar{i}"] = jax_json5.dumps(
            tp.random_scalar_program(random.Random(7000 + i)), indent=2)
        progs[f"random:lanes{i}"] = jax_json5.dumps(
            tp.random_program(random.Random(9000 + i)), indent=2)
    seen, out = set(), {}
    for name in sorted(progs):
        if progs[name] not in seen:
            seen.add(progs[name])
            out[name] = progs[name]
    return out


PROGRAMS = repo_programs()
# programs the host runs to the end quickly (the bench's, cut); the host
# waits for ever on AWAIT_NOT_READY's await_insert
HOST_RUNS = {k: v for k, v in PROGRAMS.items()
             if not k.startswith(("bench:", "ineligible:"))
             and k != "AWAIT_NOT_READY"}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compiler_and_planner_equal_jax(name):
    """The same CompiledProgram (code, aux, strtab, labels, n_instr and every
    other field), and an equal plan or the same NotTurbo message."""
    src = PROGRAMS[name]
    try:
        compiled = compile_src(src)
    except Exception as e:
        with pytest.raises(Exception) as err:
            compile_port(src)
        assert (type(err.value).__name__, str(err.value)) == \
            (type(e).__name__, str(e))
        return
    port_compiled = compile_port(src)
    try:
        plan_turbo(compiled)
    except NotTurbo as e:
        with pytest.raises(port.planner.NotTurbo) as err:
            port.planner.plan_turbo(port_compiled)
        assert str(err.value) == str(e)
        return
    jplan, pplan = plans(src)
    assert plain(pplan.compiled) == plain(jplan.compiled)


def run_host_both(src, tmp_path):
    path = tmp_path / "prog.json5"
    path.write_text(src)

    def run(main, io):
        random.seed(0)   # random_choice: the same draws in both runtimes
        try:
            state = asyncio.run(main(str(path), [], io))
            return ("ok", state["output"], dict(state["inserts"]))
        except Exception as e:
            return ("raise", type(e).__name__, str(e))
    j = run(async_main, IOManager(ScriptedBackend(list(ANSWERS))))
    p = run(port.runtime.async_main, port.io_manager.IOManager(
        port.io_manager.ScriptedBackend(list(ANSWERS))))
    return j, p


@pytest.mark.parametrize("name", sorted(HOST_RUNS))
def test_host_runtime_equals_jax(name, tmp_path, capsys):
    j, p = run_host_both(HOST_RUNS[name], tmp_path)
    capsys.readouterr()
    assert p == j


def test_host_runtime_raises_the_port_classes(tmp_path, capsys):
    """The port's runtime raises its own InterpolationException, a class of
    the same name as the JAX package's but not the same class."""
    from interpolation_engine_tpu.core.interp import InterpolationException
    path = tmp_path / "prog.json5"
    path.write_text(tp.MISSING_KEY)
    with pytest.raises(port.host_interp.InterpolationException) as err:
        asyncio.run(port.runtime.async_main(str(path), [], port.io_manager.
                                            IOManager(port.io_manager.
                                                      BufferBackend())))
    capsys.readouterr()
    assert not isinstance(err.value, InterpolationException)
    assert port.context.CTX is not __import__(
        "interpolation_engine_tpu.core.context", fromlist=["CTX"]).CTX


# ---- JSON5 ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_json5_equals_jax(name):
    src = port.loader.add_line_numbers(PROGRAMS[name])
    assert port.json5.loads(src) == jax_json5.loads(src)
    assert port.json5.py_loads(src) == jax_json5.py_loads(src)


@pytest.mark.parametrize("doc", tnj.BAD_DOCS + ["{a: 1,\n b: [2,\n 3 4]}",
                                                "[1, 2]\n  x"])
def test_json5_errors_equal_jax(doc):
    """The same Json5Error line and column (the port's own class)."""
    for port_loads, jax_loads in ((port.json5.loads, jax_json5.loads),
                                  (port.json5.py_loads, jax_json5.py_loads)):
        with pytest.raises(jax_json5.Json5Error) as jerr:
            jax_loads(doc)
        with pytest.raises(port.json5.Json5Error) as perr:
            port_loads(doc)
        assert (perr.value.line, perr.value.col, str(perr.value)) == \
            (jerr.value.line, jerr.value.col, str(jerr.value))


def test_native_json5_builds_and_equals_the_python_parser():
    """Built into the port's _build/ and loaded under the port's own module
    name, the native parser parses every document and program as the
    Python parser does."""
    native = load_json5c()
    if native is None:
        pytest.skip("no C++ toolchain to build native/json5c.cpp")
    assert native.__name__ == "interpolation_engine_tpu_torch.native.json5c"
    assert "_build" in native.__file__
    assert port.json5.loads is not port.json5.py_loads
    for doc in tnj.DOCS + [port.loader.add_line_numbers(s)
                           for s in PROGRAMS.values()]:
        a, b = port.json5.py_loads(doc), native.loads(doc)
        if isinstance(a, float) and math.isnan(a):
            assert math.isnan(b)
        else:
            assert a == b and type(a) is type(b)


# ---- the copies' text -----------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "interpolation_engine_tpu", \
    ROOT / "interpolation_engine_tpu_torch"
COPIED_DIRS = ("json5", "native", "programs", "tools", "compiler", "core",
               "io", "chat")
COPIED_FILES = ("vm/config.py", "vm/isa.py", "vm/lanering.py", "cli.py")
# every line of a copy that departs from its original, as CHANGES.md lists
# them (1-based, inclusive); None: the whole file is rewritten
DEPARTURES = {
    "cli.py": [(1, 15), (33, 33), (57, 57)],   # docstring, help texts
    "core/__init__.py": [(4, 4)],      # docstring
    # the span and counter recorder (EVENTS.span, count, recording)
    "core/events.py": [(19, 21), (98, 170)],
    "native/json5c.cpp": [(11, 11)],   # the build command in a comment
    "native/build.py": None,           # builds into _build/, loads by path
    "tools/show_tokens.py": [(1, 1), (54, 54)],   # the script's name
    "vm/config.py": [(36, 45)],        # the environment variables it reads
}


def copies() -> list:
    found = [str(f.relative_to(PORT_PKG)) for d in COPIED_DIRS
             for f in sorted((PORT_PKG / d).iterdir())
             if f.suffix in (".py", ".cpp")]
    return found + list(COPIED_FILES)


def departing_lines(original: str, copy: str) -> set:
    """The copy's lines (1-based) that differ from the original; a line
    deleted from the original marks the copy's line where it was."""
    a, b = original.splitlines(), copy.splitlines()
    lines = set()
    for tag, _, _, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            lines.update(range(j1 + 1, max(j2, j1 + 1) + 1))
    return lines


@pytest.mark.parametrize("rel", copies())
def test_copy_equals_its_original_but_the_listed_lines(rel):
    """Each copied host module is its JAX original's text, apart from the
    departures listed for it (so a later edit of a copy, or of an original,
    in code no test program reaches cannot drift unseen)."""
    original = JAX_PKG / rel
    assert original.is_file(), f"{rel} has no original"
    allowed = DEPARTURES.get(rel, [])
    if allowed is None:
        assert "import json5c" not in (PORT_PKG / rel).read_text()
        return
    lines = departing_lines(original.read_text(), (PORT_PKG / rel).read_text())
    outside = sorted(n for n in lines
                     if not any(a <= n <= b for a, b in allowed))
    assert not outside, f"{rel}: unlisted departures at lines {outside}"
    for a, b in allowed:
        assert lines & set(range(a, b + 1)), f"{rel}:{a}-{b} is listed but " \
            "equals the original"
