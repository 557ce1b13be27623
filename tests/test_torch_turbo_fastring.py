"""The ring's vectorized fast park path on the port (the plain step, on the
CPU): a top-level literal-prompt user_input, a drained race whose input
lane is its lane's last task, and a drained race whose one waiting lane is
cancelled, each serviced without ``_service`` and resumed by batched writes
on the device. Each program runs through the host engine, the port with the
fast path, the port with it off (the exact ring) and, where named, the JAX
engine (Pallas in interpret mode, with its own fast path)."""

import io

import numpy as np
import pytest
import torch

import bench
import torch_programs as tp
from torch_helpers import (JAX_TCFG, PORT_TCFG, compile_port, compile_src,
                           fast_ring, prog, run_host, summary)

from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE, PARK_USER_INPUT
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.parallel.mesh import unshard
from interpolation_engine_tpu_torch.vm import turbo as pt

RACE_IO = bench.race_io_program(t_max=3)


def top_level_answers(i):
    return [f"r{i}-a", "same", f"r{i}-c"]


def engine(src, answers=lambda i: [], fast=True, tcfg=PORT_TCFG,
           backend=None, **kw):
    """The port's engine on the CPU (or over ``mesh=``), instance i answered
    from ``answers(i)``; ``fast`` False sends every park the exact way."""
    if "mesh" not in kw:
        kw["device"] = "cpu"
    iom = port.io_manager
    backend = backend or iom.ScriptedBackend
    with fast_ring(fast):
        return pt.TurboEngine(compile_port(src), tcfg, io_factory=lambda i:
                              iom.IOManager(backend(list(answers(i)))), **kw)


def run(eng, n: int):
    """(final batch, results, calls of the exact path's ``_service``)."""
    calls = []
    service = eng._service

    async def counted(*args):
        calls.append(args[2])
        return await service(*args)
    eng._service = counted
    final = eng.run(eng.make_batch(n), max_rounds=500)
    return final, eng.results(final), len(calls)


def fast_and_exact(src, answers, n, **kw):
    fast = engine(src, answers, **kw)
    exact = engine(src, answers, fast=False, **kw)
    return (fast, *run(fast, n)), (exact, *run(exact, n))


def same_batch(a, b) -> None:
    for name, x, y in zip(("regs", "sbuf", "out", "meta"), a, b):
        assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def fast_ring_jax():
    """The JAX engine's one build of FAST_RING (interpret mode), run with
    its fast park path over 5 instances."""
    eng = jax_turbo.TurboEngine(
        compile_src(tp.FAST_RING), JAX_TCFG, interpret=True,
        io_factory=lambda i: IOManager(ScriptedBackend(top_level_answers(i))))
    res = eng.results(eng.run(eng.make_batch(5), max_rounds=500), 5)
    return res, eng.ring_stats["fast_parks"]


def test_fast_ring_top_level_differential(fast_ring_jax, tmp_path, capsys):
    """Per-instance answers (several uniques a round for the dedup): equal
    to the host, to the exact ring and to the JAX engine's fast path, steps
    included, with every park on the fast path."""
    (fast, _, res, calls), (exact, _, eres, ecalls) = fast_and_exact(
        tp.FAST_RING, top_level_answers, 5)
    assert fast.ring_stats["fast_parks"] == 15 and calls == 0
    assert fast.ring_stats["parks"] == exact.ring_stats["parks"] == 15
    assert fast.ring_stats["parks_by_kind"] == \
        exact.ring_stats["parks_by_kind"] == {PARK_USER_INPUT: 15}
    assert exact.ring_stats["fast_parks"] == 0 and ecalls == 15
    for i, r in enumerate(res):
        host = run_host(tp.FAST_RING, tmp_path, top_level_answers(i))
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    assert [summary(r) for r in res] == [summary(r) for r in eres]
    jax_res, jax_fast = fast_ring_jax
    assert jax_fast == 15
    assert [summary(r) for r in res] == [summary(j) for j in jax_res]
    # the backend saw each prompt, as on the exact path
    assert [e["prompt"] for e in fast._ios[0].backend.exchanges] == \
        ["? "] * 3


def test_fast_ring_drain_race_differential(tmp_path, capsys):
    answers = ["go", "north", "quit"]
    host = run_host(tp.DRAIN_RACE, tmp_path, answers)
    capsys.readouterr()
    (fast, _, res, calls), (exact, _, eres, _) = fast_and_exact(
        tp.DRAIN_RACE, lambda i: answers, 4)
    assert fast.ring_stats["fast_parks"] == 12 and calls == 0
    assert not fast._escape_results and not fast._lanering.pending
    assert fast.ring_stats["parks_by_kind"] == \
        exact.ring_stats["parks_by_kind"]
    for r in res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    assert [summary(r) for r in res] == [summary(r) for r in eres]


def test_fast_ring_drain_cancel_differential(tmp_path, capsys):
    """Race 3's empty user_choice every turn (12) and race 1's await_insert
    on turn 1 (4) are cancelled on the device; from turn 2 'won' exists, so
    race 1's lane runs on in the kernel and never parks."""
    host = run_host(tp.DRAIN_CANCEL, tmp_path)
    capsys.readouterr()
    (fast, _, res, calls), (exact, _, eres, _) = fast_and_exact(
        tp.DRAIN_CANCEL, lambda i: [], 4)
    assert fast.ring_stats["fast_parks"] == 16 and calls == 0
    assert not fast._lanering.pending
    assert fast.ring_stats["parks_by_kind"] == \
        exact.ring_stats["parks_by_kind"]
    for r in res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    assert [summary(r) for r in res] == [summary(r) for r in eres]


@pytest.mark.parametrize("src,answers", [
    (RACE_IO, ["cgo"] * 3), (tp.DRAIN_CANCEL, []),
    (tp.DRAIN_RACE, ["go", "north", "quit"])],
    ids=["race_io", "drain_cancel", "drain_race"])
def test_every_register_equal_at_done_fast_and_exact(src, answers):
    """The fast resumes leave each row as the exact ring and the kernel
    leave it: every register column (steps, lane pcs and states, epochs),
    every byte row, the output and the list planes, bit for bit."""
    (fast, final, _, calls), (exact, efinal, _, _) = fast_and_exact(
        src, lambda i: answers, 5)
    assert fast.ring_stats["fast_parks"] > 0 and calls == 0
    assert bool((final.regs[:, pt.C_STATUS] == DONE).all())
    same_batch(final, efinal)


class AsyncOnly(port.io_manager.BufferBackend):
    """Answers from a list, but only through the coroutine: not sync."""

    def __init__(self, answers):
        super().__init__()
        self.answers = answers

    async def user_input(self, prompt, default=""):
        return self.answers.pop(0)


class SyncCoroutine(AsyncOnly):
    """Declares ``sync_io``: its coroutine answers within its first slice."""
    sync_io = True


def test_sync_io_backend_is_driven_one_slice():
    """A backend that declares ``sync_io`` without ``user_input_sync`` is
    called through its coroutine, driven one slice (``_drive_sync``)."""
    eng = engine(tp.FAST_RING, top_level_answers, backend=SyncCoroutine)
    _, res, calls = run(eng, 3)
    assert eng.ring_stats["fast_parks"] == 9 and calls == 0
    exact = engine(tp.FAST_RING, top_level_answers, fast=False)
    assert [summary(r) for r in res] == \
        [summary(r) for r in run(exact, 3)[1]]


PROMPTED = tp.FAST_RING.replace("inserts: {i: 0, acc: 0}",
                                "inserts: {i: 0, acc: 0, who: 'w'}")


@pytest.mark.parametrize("case", ["log", "events", "pending_lane_io",
                                  "no_sync_backend", "interpolated_prompt",
                                  "escaped_prompt"])
def test_demotions_take_the_exact_path(case, monkeypatch):
    """What the fast path must not take goes the exact way, with the same
    result: a log or event sink (they want the exact path's records), lane
    IO pending for the instance, a backend that does not answer at once,
    and a prompt that is not a literal."""
    src, kw = tp.FAST_RING, {}
    if case == "log":
        monkeypatch.setattr(port.context.CTX, "log_sink", io.StringIO())
    elif case == "events":
        monkeypatch.setattr(port.events.EVENTS, "json_sink", io.StringIO())
    elif case == "no_sync_backend":
        kw["backend"] = AsyncOnly
    elif case == "interpolated_prompt":
        src = PROMPTED.replace("prompt:'? '", "prompt:'{who}? '")
    elif case == "escaped_prompt":
        src = PROMPTED.replace("prompt:'? '", "prompt:'a\\\\{b\\\\}? '")
    eng = engine(src, top_level_answers, **kw)
    if case == "pending_lane_io":
        for gid in (0, 1):
            eng._lanering.pending[gid] = {"epoch": 0, "tasks": {},
                                          "errors": {}, "failed": set()}
    _, res, calls = run(eng, 2)
    assert eng.ring_stats["fast_parks"] == 0 and calls == 6
    exact = engine(src, top_level_answers, fast=False, **kw)
    assert [summary(r) for r in res] == \
        [summary(r) for r in run(exact, 2)[1]]


def test_interpolated_output_name_never_reaches_the_fast_path():
    """The planner rejects a user_input whose output name is not a literal,
    so such a park is never a turbo park at all."""
    src = prog("{key: 'ans'}",
               "{cmd:'user_input', prompt:'? ', output_name:'{key}'}")
    with pytest.raises(port.planner.NotTurbo, match="output_name"):
        port.planner.plan_turbo(compile_port(src))


def test_more_than_256_distinct_responses_in_one_round(tmp_path, capsys):
    """260 instances with 260 distinct answers at one site: the dedup index
    needs more than a byte (the int32 branch)."""
    n = 260
    eng = engine(tp.USER_INPUT, lambda i: [f"n{i}"])
    seen = []
    resume = eng._fast_resume

    def recorded(batch, out_slot, drain, uniq, mi=None):
        seen.append((uniq.shape[0], None if mi is None else mi.dtype))
        return resume(batch, out_slot, drain, uniq, mi)
    eng._fast_resume = recorded
    _, res, calls = run(eng, n)
    assert seen == [(n, np.int32)] and calls == 0
    assert eng.ring_stats["fast_parks"] == n
    host = run_host(tp.USER_INPUT, tmp_path, ["n7"])
    capsys.readouterr()
    assert (res[7].output, res[7].inserts) == (host["output"],
                                               dict(host["inserts"]))
    assert [r.output for r in res] == [f"hi hello n{i}!" for i in range(n)]


def test_fast_ring_on_a_mesh_equals_one_device():
    """race-io over four CPU shards: each shard resumed with its own slice
    of the mask, bit for bit the engine on one device."""
    one = engine(RACE_IO, lambda i: ["cgo"] * 3)
    ref, _, _ = run(one, 10)
    four = engine(RACE_IO, lambda i: ["cgo"] * 3, mesh=["cpu"] * 4)
    final, res, calls = run(four, 10)
    assert four.ring_stats["fast_parks"] == 30 and calls == 0
    same_batch(unshard(final), ref)
    assert all(r.status == DONE and r.steps == 47 for r in res)


def test_fast_ring_pipelined_shard_engines_equal_one_engine():
    import asyncio
    n, tcfg = 8, pt.TurboConfig(width=64, out_width=128, k_steps=16)
    single = engine(RACE_IO, lambda i: ["cgo"] * 3, tcfg=tcfg)
    ref, _, _ = run(single, n)
    iom = port.io_manager
    engines = pt.make_shard_engines(
        compile_port(RACE_IO), tcfg, 2, device="cpu",
        io_factory=lambda i: iom.IOManager(iom.ScriptedBackend(["cgo"] * 3)))
    pt.assign_shard_ids(engines, n // 2)
    finals = asyncio.run(pt.run_pipelined(
        [(e, e.make_batch(n // 2)) for e in engines]))
    for f in range(4):
        axis = 1 if f in (1, 3) else 0
        assert torch.equal(torch.cat([b[f] for b in finals], dim=axis),
                           ref[f])
    assert sum(e.ring_stats["fast_parks"] for e in engines) == 3 * n


SPILLED_INPUT = prog(
    "{i: 0}", "{cmd:'label', name:'@loop'}",
    "{cmd:'math', input:'{i} + 1', output_name:'i'}",
    "{cmd:'print', text:'line {i} of text;'}",
    "{cmd:'goto_map', text:'{i}', target_maps:[{'6': '@ask'}, "
    "{'*': '@loop'}]}", "{cmd:'label', name:'@ask'}",
    "{cmd:'user_input', prompt:'? ', output_name:'a'}",
    "{cmd:'print', text:'a={a};'}", "%(clear)s",
    "{cmd:'print', text:'fin {a}'}")
AWAIT_AFTER_INPUT = prog(
    "{}", "{cmd:'user_input', prompt:'? ', output_name:'won'}",
    "{cmd:'parallel_race', tasks:["
    "{cmd:'serial', tasks:[{cmd:'await_insert', name:'won'}, "
    "{cmd:'print', text:'W={won};'}]}, "
    "{cmd:'serial', tasks:[{cmd:'print', text:'B;'}]}]}",
    "{cmd:'print', text:'end'}")


@pytest.mark.parametrize("src", [
    SPILLED_INPUT % {"clear": "{cmd:'print', text:'-'}"},
    SPILLED_INPUT % {"clear": "{cmd:'clear'}"}, AWAIT_AFTER_INPUT],
    ids=["output_spill", "spill_then_clear", "await_ready"])
def test_fast_resume_keeps_the_spill_and_await_readiness(src, tmp_path,
                                                         capsys):
    """The resume writes the out slot's string, type and length only: an
    output spilled to the host before the park (tagged with the clear
    epoch, which a later clear on the device voids) survives it, and an
    await_insert of the answered key is ready in the kernel at once."""
    tiny = pt.TurboConfig(tile=8, width=64, out_width=24, k_steps=16)
    (fast, _, res, calls), (_, _, eres, _) = fast_and_exact(
        src, lambda i: ["yes"], 3, tcfg=tiny)
    # the prints that outgrow the 24-byte buffer park the exact way
    assert fast.ring_stats["fast_parks"] == 3
    assert calls == fast.ring_stats["parks"] - 3
    host = run_host(src, tmp_path, ["yes"])
    capsys.readouterr()
    for r in res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    assert [summary(r) for r in res] == [summary(r) for r in eres]
