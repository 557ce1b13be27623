"""Escapes: instances whose state outgrows even the promotion sibling (a
value too wide, a list past ``list_cap``, or every overflow with promotion
off) finish in one batch of the general engine that shares the turbo
engine's LaneRing. Held against the JAX TurboEngine (Pallas in interpret
mode, its escapes on its eager general engine) and the host engine,
instance for instance."""

import asyncio

import numpy as np
import pytest

import torch_programs as tp
from torch_helpers import (JAX_TCFG, PORT_TCFG, compile_port, compile_src,
                           fast_ring, port_engine, prog, run_host, scripted,
                           summary)

from interpolation_engine_tpu.io.manager import BufferBackend, IOManager
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.vm import driver
from interpolation_engine_tpu_torch.vm import turbo as pt

# the JAX package's tests/test_turbo.py:1416, a value past the 4x sibling
MONSTER = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'user_input', prompt:'say? ', output_name:'big'},
        {cmd:'set', item:'k', output_name:'t'},
        {cmd:'print', text:'done {t};'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# the escaped instance's random_choice draws from the JAX LCG seeded with
# its row in the turbo batch
ESCAPE_CHOICE = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'user_input', prompt:'? ', output_name:'big'},
        {cmd:'random_choice', list:['a', 'b', 'c', 'd', 'e'],
         output_name:'r'},
        {cmd:'print', text:'r={r}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

WIDE = dict(tile=8, width=192, out_width=192, k_steps=24)


def run_both(src, answers, n, *, fast=True, port_kw=None, jax_kw=None):
    """The port's engine and the JAX engine on the same program and
    answers: (port engine, port results, JAX engine, JAX results)."""
    port_kw, jax_kw = port_kw or {}, jax_kw or {}
    iom = port.io_manager
    with fast_ring(fast):
        eng = pt.TurboEngine(compile_port(src), PORT_TCFG, device="cpu",
                             io_factory=lambda i: iom.IOManager(
                                 iom.ScriptedBackend(list(answers(i)))),
                             **port_kw)
    res = eng.results(eng.run(eng.make_batch(n), max_rounds=500), n)
    jeng = jax_turbo.TurboEngine(
        compile_src(src), JAX_TCFG, io_factory=lambda i: scripted(answers(i))(i),
        interpret=True, **jax_kw)
    jres = jeng.results(jeng.run(jeng.make_batch(n), max_rounds=500), n)
    return eng, res, jeng, jres


def assert_host(src, res, answers, tmp_path, capsys) -> None:
    for i, r in enumerate(res):
        host = run_host(src, tmp_path, answers(i))
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_monster_value_escapes_to_one_general_batch(fast, tmp_path, capsys):
    """600 bytes outgrow the 64-byte slot and the 256-byte sibling: both
    instances finish in ONE general-engine batch, equal to JAX and the
    host."""
    answers = lambda i: ["Z" * 600]   # noqa: E731
    eng, res, jeng, jres = run_both(MONSTER, answers, 2, fast=fast)
    assert sorted(eng._escape_results) == sorted(jeng._escape_results) == \
        [0, 1]
    [runner] = eng.escape_runners
    assert runner.instance_ids == [0, 1] and runner.cfg.max_str == 2048
    assert [summary(r) for r in res] == [summary(j) for j in jres]
    assert_host(MONSTER, res, answers, tmp_path, capsys)


def test_promotion_off_escapes_at_once(tmp_path, capsys):
    """promote_factor=0: a 100-byte answer outgrows the 64-byte slot and
    goes straight to the general engine, no sibling built."""
    answers = lambda i: ["p" * 100]   # noqa: E731
    eng, res, jeng, jres = run_both(tp.WIDE_VALUE, answers, 2,
                                    port_kw={"promote_factor": 0},
                                    jax_kw={"promote_factor": 0})
    assert eng._wide_tables is None
    assert sorted(eng._escape_results) == [0, 1]
    assert eng.ring_stats["escapes"] == 2
    assert [summary(r) for r in res] == [summary(j) for j in jres]
    assert_host(tp.WIDE_VALUE, res, answers, tmp_path, capsys)


def test_list_past_list_cap_escapes(tmp_path, capsys):
    """A 13th element outgrows list_cap (12) in the sibling too: the
    instance escapes, and the general engine joins the 13 elements."""
    src = prog("{l: %s}" % [f"e{k}" for k in range(12)],
               "{cmd:'list_append', list:'{l}', item:'q', output_name:'l'}",
               "{cmd:'list_join', list:'{l}', before:'<', between:',', "
               "after:'>', output_name:'j'}",
               "{cmd:'print', text:'{j}'}")
    answers = lambda i: []   # noqa: E731
    eng, res, jeng, jres = run_both(src, answers, 2)
    assert sorted(eng._escape_results) == [0, 1]
    assert res[0].output.endswith("e11,q>")
    assert [summary(r) for r in res] == [summary(j) for j in jres]
    assert_host(src, res, answers, tmp_path, capsys)


def slow_prompt(base):
    """A backend class over ``base`` (either package's BufferBackend) that
    answers user_input by prompt; the ``slow`` prompt's answer comes after
    a real wait, so its lane IO is still pending rounds later."""
    class SlowPrompt(base):
        def __init__(self, answers: dict, slow: str, wait: float = 0.3):
            super().__init__()
            self.answers, self.slow, self.wait = answers, slow, wait
            self.calls: list = []

        async def user_input(self, prompt, default=""):
            self.calls.append(prompt)
            if prompt == self.slow:
                await asyncio.sleep(self.wait)
            return self.answers[prompt]
    return SlowPrompt


def test_escape_inside_a_block_keeps_its_pending_lane_io(tmp_path, capsys):
    """A parallel_wait whose fast lane answers 3,000 bytes (past the
    768-byte sibling) while the other lane's IO is still pending: the
    instance escapes with its block open, under its global id (1) at row 0
    of the general engine, whose lane servicing finds the pending IO in
    the shared LaneRing. The slow prompt is asked once per instance, no IO
    is left pending, and every instance equals JAX and the host."""
    answers = {0: {"slow? ": "s0", "big? ": "b"},
               1: {"slow? ": "s1", "big? ": "B" * 3000}}
    port_cls = slow_prompt(port.io_manager.BufferBackend)
    jax_cls = slow_prompt(BufferBackend)
    backends = {}

    def io_factory(i):
        backends[i] = port_cls(answers[i], "slow? ")
        return port.io_manager.IOManager(backends[i])
    eng = pt.TurboEngine(compile_port(tp.PROMOTE_PENDING),
                         pt.TurboConfig(**WIDE), io_factory=io_factory,
                         device="cpu")
    res = eng.results(eng.run(eng.make_batch(2), max_rounds=500))
    assert sorted(eng._escape_results) == [1]
    [runner] = eng.escape_runners
    assert runner.instance_ids == [1]
    assert not eng._lanering.pending
    assert [backends[i].calls.count("slow? ") for i in (0, 1)] == [1, 1]
    jeng = jax_turbo.TurboEngine(
        compile_src(tp.PROMOTE_PENDING), jax_turbo.TurboConfig(**WIDE),
        io_factory=lambda i: IOManager(jax_cls(answers[i], "slow? ")),
        interpret=True)
    jres = jeng.results(jeng.run(jeng.make_batch(2), max_rounds=500), 2)
    assert [summary(r) for r in res] == [summary(j) for j in jres]
    for i, r in enumerate(res):
        path = tmp_path / "prog.json5"
        path.write_text(tp.PROMOTE_PENDING)
        host = asyncio.run(port.runtime.async_main(
            str(path), [], port.io_manager.IOManager(
                port_cls(answers[i], "slow? "))))
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_escaped_random_choice_draws_with_the_row_as_seed(tmp_path, capsys):
    """An escaped instance's rng is its row in the turbo batch (the JAX
    package's ``rng=i``): row i draws l[(lcg(i) >> 8) % 5]."""
    answers = lambda i: ["Z" * 600]   # noqa: E731
    eng, res, jeng, jres = run_both(ESCAPE_CHOICE, answers, 3)
    assert sorted(eng._escape_results) == [0, 1, 2]
    assert [summary(r) for r in res] == [summary(j) for j in jres]
    from interpolation_engine_tpu.core import executor
    old = executor.random.choice
    for i, r in enumerate(res):
        with np.errstate(over="ignore"):
            rng = int(np.uint32(i) * np.uint32(1664525)
                      + np.uint32(1013904223))
        pick = (rng >> 8) % 5
        assert r.inserts["r"] == "abcde"[pick]
        executor.random.choice = lambda seq, k=pick: seq[k]
        try:
            host = run_host(ESCAPE_CHOICE, tmp_path, answers(i))
        finally:
            executor.random.choice = old
        capsys.readouterr()
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_escape_from_the_mesh_engine_equals_one_device(tmp_path, capsys):
    """Four shards on ["cpu"] * 4: the escapes of every shard finish in one
    general-engine batch on the mesh's first device, equal to the one-
    device engine's and to the host."""
    answers = ["x" * 500]
    one = port_engine(tp.USER_INPUT, responses=answers)
    want = [summary(r) for r in one.results(one.run(one.make_batch(8)))]
    four = port_engine(tp.USER_INPUT, responses=answers, mesh=["cpu"] * 4)
    res = four.results(four.run(four.make_batch(8)))
    assert sorted(four._escape_results) == list(range(8))
    [runner] = four.escape_runners
    assert runner.instance_ids == list(range(8))
    assert [summary(r) for r in res] == want
    assert_host(tp.USER_INPUT, res, lambda i: answers, tmp_path, capsys)


def test_runner_sweeps_and_cancels_only_the_ids_it_owns():
    """A DeviceRunner over global ids 5 and 6 on a shared LaneRing: the
    pending IO of id 5 (a finished block: its epoch moved on) is cancelled;
    that of id 0, another engine's, is neither swept nor cancelled at the
    end of the run."""
    compiled = compile_port(tp.PAR_RACE % {"mode": "race"})
    ring = port.lanering.LaneRing(compiled)
    runner = driver.DeviceRunner(compiled, port.vm_config.VMConfig(),
                                 device="cpu", lanering=ring,
                                 instance_ids=[5, 6])

    async def go():
        mine = asyncio.ensure_future(asyncio.sleep(60))
        theirs = asyncio.ensure_future(asyncio.sleep(60))
        for gid, task in ((5, mine), (0, theirs)):
            ring.pending[gid] = {"epoch": 7, "tasks": {1: task},
                                 "errors": {}, "failed": set()}
        final = await runner.run_async(runner.make_instances(2))
        alive = not theirs.done()
        theirs.cancel()
        return final, mine, alive

    final, mine, alive = asyncio.run(go())
    assert mine.cancelled() and alive
    assert list(ring.pending) == [0]
    assert all(r.status == DONE for r in runner.results(final))
    assert (runner._gid(1), runner._row_of(6, 2), runner._row_of(0, 2)) == \
        (6, 1, None)


def test_race_io_escape_equals_the_jax_exact_ring(tmp_path, capsys):
    """chip_smoke's phase-15 shape at the test size: instance 0 answers 300
    bytes at turn 1 (past the 256-byte sibling) and plays its last two
    turns on the general engine, its lanes through the shared LaneRing.
    Through the port's fast path and its exact ring, every instance equals
    the JAX exact ring's (the JAX fast path counts a drained race one step
    short; ROADMAP Queue 3) and the host."""
    import bench
    src = bench.race_io_program(t_max=3)
    said = {True: ["c" + "L" * 299, "cgo", "cgo"], False: ["cgo"] * 3}
    answers = lambda i: said[i == 0]   # noqa: E731
    with fast_ring(False):
        jeng = jax_turbo.TurboEngine(
            compile_src(src), JAX_TCFG,
            io_factory=lambda i: scripted(answers(i))(i), interpret=True)
    jres = jeng.results(jeng.run(jeng.make_batch(3), max_rounds=500), 3)
    for fast in (True, False):
        with fast_ring(fast):
            eng = pt.TurboEngine(compile_port(src), PORT_TCFG, device="cpu",
                                 io_factory=lambda i: port.io_manager
                                 .IOManager(port.io_manager.ScriptedBackend(
                                     list(answers(i)))))
        res = eng.results(eng.run(eng.make_batch(3), max_rounds=500), 3)
        assert sorted(eng._escape_results) == [0]
        assert [summary(r) for r in res] == [summary(j) for j in jres]
    assert_host(src, res, answers, tmp_path, capsys)
