"""Promotion on the port (the plain step, on the CPU): an instance whose
value outgrows its slot moves, mid-run, into one sibling batch 4x wider,
run concurrently with its batch, and finishes there equal to the host, the
port's exact ring and, where named, the JAX engine (interpret mode). What
even the sibling cannot hold escapes to one batch of the general engine
(``tests/test_torch_turbo_escapes.py`` holds escapes to the JAX engine)."""

import asyncio

import pytest

import torch_programs as tp
from torch_helpers import (compile_port, compile_src, fast_ring, run_host,
                           summary)

from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.vm import turbo as pt

SIZES = dict(tile=8, width=64, out_width=192, k_steps=24)
# the JAX promotion tests' shape: width 192, a 768-byte sibling
WIDE = dict(SIZES, width=192)
BIG = "B" * 600


def engine(src, answers, fast=True, sizes=WIDE, **kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    iom = port.io_manager
    with fast_ring(fast):
        return pt.TurboEngine(compile_port(src), pt.TurboConfig(**sizes),
                              io_factory=lambda i: iom.IOManager(
                                  iom.ScriptedBackend(list(answers(i)))),
                              **kw)


def results(eng, n):
    return eng.results(eng.run(eng.make_batch(n), max_rounds=500))


def agree(src, answers, n, tmp_path, capsys, sizes=WIDE) -> list:
    """Fast and exact port runs equal each other (steps included) and every
    instance the host; returns the fast engine and its results."""
    fast = engine(src, answers, sizes=sizes)
    res = results(fast, n)
    exact = engine(src, answers, fast=False, sizes=sizes)
    assert [summary(r) for r in res] == \
        [summary(r) for r in results(exact, n)]
    assert sorted(fast._escape_results) == sorted(exact._escape_results)
    for i, r in enumerate(res):
        host = run_host(src, tmp_path, answers(i))
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
    return fast, res


@pytest.fixture(scope="module")
def wide_value_jax():
    eng = jax_turbo.TurboEngine(
        compile_src(tp.WIDE_VALUE), jax_turbo.TurboConfig(**WIDE),
        io_factory=lambda i: IOManager(ScriptedBackend([BIG])),
        interpret=True)
    return eng.results(eng.run(eng.make_batch(3), max_rounds=300), 3)


def test_wide_value_promotes_to_wider_sibling(wide_value_jax, tmp_path,
                                              capsys):
    """600 bytes outgrow the 192-byte slot and fit the 768-byte sibling."""
    eng, res = agree(tp.WIDE_VALUE, lambda i: [BIG], 3, tmp_path, capsys)
    assert sorted(eng._escape_results) == [0, 1, 2]
    assert eng.ring_stats["escapes"] == 3
    assert [summary(r) for r in res] == [summary(j) for j in wide_value_jax]


def test_fast_ring_overflow_promotes(tmp_path, capsys):
    """The fast path consumed the answer already: the store is done on the
    host and the instance promoted, with no exact service."""
    eng, _ = agree(tp.FAST_OVERFLOW, lambda i: ["Y" * 600], 3, tmp_path,
                   capsys)
    assert sorted(eng._escape_results) == [0, 1, 2]
    assert eng.ring_stats["fast_parks"] == 3


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_promotion_flushes_concurrently_mid_run(fast, tmp_path, capsys,
                                                monkeypatch):
    """Instances 1 and 3 outgrow their slot at turn 1 and answer turns 2-3
    in the sibling, flushed as a task inside the run loop (the end-of-run
    flush finds an empty queue), with the IO managers that answered turn 1
    (a fresh backend would replay turn 1's answer)."""
    answers = {0: ["s1", "x2", "x3"], 1: [BIG, "x2", "x3"]}
    calls = []
    flush = pt.TurboEngine._flush_promotions

    async def recording(self):
        calls.append((bool(self._promote_states),
                      asyncio.current_task() in self._promo_tasks))
        return await flush(self)
    monkeypatch.setattr(pt.TurboEngine, "_flush_promotions", recording)
    eng = engine(tp.PROMOTE_MID_RUN, lambda i: answers[i % 2], fast)
    res = results(eng, 4)
    assert any(nonempty and in_loop for nonempty, in_loop in calls), calls
    assert not eng._escape_states
    assert sorted(eng._escape_results) == [1, 3]
    for i, r in enumerate(res):
        host = run_host(tp.PROMOTE_MID_RUN, tmp_path, answers[i % 2])
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


@pytest.mark.parametrize("src,answers", [
    (tp.PROMOTE_IN_BLOCK, ["P" * 100]),
    (tp.DRAIN_RACE, ["go", "P" * 100, "quit"])],
    ids=["wait_block_exact", "drained_race_fast"])
def test_promotion_from_inside_a_parallel_block(src, answers, tmp_path,
                                                capsys):
    """The par record: the block goes on in the sibling where it stopped.
    In a parallel_wait the exact ring promotes with the input lane READY
    mid-lane; in a drained race the fast path promotes with it READY at its
    thread end, as the exact ring would."""
    eng, _ = agree(src, lambda i: answers, 2, tmp_path, capsys,
                   sizes=SIZES)
    assert sorted(eng._escape_results) == [0, 1]


def test_promotion_on_a_mesh_equals_one_device(tmp_path, capsys):
    answers = {0: ["s1", "x2", "x3"], 1: [BIG, "x2", "x3"]}
    one = engine(tp.PROMOTE_MID_RUN, lambda i: answers[i % 2])
    four = engine(tp.PROMOTE_MID_RUN, lambda i: answers[i % 2],
                  mesh=["cpu"] * 4)
    res = results(four, 8)
    assert sorted(four._escape_results) == [1, 3, 5, 7]
    assert [summary(r) for r in res] == [summary(r) for r in results(one, 8)]


def test_promotion_under_shard_engines_equals_one_engine():
    """Two pipelined shard engines over disjoint ids: each promotes its own
    rows into its own sibling, with the IO of their global instances."""
    answers = {0: ["s1", "x2", "x3"], 1: [BIG, "x2", "x3"]}
    n = 8
    one = engine(tp.PROMOTE_MID_RUN, lambda i: answers[i % 2])
    want = [summary(r) for r in results(one, n)]
    iom = port.io_manager
    engines = pt.make_shard_engines(
        compile_port(tp.PROMOTE_MID_RUN), pt.TurboConfig(**WIDE), 2,
        device="cpu", io_factory=lambda i: iom.IOManager(
            iom.ScriptedBackend(list(answers[i % 2]))))
    pt.assign_shard_ids(engines, n // 2)
    finals = asyncio.run(pt.run_pipelined(
        [(e, e.make_batch(n // 2)) for e in engines]))
    got = [summary(r) for e, b in zip(engines, finals) for r in e.results(b)]
    assert got == want
    assert [sorted(e._escape_results) for e in engines] == [[1, 3], [1, 3]]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_value_too_wide_for_the_sibling_raises_the_escape(fast, tmp_path,
                                                          capsys):
    """3,000 bytes outgrow the 768-byte sibling too: the instances escape,
    at the end of the run, to one batch of the general engine, whose
    strings hold twice the widest value (8,192 bytes), and finish there
    equal to the host, through either park path."""
    eng, _ = agree(tp.FAST_OVERFLOW, lambda i: ["Z" * 3000], 2, tmp_path,
                   capsys)
    assert sorted(eng._escape_results) == [0, 1]
    [runner] = eng.escape_runners
    assert runner.instance_ids == [0, 1] and runner.cfg.max_str == 8192


class SlowPrompt(port.io_manager.BufferBackend):
    """Answers user_input from ``answers`` by prompt, through the coroutine
    only; the ``slow`` prompt's answer comes after a real wait, so its lane
    IO is still pending rounds later."""

    def __init__(self, answers: dict, slow: str, wait: float = 0.3):
        super().__init__()
        self.answers, self.slow, self.wait = answers, slow, wait
        self.calls: list = []

    async def user_input(self, prompt, default=""):
        self.calls.append(prompt)
        if prompt == self.slow:
            await asyncio.sleep(self.wait)
        return self.answers[prompt]


def test_promotion_keeps_the_other_lanes_pending_io(tmp_path, capsys):
    """A parallel_wait whose fast lane's answer outgrows its slot while the
    other lane's IO is still pending: the row leaves its batch (DONE
    there) with the pending IO, which the sibling now owns, so the
    parent's sweep of finished blocks must not cancel it. The slow prompt
    is asked once per instance, and every instance equals the host."""
    answers = {0: {"slow? ": "s0", "big? ": BIG},
               1: {"slow? ": "s1", "big? ": "b"}}
    iom = port.io_manager
    backends = {}

    def io_factory(i):
        backends[i] = SlowPrompt(answers[i % 2], "slow? ")
        return iom.IOManager(backends[i])
    eng = pt.TurboEngine(compile_port(tp.PROMOTE_PENDING),
                         pt.TurboConfig(**WIDE), io_factory=io_factory,
                         device="cpu")
    res = results(eng, 2)
    assert sorted(eng._escape_results) == [0]
    assert not eng._lanering.pending
    for i, r in enumerate(res):
        assert backends[i].calls.count("slow? ") == 1
        host_io = SlowPrompt(answers[i % 2], "slow? ")
        path = tmp_path / "prog.json5"
        path.write_text(tp.PROMOTE_PENDING)
        host = asyncio.run(port.runtime.async_main(
            str(path), [], iom.IOManager(host_io)))
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_sibling_past_the_kernel_width_escapes(monkeypatch, tmp_path,
                                               capsys):
    """A sibling wider than the step takes on the engine's device (on a
    card, the kernel's 2048 bytes) is never built: its instances escape to
    the general engine, not into the kernel's ValueError from inside the
    sibling, and finish equal to the host. On the CPU the plain version
    has no limit, so the test lowers it to 512 under the 768-byte
    sibling."""
    monkeypatch.setattr(pt, "step_max_width", lambda device: 512)
    eng, _ = agree(tp.WIDE_VALUE, lambda i: [BIG], 2, tmp_path, capsys)
    assert sorted(eng._escape_results) == [0, 1]
    assert [r.instance_ids for r in eng.escape_runners] == [[0, 1]]
