"""Promotion on the port (the plain step, on the CPU): an instance whose
value outgrows its slot moves, mid-run, into one sibling batch 4x wider,
run concurrently with its batch, and finishes there equal to the host, the
port's exact ring and, where named, the JAX engine (interpret mode). What
even the sibling cannot hold escapes to one batch of the general engine
(``tests/test_torch_turbo_escapes.py`` holds escapes to the JAX engine)."""

import asyncio

import pytest
import torch

import bench

import torch_programs as tp
from torch_helpers import (compile_port, compile_src, fast_ring, run_host,
                           summary)

from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import driver
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


# the bench's width-512 cell (BENCH_WIDTH=512 BENCH_ELEM=128 BENCH_OUT=512)
BENCH_512 = dict(width=512, elem_width=128, out_width=512, list_cap=12)


def card_limits(monkeypatch):
    """An H100's limits on the CPU: the kernel's widest slot and a block's
    shared memory (the card's own figures come from the card)."""
    monkeypatch.setattr(pt, "step_max_width", lambda device: ts.MAX_WIDTH)
    monkeypatch.setattr(pt, "shared_memory", lambda device: ts.H100_SHARED)


BENCH_PROGRAMS = {"many_rows": tp.many_rows_program,
                  "adventure": bench.adventure_program,
                  "race_io": bench.race_io_program,
                  "spine": lambda: bench.BENCH_PROGRAM,
                  "ring": lambda: bench.RING_PROGRAM}


def bench_engine(name, device="cpu"):
    """The program ``name`` at the bench's width-512 cell, built on the
    CPU and then typed as ``device``'s (nothing launches)."""
    eng = pt.TurboEngine(compile_port(BENCH_PROGRAMS[name]()),
                         pt.TurboConfig(**BENCH_512), device="cpu")
    eng.device = torch.device(device)
    return eng


@pytest.mark.parametrize("name", ["many_rows", "adventure", "race_io"])
def test_sibling_past_a_blocks_shared_memory_is_refused_on_a_card(
        name, monkeypatch):
    """At the bench's width-512 cell a program of 151 byte rows plans one
    instance a block; its 2048-wide sibling would need more shared memory
    than an H100 block has, so on a card there is none (its instances
    escape), where the bench's adventure and race-io (7 rows) keep theirs.
    The engines are built on the CPU, the second then typed as a card's:
    nothing launches."""
    card_limits(monkeypatch)
    cpu = bench_engine(name)
    assert cpu._wide_tcfg().width == 2048   # the CPU's step has no limit
    batch = cpu.make_batch(1)
    assert ts.fits_one_instance(
        ts.TileShape.of(cpu.tables, [t.shape for t in batch]),
        ts.H100_SHARED)
    card = bench_engine(name, "cuda")
    wide = card._wide_tcfg()
    if name == "many_rows":
        assert card.cols.n_rows == 151 and wide is None
        assert ts.tile_plan(cpu.tables, batch).tile == 1
    else:
        assert card.cols.n_rows == 7
        assert (wide.width, wide.out_width, wide.elem_width) == \
            (2048, 2048, 512)


@pytest.mark.parametrize("name", sorted(BENCH_PROGRAMS))
def test_the_fit_check_sees_the_tile_plans_shape(name):
    """``step_fits`` takes its batch shapes from ``batch_shapes``, the tile
    plan from the batch ``make_batch`` builds: the two TileShapes agree."""
    eng = bench_engine(name)
    for n in (1, 3):
        assert ts.TileShape.of(
            eng.tables, pt.batch_shapes(eng.cols, eng.tcfg, 1)) == \
            ts.TileShape.of(eng.tables, [t.shape for t in eng.make_batch(n)])


def test_the_sibling_is_decided_and_built_once(monkeypatch):
    """Two runs of one engine (whose instances keep their IO managers,
    so each holds both runs' answers), each promoting: the sibling's host
    tables are built once, for the fit check, and uploaded once."""
    answers = {0: ["s1", "x2", "x3"] * 2, 1: [BIG, "x2", "x3"] * 2}
    eng = engine(tp.PROMOTE_MID_RUN, lambda i: answers[i % 2])
    built = []
    plan_tables = pt._plan_tables
    monkeypatch.setattr(pt, "_plan_tables",
                        lambda *a: built.append(a[2]) or plan_tables(*a))
    tables = []
    for _ in range(2):
        results(eng, 4)
        assert sorted(eng._escape_results) == [1, 3]
        tables.append(eng._wide_tables)
    assert [c.width for c in built] == [4 * WIDE["width"]]
    assert tables[0] is tables[1] is not None


def test_base_engine_past_a_blocks_shared_memory_runs_on_the_general_engine(
        monkeypatch, tmp_path):
    """20 strings and 20 lists of 24 elements at 2048 as the base config
    (141 byte rows): on a card the turbo engine refuses it with NotTurbo
    before it uploads anything, and run_program_on_device sends it to the
    general engine on that card, as it does a program the planner
    rejects."""
    card_limits(monkeypatch)
    src = tp.many_rows_program(20)
    wide = pt.TurboConfig(width=2048, elem_width=512, out_width=2048,
                          list_cap=24)
    with pytest.raises(pt.NotTurbo, match="shared memory"):
        pt.TurboEngine(compile_port(src), wide, device="cuda")

    class Routed(Exception):
        pass

    def general_engine(compiled, io_factory, device):
        raise Routed(str(device))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(driver, "DeviceRunner", general_engine)
    path = tmp_path / "prog.json5"
    path.write_text(src)
    iom = port.io_manager
    with pytest.raises(Routed, match="^cuda$"):
        driver.run_program_on_device(
            str(path), [], iom.IOManager(iom.BufferBackend()), batch=4,
            tcfg=wide, device="cuda")
