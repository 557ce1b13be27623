"""The CUDA step kernel against its plain PyTorch version on the card: bit
for bit (regs, sbuf, out and meta) after every launch. Runs where
``torch.cuda.is_available()``;
skips elsewhere (``python -m pytest tests/test_torch_kernel_cuda.py`` on the
card, or ``python3 chip_smoke.py``, which covers the same at full size)."""

import random

import pytest
import torch

import bench
import torch_chat as tc
import torch_programs as tp

from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops.turbo_step import (
    turbo_step, turbo_step_reference)
from interpolation_engine_tpu_torch.vm.turbo import TurboConfig, TurboEngine

pytestmark = pytest.mark.cuda

PROGRAMS = dict(tp.AGREEING, **tp.LIST_AGREEING, spine=bench.BENCH_PROGRAM,
                interp=bench.INTERP_PROGRAM,
                ring=bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'"),
                overflow=tp.INT32_OVERFLOW, inexact=tp.INEXACT_DIV,
                await_not_ready=tp.AWAIT_NOT_READY,
                adventure=bench.adventure_program(),
                race_io=bench.race_io_program(),
                midblock_wait=tp.MIDBLOCK_PARK % {"mode": "wait"},
                midblock_race=tp.MIDBLOCK_PARK % {"mode": "race"},
                parked_freeze_par=tp.PARKED_FREEZE_PAR,
                spill_parallel=tp.SPILL_PARALLEL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def compile_src(src):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader)
    return compile_program(json5.loads(loader.add_line_numbers(src)))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_equals_plain_after_every_launch(name, cuda):
    eng = TurboEngine(compile_src(PROGRAMS[name]),
                      TurboConfig(width=128, out_width=192, k_steps=8),
                      device=cuda)
    batch = eng.make_batch(300)
    for key in ("i", "turn"):   # lanes leave their loops at other rounds
        slot = eng.plan.slot_of.get(key)
        if slot is not None:
            gen = torch.Generator().manual_seed(0)
            batch.regs[:, eng.cols.sint(slot)] = torch.randint(
                0, 40, (300,), generator=gen, dtype=torch.int32).to(cuda)
    kern = type(batch)(*(t.clone() for t in batch))
    for _ in range(6):
        turbo_step(eng.tables, kern, 8)
        turbo_step_reference(eng.tables, batch, 8)
        torch.cuda.synchronize()
        for k, r in zip(kern, batch):
            assert torch.equal(k, r)


@pytest.mark.parametrize("idx", range(64))
def test_kernel_equals_plain_on_random_programs(idx, cuda):
    from interpolation_engine_tpu_torch._shared import json5
    program = (tp.random_scalar_program(random.Random(7000 + idx))
               if idx < 40 else tp.random_program(random.Random(9000 + idx)))
    eng = TurboEngine(compile_src(json5.dumps(program, indent=2)),
                      TurboConfig(width=64, out_width=64, k_steps=2),
                      device=cuda)
    batch = eng.make_batch(64)
    # k2 starts as an int: give each lane its own, so lanes take their own
    # branches through goto_map and math
    gen = torch.Generator().manual_seed(idx)
    batch.regs[:, eng.cols.sint(eng.plan.slot_of["k2"])] = torch.randint(
        -99, 100, (64,), generator=gen, dtype=torch.int32).to(cuda)
    kern = type(batch)(*(t.clone() for t in batch))
    for _ in range(12):
        turbo_step(eng.tables, kern, 2)
        turbo_step_reference(eng.tables, batch, 2)
        torch.cuda.synchronize()
        for k, r in zip(kern, batch):
            assert torch.equal(k, r)


def test_sharded_step_on_two_shards_equals_the_unsharded_kernel(cuda):
    """Two shards of cuda:0 (n=301 splits unevenly): after every launch the
    sharded step equals the unsharded kernel bit for bit, and each sharded
    step is one kernel launch a shard."""
    from interpolation_engine_tpu_torch.parallel.mesh import (
        shard_turbo_batch, unshard)
    src, tcfg = bench.adventure_program(), TurboConfig(
        width=128, out_width=192, k_steps=8)
    one = TurboEngine(compile_src(src), tcfg, device=cuda)
    two = TurboEngine(compile_src(src), tcfg, mesh=[cuda, cuda])
    batch = one.make_batch(301)
    gen = torch.Generator().manual_seed(0)
    batch.regs[:, one.cols.sint(one.plan.slot_of["turn"])] = torch.randint(
        0, 40, (301,), generator=gen, dtype=torch.int32).to(cuda)
    sharded = shard_turbo_batch(batch, two.mesh)
    step_one, step_two = one.step_fn(301), two.step_fn(301)
    for _ in range(6):
        step_one(batch)
        # a sharded call is its shards' launches, one a shard
        with EVENTS.recording() as rec:
            step_two(sharded)
        torch.cuda.synchronize()
        assert rec.counters["kernel.turbo_step"] == 2
        assert "plain.turbo_step" not in rec.counters
        for a, b in zip(unshard(sharded), batch):
            assert torch.equal(a, b)


# ---- the tile design: ragged tiles, wide rows, scratch, skipped tiles -------

ADVENTURE = TurboConfig(width=128, out_width=128, k_steps=16, list_cap=12,
                        elem_width=32)
LIST_LITERAL = ("{default_state: {order_index: 1, inserts: {l: ['a'], k: 7}}"
                ", order: [{cmd:'set', item:['x{l}', 'y', '{k}'], "
                "output_name:'l'}, {cmd:'print', text:'v={l}'}], "
                "named_tasks: {}, save_states: {}}")


def held_to_plain(eng, batch, k, launches, spread=True):
    """Kernel and plain version from the same state (with each instance's
    own loop counter unless ``spread`` is false), bit for bit after every
    launch; returns the kernel's batch."""
    for key in ("i", "turn"):
        slot = eng.plan.slot_of.get(key)
        if slot is not None and spread:
            gen = torch.Generator().manual_seed(batch.regs.shape[0])
            batch.regs[:, eng.cols.sint(slot)] = torch.randint(
                0, 40, (batch.regs.shape[0],), generator=gen,
                dtype=torch.int32).to(batch.regs.device)
    kern = type(batch)(*(t.clone() for t in batch))
    for launch in range(launches):
        turbo_step(eng.tables, kern, k)
        turbo_step_reference(eng.tables, batch, k)
        torch.cuda.synchronize()
        for name, a, b in zip(batch._fields, kern, batch):
            assert torch.equal(a, b), (launch, name)
    return kern


@pytest.mark.parametrize("rows", ["1", "T-1", "T+1", "3T+5"])
def test_kernel_on_ragged_tiles(rows, cuda):
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    eng = TurboEngine(compile_src(bench.adventure_program()), ADVENTURE,
                      device=cuda)
    T = launch_plan(eng.tables, eng.make_batch(1)).tile
    n = {"1": 1, "T-1": T - 1, "T+1": T + 1, "3T+5": 3 * T + 5}[rows]
    held_to_plain(eng, eng.make_batch(n), 16, 4)


@pytest.mark.parametrize("shape", ["width512", "width80", "list_literal",
                                   "width768", "width2048"])
def test_kernel_on_wide_narrow_and_scratch_shapes(shape, cuda):
    """Adventure at width 512 (literals left in device memory), at width
    80 with 32-byte elements (row tails unused), a list literal whose
    scratch row lives in shared memory, and the promoted siblings' widths
    768 and 2048."""
    src, tcfg = {
        "width512": (bench.adventure_program(), TurboConfig(
            width=512, out_width=512, k_steps=16, list_cap=12,
            elem_width=128)),
        "width768": (bench.adventure_program(), TurboConfig(
            width=768, out_width=768, k_steps=16, list_cap=12,
            elem_width=192)),
        "width2048": (bench.adventure_program(), TurboConfig(
            width=2048, out_width=2048, k_steps=16, list_cap=12,
            elem_width=512)),
        "width80": (bench.adventure_program(), TurboConfig(
            width=80, out_width=192, k_steps=16, list_cap=12,
            elem_width=32)),
        "list_literal": (LIST_LITERAL, ADVENTURE)}[shape]
    eng = TurboEngine(compile_src(src), tcfg, device=cuda)
    if shape == "list_literal":
        assert eng.tables.host.scratch_bytes > 0
    held_to_plain(eng, eng.make_batch(333), 16, 4)


@pytest.mark.parametrize("width,size", [(768, 600), (2048, 1800)])
def test_kernel_on_promoted_rows(width, size, cuda):
    """A sibling batch as promotion builds it (tests/torch_programs.py
    ``promoted_batch``), with its launch plan: bit for bit the plain
    version, until every row parks on an output past the sibling's."""
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    eng = TurboEngine(compile_src(tp.PROMOTED_PRINT), TurboConfig(
        width=width, out_width=width, k_steps=16), device=cuda)
    T = launch_plan(eng.tables, tp.promoted_batch(eng, size, 1)).tile
    kern = held_to_plain(eng, tp.promoted_batch(eng, size, 2 * T + 5), 2, 3)
    assert bool((kern.regs[:, 1] == 2).all())          # PARKED


def test_kernel_refuses_a_width_past_its_limit(cuda):
    """No plain fallback on the card: a slot wider than the kernel's 2048
    bytes raises."""
    from interpolation_engine_tpu_torch.ops.turbo_step import MAX_WIDTH
    eng = TurboEngine(compile_src(tp.COPY_TYPES), TurboConfig(
        width=2 * MAX_WIDTH, out_width=256), device=cuda)
    with pytest.raises(ValueError, match="kernel maximum"):
        eng.step_fn(3)(eng.make_batch(3))


def test_sibling_past_the_kernel_width_escapes_on_the_card(cuda, tmp_path,
                                                           capsys):
    """A width-1024 batch would promote into a 4096-byte sibling, past the
    kernel's 2048: no sibling is built, not the kernel's ValueError; the
    instances escape to one general-engine batch on the card and finish
    equal to the host."""
    import asyncio
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch._shared import runtime
    from interpolation_engine_tpu_torch.vm.turbo import DONE
    answer = ["Z" * 1500]
    eng = TurboEngine(compile_src(tp.FAST_OVERFLOW), TurboConfig(
        width=1024, out_width=1024, k_steps=16), io_factory=lambda i:
        iom.IOManager(iom.ScriptedBackend(list(answer))), device=cuda)
    res = eng.results(eng.run(eng.make_batch(2)))
    assert sorted(eng._escape_results) == [0, 1]
    assert eng.escape_runners[0].device == cuda
    path = tmp_path / "prog.json5"
    path.write_text(tp.FAST_OVERFLOW)
    host = asyncio.run(runtime.async_main(
        str(path), [], iom.IOManager(iom.ScriptedBackend(list(answer)))))
    capsys.readouterr()
    for r in res:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def host_run(src, answers, tmp_path, capsys) -> dict:
    import asyncio
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch._shared import runtime
    path = tmp_path / "prog.json5"
    path.write_text(src)
    host = asyncio.run(runtime.async_main(
        str(path), [], iom.IOManager(iom.ScriptedBackend(list(answers)))))
    capsys.readouterr()
    return host


def test_sibling_past_a_blocks_shared_memory_escapes_on_the_card(
        cuda, tmp_path, capsys):
    """The bench's width-512 cell on a program of 151 byte rows: one
    instance of its 2048-wide sibling does not fit a block's shared memory,
    so no sibling is built (not the tile plan's ValueError at its first
    launch); the instances whose answer outgrows the slot escape to one
    general-engine batch on the card, and every instance finishes equal to
    the host."""
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch.vm.turbo import DONE
    src = tp.many_rows_program()
    answers = {0: ["Z" * 600], 1: ["short"]}
    eng = TurboEngine(compile_src(src), TurboConfig(
        width=512, elem_width=128, out_width=512, list_cap=12),
        io_factory=lambda i: iom.IOManager(iom.ScriptedBackend(
            list(answers[i % 2]))), device=cuda)
    assert eng._wide_tcfg() is None
    with EVENTS.recording() as rec:
        res = eng.results(eng.run(eng.make_batch(6)))
    assert rec.counters.get("kernel.turbo_step", 0) > 0
    assert sorted(eng._escape_results) == [0, 2, 4]
    assert [r.instance_ids for r in eng.escape_runners] == [[0, 2, 4]]
    assert eng.escape_runners[0].device == cuda
    hosts = [host_run(src, answers[k], tmp_path, capsys) for k in (0, 1)]
    for i, r in enumerate(res):
        assert r.status == DONE
        assert (r.output, r.inserts) == (hosts[i % 2]["output"],
                                         dict(hosts[i % 2]["inserts"]))


def test_base_config_past_a_blocks_shared_memory_runs_on_the_general_engine(
        cuda, tmp_path, capsys):
    """20 strings and 20 lists of 24 elements at 2048 as the base config
    (141 byte rows): the turbo engine refuses it (NotTurbo) and
    run_program_on_device runs it on the general engine on the card (its
    default VMConfig holds the 41 inserts), printing what the host
    prints."""
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch.vm import driver
    from interpolation_engine_tpu_torch.vm.turbo import NotTurbo
    src = tp.many_rows_program(20)
    wide = TurboConfig(width=2048, elem_width=512, out_width=2048,
                       list_cap=24)
    with pytest.raises(NotTurbo, match="shared memory"):
        TurboEngine(compile_src(src), wide, device=cuda)
    host = host_run(src, ["hello"], tmp_path, capsys)
    path = tmp_path / "prog.json5"
    assert driver.run_program_on_device(
        str(path), [], iom.IOManager(iom.ScriptedBackend(["hello"] * 4)),
        batch=4, tcfg=wide, device=cuda) == 0
    assert capsys.readouterr().out.strip() == host["output"].strip()


def test_fast_ring_and_promotion_on_the_card_equal_the_cpu(cuda):
    """race-io through the fast park path, and an instance promoted to its
    768-byte sibling mid-run: on the card, through the kernel only, equal
    to the same runs on the CPU."""
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    answers = {0: ["s1", "x2", "x3"], 1: ["B" * 600, "x2", "x3"]}
    runs = {}
    for dev in ("cpu", cuda):
        race = TurboEngine(compile_src(bench.race_io_program(t_max=3)),
                           TurboConfig(width=128, out_width=128, k_steps=16),
                           io_factory=lambda i: iom.IOManager(
                               iom.ScriptedBackend(["cgo"] * 3)), device=dev)
        promo = TurboEngine(compile_src(tp.PROMOTE_MID_RUN), TurboConfig(
            tile=8, width=192, out_width=192, k_steps=24),
            io_factory=lambda i: iom.IOManager(
                iom.ScriptedBackend(list(answers[i % 2]))), device=dev)
        with EVENTS.recording() as rec:
            res = [e.results(e.run(e.make_batch(n))) for e, n in
                   ((race, 300), (promo, 6))]
        launched = (rec.counters.get("kernel.turbo_step", 0),
                    rec.counters.get("plain.turbo_step", 0))
        assert race.ring_stats["fast_parks"] == 900
        assert sorted(promo._escape_results) == [1, 3, 5]
        runs[str(dev)] = [[(r.output, r.inserts, r.status, r.steps)
                           for r in rr] for rr in res], launched
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][1][0] > 0 and runs["cuda"][1][1] == 0


def test_kernel_leaves_tiles_without_a_running_instance(cuda):
    """The first tiles hold only PARKED and DONE instances: the kernel
    skips them, leaves them as they were, and runs the rest."""
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STATUS, DONE, PARKED)
    eng = TurboEngine(compile_src(bench.adventure_program()), ADVENTURE,
                      device=cuda)
    T = launch_plan(eng.tables, eng.make_batch(1)).tile
    batch = eng.make_batch(5 * T)
    batch.regs[:2 * T, C_STATUS] = torch.tensor(
        [PARKED, DONE] * T, dtype=torch.int32, device=cuda)
    before = type(batch)(*(t.clone() for t in batch))
    kern = held_to_plain(eng, batch, 16, 3, spread=False)
    for a, b in zip(kern, before):
        parked = a[:2 * T] if a.dim() == 2 else a[:, :2 * T]
        was = b[:2 * T] if b.dim() == 2 else b[:, :2 * T]
        assert torch.equal(parked, was)
    assert bool((kern.regs[2 * T:, 2] > 0).all())


def test_sharded_step_on_unequal_shards_equals_plain(cuda):
    """Three shards of cuda:0 of unequal size, each with a ragged last
    tile: the sharded step equals its plain version after every launch."""
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        launch_plan, sharded_turbo_step, sharded_turbo_step_reference)
    from interpolation_engine_tpu_torch.parallel.mesh import (
        shard_turbo_batch, unshard)
    eng = TurboEngine(compile_src(bench.adventure_program()), ADVENTURE,
                      mesh=[cuda] * 3)
    T = launch_plan(eng.tables, eng.make_batch(3).shards[0]).tile
    batch = eng.make_batch(3 * T + 4)     # shards of T + 2, T + 1, T + 1
    sizes = [s.regs.shape[0] for s, _ in batch.parts()]
    assert len(set(sizes)) > 1
    plain = shard_turbo_batch(unshard(batch), eng.mesh)
    for launch in range(4):
        sharded_turbo_step(eng.step_tables, batch, 16)
        sharded_turbo_step_reference(eng.step_tables, plain, 16)
        torch.cuda.synchronize()
        for a, b in zip(unshard(batch), unshard(plain)):
            assert torch.equal(a, b), launch


def test_kernel_attributes_show_no_stack_buffer(cuda):
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        kernel_attributes)
    eng = TurboEngine(compile_src(tp.COPY_TYPES), TurboConfig(), device=cuda)
    eng.step_fn(5)(eng.make_batch(5))
    torch.cuda.synchronize()
    attrs = kernel_attributes(cuda)
    assert attrs["local_bytes"] < 512
    assert attrs["max_dynamic_shared_bytes"] > 48 * 1024


# registers and local bytes a thread of the one-thread instance,
# turbo_step_kernel<1>'s registers and local bytes as of the kernel before
# it had a warp instance, built by nvcc 12.8 for sm_90a: a ceiling, since
# another toolchain may allot fewer; the local bytes are the RPN operand
# stack, which is indexed at run time
ONE_THREAD = {"registers": 100, "local_bytes": 64}


def test_both_instances_attributes(cuda):
    """Each lane group's instance: no stack past the RPN operand stack,
    and the opt-in above 48 KB, which the first launch sets for both; the
    one-thread instance takes no more registers and stack than it had
    before the warp instance came."""
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        kernel_attributes)
    eng = TurboEngine(compile_src(tp.COPY_TYPES), TurboConfig(), device=cuda)
    eng.step_fn(5)(eng.make_batch(5))
    torch.cuda.synchronize()
    one, warp = kernel_attributes(cuda, 1), kernel_attributes(cuda, 32)
    for attrs in (one, warp):
        assert attrs["local_bytes"] <= ONE_THREAD["local_bytes"]
        assert attrs["max_dynamic_shared_bytes"] > 48 * 1024
    assert all(one[k] <= most for k, most in ONE_THREAD.items()), one
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel_attributes(cuda, 16)


def wide_case(name, cuda):
    """(engine, batch) of a plan that steps a row with a warp: the
    ``prompt-chain`` cell's rows resumed from 600 of its traffic's states
    (T = 3), or the width-2048 sibling of the bench's width-512 adventure
    (T = 5)."""
    if name == "prompt_chain":
        from portbench import run
        from interpolation_engine_tpu_torch._shared import planner
        from interpolation_engine_tpu_torch.vm.turbo import base_config
        traffic = run.load_cell("prompt-chain")["traffic"]
        text = run.program_text(traffic)
        plan = planner.plan_turbo(compile_src(text))
        eng = TurboEngine(plan.compiled, base_config(plan), device=cuda,
                          plan=plan)
        states = run.start_states(traffic, text, 2**31 + 99)
        return eng, eng.load_batch(random.Random(99).sample(states, 600))
    eng = TurboEngine(compile_src(bench.adventure_program()), TurboConfig(
        width=2048, out_width=2048, k_steps=16, list_cap=12,
        elem_width=512), device=cuda)
    return eng, eng.make_batch(1024)


@pytest.mark.parametrize("name", ["prompt_chain", "sibling_w2048"])
def test_kernel_steps_a_wide_row_with_a_warp(name, cuda):
    """The warp instance on the rows it takes: bit for bit the plain
    version after every launch (32 steps a launch for the prompt chain, as
    its cell launches; 16 for the sibling)."""
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    eng, batch = wide_case(name, cuda)
    plan = launch_plan(eng.tables, batch)
    assert plan.lanes == 32 and plan.tile <= 8
    held_to_plain(eng, batch, eng.tcfg.k_steps, 3)


def test_a_launch_counts_a_warp_a_row_where_its_plan_says(cuda):
    """``turbo.warp_row_launches``: three launches of the prompt chain's
    wide batch (T = 3) count three; three of adventure at width 128
    (T > 8) count none."""
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    narrow = TurboEngine(compile_src(bench.adventure_program()), ADVENTURE,
                         device=cuda)
    for (eng, batch), want in ((wide_case("prompt_chain", cuda), 3),
                               ((narrow, narrow.make_batch(200)), 0)):
        with EVENTS.recording() as rec:
            for _ in range(3):
                turbo_step(eng.tables, batch, 4)
        torch.cuda.synchronize()
        assert launch_plan(eng.tables, batch).lanes == (32 if want else 1)
        assert rec.counters.get("turbo.warp_row_launches", 0) == want


def test_launch_plan_is_made_once_for_the_cards_shared_memory(cuda):
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        H100_SHARED, launch_plan, shared_memory, tile_plan)
    shared = shared_memory(cuda)
    assert 48 * 1024 < shared.per_block <= shared.per_sm
    if "H100" in torch.cuda.get_device_name(cuda):
        assert shared == H100_SHARED
    eng = TurboEngine(compile_src(bench.adventure_program()), ADVENTURE,
                      device=cuda)
    batch = eng.make_batch(7)
    plan = launch_plan(eng.tables, batch)
    assert plan == tile_plan(eng.tables, batch, shared=shared)
    eng.step_fn(7)(batch)
    assert launch_plan(eng.tables, batch) is plan
    assert len(eng.tables.plans) == 1


def test_kernel_counts_its_launches(cuda):
    eng = TurboEngine(compile_src(tp.COPY_TYPES), TurboConfig(), device=cuda)
    step, batch = eng.step_fn(5), eng.make_batch(5)
    with EVENTS.recording() as rec:
        step(batch)
    torch.cuda.synchronize()
    assert rec.counters["kernel.turbo_step"] == 1
    assert "plain.turbo_step" not in rec.counters


# ---------------------------------------------------------------------------
# the brace-scan kernel (csrc/brace_scan.cu) and the general engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ms,skip", [
    (1, 7, 0), (1, 96, 0), (33, 31, 0), (257, 96, 0), (1000, 130, 0),
    (4099, 512, 0), (5, 0, 0),
    # a base 130 bytes on, not 16-byte aligned: bufs[1:]
    (1001, 130, 1),
    # ragged tiles of R rows
    ("R-1", 96, 0), ("R+1", 96, 0), ("3R+5", 96, 0), ("3R+5", 130, 1),
    ("3R+5", 600, 0),
    (1 << 20, 512, 0)])
def test_brace_scan_kernel_equals_plain(n, ms, skip, cuda):
    """Bit for bit on seeded rows over ``ab{}\\ `` with lengths in
    [-3, MS + 5] (a length past MS counts as MS, a negative one as 0); with
    ``skip`` the rows are ``bufs[skip:]``, a contiguous view whose base lies
    ``skip * MS`` bytes into the tensor."""
    import numpy as np
    from interpolation_engine_tpu_torch.ops.brace_scan import (
        brace_scan, brace_scan_reference, kernel_plan)
    R = kernel_plan(ms)["rows"]
    n = {"R-1": R - 1, "R+1": R + 1, "3R+5": 3 * R + 5}.get(n, n)
    rng = np.random.default_rng(n * 1000 + ms)
    alphabet = np.frombuffer(b"ab{}\\ ", np.uint8)
    bufs = torch.from_numpy(alphabet[rng.integers(0, 6, (n + skip, ms))]
                            ).to(cuda)[skip:]
    lens = torch.from_numpy(rng.integers(-3, ms + 6, n).astype(
        np.int32)).to(cuda)
    assert bufs.is_contiguous()
    if skip and ms % 16:
        assert bufs.data_ptr() % 16 != 0
    with EVENTS.recording() as rec:
        got = brace_scan(bufs, lens)
        want = brace_scan_reference(bufs, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rec.counters == {"kernel.brace_scan": 1, "plain.brace_scan": 1}


GENERAL = tp.general_programs(bench)


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_engine_cuda_equals_cpu_after_every_launch(name, cuda):
    """The port's general engine on the card (brace-scan kernel) and on the
    CPU (its plain version), through the ring: every field after every
    launch."""
    general_cuda_equals_cpu(GENERAL[name], cuda)


def test_list_slice_expression_bound_cuda_equals_cpu(cuda):
    """list_slice bounds that are expression strings, evaluated by the
    byte math evaluator on the card and on the CPU: every field after
    every launch."""
    general_cuda_equals_cpu(tp.LIST_SLICE_EXPR, cuda)


def general_cuda_equals_cpu(src, cuda):
    from interpolation_engine_tpu_torch._shared import io_manager, vm_config
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    cfg = vm_config.VMConfig(max_str=96, max_key=24, n_slots=12,
                             arena_size=1024, pool_size=32, out_size=192,
                             max_subst=6, max_stars=2, max_list=16,
                             max_fix=4)
    compiled = compile_src(src)
    snaps = {}
    for dev in ("cpu", cuda):
        runner = DeviceRunner(compiled, cfg, io_factory=lambda i: (
            io_manager.IOManager(io_manager.ScriptedBackend(["ok"] * 24))),
            device=dev)
        launch, rec = runner.launch, snaps.setdefault(str(dev), [])

        def recorded(batch, k, launch=launch, rec=rec):
            batch = launch(batch, k)
            rec.append(batch.to_numpy())
            return batch
        runner.launch = recorded
        final = runner.run(runner.make_instances(3), inner_steps=16,
                           max_rounds=400)
        assert all(r.status == vm_config.DONE
                   for r in runner.results(final))
    cpu, card = snaps["cpu"], snaps[str(cuda)]
    assert len(cpu) == len(card)
    for k, (a, b) in enumerate(zip(cpu, card)):
        for f in a:
            assert (a[f] == b[f]).all(), (k, f)


# ---------------------------------------------------------------------------
# the chat-filter kernel (csrc/chat_filter.cu)
# ---------------------------------------------------------------------------

def filter_held_to_plain(bufs, lengths, delims, enum) -> dict:
    """Kernel and plain version on the same rows on the card: every field
    equal byte for byte, one launch counted."""
    from interpolation_engine_tpu_torch.ops.filter_kernel import (
        filter_chat_reference, filter_chat_text)
    start, stop, hs, he = delims
    kw = dict(start=start, stop=stop, hide_start=hs, hide_stop=he,
              enumerate_outputs=enum)
    with EVENTS.recording() as rec:
        got = filter_chat_text(bufs, lengths, **kw)
    want = filter_chat_reference(bufs, lengths, **kw)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.chat_filter": 1}
    for key in want:
        assert torch.equal(got[key], want[key]), key
    return got


@pytest.mark.parametrize("case", range(len(tc.FILTER_CASES)))
def test_chat_filter_kernel_equals_plain_on_curated_cases(case, cuda):
    raw, start, stop, hs, he, enum = tc.FILTER_CASES[case]
    bufs, lengths = tc.rows([raw])
    filter_held_to_plain(bufs.to(cuda), lengths.to(cuda),
                         (start, stop, hs, he), enum)


@pytest.mark.parametrize("text", range(len(tc.CUT_TEXTS)))
def test_chat_filter_kernel_equals_plain_cut_at_every_length(text, cuda):
    raw, delims = tc.CUT_TEXTS[text]
    bufs, lengths = tc.cut_rows(raw)
    for enum in (False, True):
        filter_held_to_plain(bufs.to(cuda), lengths.to(cuda), delims, enum)


@pytest.mark.parametrize("seed", [991, 5, 6])
def test_chat_filter_kernel_equals_plain_on_the_fuzz(seed, cuda):
    for (start, stop, hs, he, enum), raws in tc.by_delimiters(
            tc.fuzz_streams(seed)).items():
        bufs, lengths = tc.rows(raws)
        filter_held_to_plain(bufs.to(cuda), lengths.to(cuda),
                             (start, stop, hs, he), enum)


@pytest.mark.parametrize("n,L,skip", [(1, 64, 0), (33, 513, 1),
                                      (4099, 1024, 0), (2048, 8192, 0),
                                      (1000, 8193, 1)])
def test_chat_filter_kernel_on_chat_streams(n, L, skip, cuda):
    """Chat-shaped streams (one in nine opening 20 spans) with lengths in
    [-3, L + 5]; with ``skip`` the rows are ``bufs[skip:]``, whose base is
    not 16-byte aligned when L is odd."""
    import numpy as np
    rng = random.Random(n * 7 + L)
    lens = np.random.default_rng(n + L).integers(-3, L + 6, n + skip)
    raws = [tc.chat_stream(i, min(max(int(k), 0), L), rng,
                           None if i % 9 else 20)
            for i, k in enumerate(lens)]
    bufs, _ = tc.rows(raws, L)
    bufs = bufs.to(cuda)[skip:]
    lengths = torch.from_numpy(lens[skip:].astype(np.int32)).to(cuda)
    assert bufs.is_contiguous()
    for enum in (False, True):
        filter_held_to_plain(bufs, lengths, tc.STREAM_DELIMS, enum)
    filter_held_to_plain(bufs, lengths, ("", "", "<think>", "</think>"), True)


def test_chat_filter_kernel_on_long_delimiters_and_non_ascii(cuda):
    start, stop = "<" + "s" * 38 + ">", "[" + "e" * 298 + "]"
    raws = [start + "kept ✓" + stop + "out" + start + "tail" + stop[:150],
            start + "x" + stop[:299], "no delimiter", start + stop,
            "héllo " + start + "日本語" + stop + "☃"]
    bufs, lengths = tc.rows(raws)
    for enum in (False, True):
        filter_held_to_plain(bufs.to(cuda), lengths.to(cuda),
                             (start, stop, "<h" * 20, "</h" * 30), enum)


def test_chat_filter_host_on_the_card_equals_the_cpu(cuda):
    from interpolation_engine_tpu_torch.ops.filter_kernel import (
        filter_chat_host)
    streams = list(tc.FILTER_CASES) + [
        ("".join(f"<o>s{k}</o>," for k in range(20)), "<o>", "</o>", "",
         "", True)] + tc.fuzz_streams(991, 40)
    with EVENTS.recording() as rec:
        for stream in streams:
            assert filter_chat_host(*stream) == filter_chat_host(
                *stream, device="cpu")
    assert rec.counters["host.chat_filter"] == 2


# ---------------------------------------------------------------------------
# the math-evaluator (csrc/math_eval.cu) and wildcard (csrc/wildcard_match.cu)
# kernels
# ---------------------------------------------------------------------------

def expression_rows(n, ms, seed, lists=False):
    """n seeded rows of chip_smoke's expression shapes (comma lists with
    ``lists``), junk past each length."""
    import numpy as np
    import chip_smoke as cs
    rng = random.Random(seed)
    texts = [",".join(cs.math_expr(rng) for _ in range(rng.randint(1, 4)))
             if lists else cs.math_expr(rng) for _ in range(n)]
    return cs.byte_rows(texts, ms, np.random.default_rng(seed))


@pytest.mark.parametrize("n,ms", [(1, 96), (129, 96), (5000, 96), (300, 7),
                                  (2049, 130)])
@pytest.mark.parametrize("mode", ["flat", "min", "max", "mixed"])
def test_math_eval_kernel_equals_plain(n, ms, mode, cuda):
    from interpolation_engine_tpu_torch.ops import math_kernel as mak
    bufs, lens = expression_rows(n, ms, n + ms, lists=mode != "flat")
    if ms == 7:     # lengths past the row and below 0
        lens = torch.randint(-2, ms + 6, (n,), generator=torch.Generator()
                             .manual_seed(n), dtype=torch.int32).to(cuda)
    rows = torch.arange(n, device=cuda)
    want_max = {"flat": None, "min": rows < 0, "max": rows >= 0,
                "mixed": rows % 3 == 0}[mode]
    with EVENTS.recording() as rec:
        got = mak.math_eval_kernel(bufs, lens, want_max)
    want = (mak.eval_flat_reference(bufs, lens) if want_max is None else
            mak.eval_enum_minmax_reference(bufs, lens, want_max))
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.math_eval": 1}
    assert torch.equal(got.err, want.err)
    assert torch.equal(got.value, want.value)


def test_math_evaluator_dispatches_to_the_kernel_on_the_card(cuda):
    from interpolation_engine_tpu_torch.ops import math_kernel as mak
    bufs, lens = expression_rows(64, 96, 1, lists=True)
    with EVENTS.recording() as rec:
        mak.eval_flat(bufs, lens)
        mak._eval_enum_minmax(bufs, lens, torch.ones(64, dtype=torch.bool,
                                                     device=cuda))
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.math_eval": 2}


def wildcard_rows(n, ms, seed, shared=False, stars=None):
    import numpy as np
    import chip_smoke as cs
    rng = random.Random(seed)
    gen = np.random.default_rng(seed)
    pats = [cs.wild_pattern(rng, stars) for _ in range(1 if shared else n)]
    subjs = [cs.wild_subject(rng, pats[0 if shared else i], ms)
             for i in range(n)]
    return (*cs.byte_rows(pats, ms, gen), *cs.byte_rows(subjs, ms, gen))


@pytest.mark.parametrize("n,ms", [(1, 96), (129, 96), (5000, 96), (300, 40),
                                  (2049, 130)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("max_stars", [2, 7])
def test_wildcard_match_kernel_equals_plain(n, ms, shared, max_stars, cuda):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    args = wildcard_rows(n, ms, n + ms + max_stars, shared,
                         2 if shared else None)
    with EVENTS.recording() as rec:
        got = mk.wildcard_match_kernel(*args, max_stars)
    want = mk.wildcard_match_reference(*args, max_stars)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.wildcard_match": 1}
    for name, g, w in zip(mk.MatchResult._fields, got, want):
        assert torch.equal(g, w), name


def test_wildcard_lengths_past_the_row_equal_plain(cuda):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    pb, _, sb, _ = wildcard_rows(500, 12, 3)
    gen = torch.Generator().manual_seed(3)
    pl, sl = (torch.randint(-2, 20, (500,), generator=gen,
                            dtype=torch.int32).to(cuda) for _ in range(2))
    got = mk.wildcard_match_kernel(pb, pl, sb, sl, 3)
    want = mk.wildcard_match_reference(pb, pl, sb, sl, 3)
    for name, g, w in zip(mk.MatchResult._fields, got, want):
        assert torch.equal(g, w), name


def test_wildcard_match_dispatches_to_the_kernel_on_the_card(cuda):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    args = wildcard_rows(64, 96, 2)
    with EVENTS.recording() as rec:
        mk.wildcard_match(*args, 2)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.wildcard_match": 1}


def test_wildcard_match_kernel_refuses_what_it_cannot_take(cuda):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    pb, pl, sb, sl = wildcard_rows(8, 16, 4)
    with pytest.raises(ValueError):
        mk.wildcard_match(pb, pl, sb, sl, 65)
    with pytest.raises(ValueError):
        mk.wildcard_match(pb[:3], pl[:3], sb, sl, 2)


def test_wildcard_match_kernel_refuses_lengths_off_the_card(cuda):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    pb, pl, sb, sl = wildcard_rows(8, 16, 5)
    for args in ((pb, pl.cpu(), sb, sl), (pb, pl, sb, sl.cpu()),
                 (pb, pl[:5], sb, sl), (pb, pl, sb, sl[:5])):
        with pytest.raises(ValueError):
            mk.wildcard_match_kernel(*args, 2)


def test_math_eval_kernel_refuses_want_max_that_is_not_a_bool_row(cuda):
    from interpolation_engine_tpu_torch.ops import math_kernel as mak
    bufs, lens = expression_rows(8, 96, 6, lists=True)
    rows = torch.arange(8, device=cuda)
    for want_max in (rows % 2 == 0).cpu(), rows % 2, (rows[:5] > 2):
        with pytest.raises(ValueError):
            mak.math_eval_kernel(bufs, lens, want_max)


# the block design of M and W (rows staged in shared memory): the shapes of
# the g++ rehearsals' hazard tests, on the card against the plain versions

def on_card_at_offset(rows, offset):
    """Rows on the card as a contiguous view ``offset`` bytes into a larger
    buffer."""
    n, ms = rows.shape
    big = torch.full((n * ms + offset + 32,), 42, dtype=torch.uint8,
                     device=rows.device)
    view = big[offset:offset + n * ms].view(n, ms)
    view.copy_(rows)
    assert view.is_contiguous()
    return view


def math_held(bufs, lens, cuda):
    from interpolation_engine_tpu_torch.ops import math_kernel as mak
    rows = torch.arange(bufs.shape[0], device=cuda)
    for want_max in (None, rows % 2 == 0):
        got = mak.math_eval_kernel(bufs, lens, want_max)
        want = (mak.eval_flat_reference(bufs, lens) if want_max is None else
                mak.eval_enum_minmax_reference(bufs, lens, want_max))
        torch.cuda.synchronize()
        assert torch.equal(got.err, want.err)
        assert torch.equal(got.value, want.value)


def match_held(pb, pl, sb, sl, max_stars):
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    got = mk.wildcard_match_kernel(pb, pl, sb, sl, max_stars)
    want = mk.wildcard_match_reference(pb, pl, sb, sl, max_stars)
    torch.cuda.synchronize()
    for name, g, w in zip(mk.MatchResult._fields, got, want):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("n", [1, 127, 129, 3 * 128 + 37])
def test_math_and_wildcard_partial_last_block(n, cuda):
    math_held(*expression_rows(n, 96, n, lists=True), cuda)
    match_held(*wildcard_rows(n, 96, n), 2)
    match_held(*wildcard_rows(n, 96, n, shared=True, stars=2), 2)


def test_math_and_wildcard_lengths_past_ms_and_of_zero(cuda):
    gen = torch.Generator().manual_seed(7)

    def mixed(lens):
        pick = torch.randint(0, 4, lens.shape, generator=gen).to(cuda)
        wide = torch.randint(97, 300, lens.shape, generator=gen,
                             dtype=torch.int32).to(cuda)
        lens = torch.where(pick == 0, 0, lens)
        lens = torch.where(pick == 1, wide, lens)
        return torch.where(pick == 2, -3, lens).to(torch.int32)

    bufs, lens = expression_rows(700, 96, 7, lists=True)
    math_held(bufs, mixed(lens), cuda)
    pb, pl, sb, sl = wildcard_rows(700, 96, 7)
    match_held(pb, mixed(pl), sb, mixed(sl), 2)


def test_wildcard_literal_straddling_a_word_boundary_at_every_offset(cuda):
    import numpy as np
    import chip_smoke as cs
    pats, subjs = [], []
    for m in (1, 2, 3, 4, 5, 7, 8, 9, 31, 32):
        lit = "".join("ab"[(k * 7 + m) % 3 % 2] for k in range(m))
        for po in range(4):
            for so in range(4):
                for bad in (None, 0, m - 1):
                    s = list(lit)
                    if bad is not None:
                        s[bad] = "x"
                    pats.append("z" * po + "*" + lit + "*")
                    subjs.append("z" * po + "y" * so + "".join(s) + "yy")
                    pats.append("*" + "z" * po + lit)
                    subjs.append("w" * (so + 4) + "z" * po + "".join(s))
    gen = np.random.default_rng(8)
    got = match_held(*cs.byte_rows(pats, 96, gen), *cs.byte_rows(subjs, 96,
                                                                 gen), 2)
    assert got.ok.any() and not got.ok.all()


def test_math_int_min_by_minus_one_and_power_by_squaring(cuda):
    import numpy as np
    import chip_smoke as cs
    bases = ["0", "1", "2", "3", "7", "46341", "2147483647", "2147483648",
             "4294967295", "4294967293"]
    exprs = [f"{b} ** {e}" for b in bases for e in range(41)]
    exprs += ["-2147483648 // -1", "2147483648 // -1", "-2147483648 % -1",
              "2147483648 / -1", "2147483648 // 4294967295"]
    math_held(*cs.byte_rows(exprs, 96, np.random.default_rng(9)), cuda)


def test_wildcard_shared_pattern_staged_once_and_max_stars_64(cuda):
    for seed in range(3):
        match_held(*wildcard_rows(500, 96, 20 + seed, shared=True, stars=2),
                   3)
    import random
    import numpy as np
    import chip_smoke as cs
    rng = random.Random(64)
    pats = ["*".join(rng.choice(["", "a", "b"]) for _ in range(
        rng.randint(1, 70))) for _ in range(300)]
    subjs = ["".join(lit + rng.choice(["", "a"]) for lit in p.split("*"))
             for p in pats]
    gen = np.random.default_rng(64)
    match_held(*cs.byte_rows(pats, 96, gen), *cs.byte_rows(subjs, 96, gen),
               64)


@pytest.mark.parametrize("offset", [1, 2, 4, 16])
def test_math_and_wildcard_rows_at_unaligned_bases(offset, cuda):
    bufs, lens = expression_rows(300, 96, offset, lists=True)
    math_held(on_card_at_offset(bufs, offset), lens, cuda)
    pb, pl, sb, sl = wildcard_rows(300, 24, offset)
    match_held(on_card_at_offset(pb, offset), pl,
               on_card_at_offset(sb, offset), sl, 2)
    pb, pl, sb, sl = wildcard_rows(300, 96, offset)
    match_held(on_card_at_offset(pb, offset), pl,
               on_card_at_offset(sb, offset), sl, 2)


def test_math_and_wildcard_rows_wider_than_the_stage(cuda):
    import random
    import numpy as np
    import chip_smoke as cs
    rng = random.Random(600)
    gen = np.random.default_rng(600)
    exprs = [("," if k % 2 else " + ").join(
        cs.math_expr(rng) for _ in range(rng.randint(20, 60)))
        for k in range(300)]
    math_held(*cs.byte_rows(exprs, 600, gen), cuda)
    pats, subjs = [], []
    for _ in range(300):
        lits = ["".join(rng.choice("ab") for _ in range(rng.randint(0, 30)))
                for _ in range(rng.randint(1, 4))]
        pats.append("*".join(lits))
        subjs.append("".join(lit + "".join(rng.choice("ab\n") for _ in range(
            rng.randint(0, 250))) for lit in lits[:-1]) + lits[-1])
    got = match_held(*cs.byte_rows(pats, 600, gen),
                     *cs.byte_rows(subjs, 600, gen), 3)
    assert got.ok.sum() > 20


@pytest.mark.parametrize("n", [4_096, 10_000, 20_000, 70_000])
def test_math_and_wildcard_at_each_rows_a_warp(n, cuda):
    """Calls of 4,096 to 70,000 rows: on an H100's 132 SMs the matcher
    takes 4, 16, 32 and 32 rows a warp, the evaluator 1, 4, 8 and 32 (fewer
    on fewer SMs)."""
    math_held(*expression_rows(n, 96, n, lists=True), cuda)
    match_held(*wildcard_rows(n, 96, n), 2)
    match_held(*wildcard_rows(n, 96, n, shared=True, stars=2), 2)
