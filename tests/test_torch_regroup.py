"""The regroup of a turbo launch's rows by pc (``ops/turbo_step.py``
``regroup``, ``csrc/regroup.cu``) and the launch order that uses it.

On the CPU: the plain version (``regroup_reference``, a stable sort by each
row's bin) gives a permutation, RUNNING rows binned by pc in pc order, the
other rows last, each bin in row order, and the identity on a lockstep
batch; the shape rule (``regroups``) and ``launch_order`` on the
adventure's resumed rows. On a card (skipped without one): the kernel
equals the plain version bit for bit, and ``turbo_step`` in the regroup's
order equals ``turbo_step_reference`` after every launch."""

import itertools
import random
import string
from types import SimpleNamespace

import pytest
import torch

import torch_programs as tp

from interpolation_engine_tpu_torch import bench
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm.turbo import (
    C_PC, C_STATUS, DONE, PARKED, RUNNING, TurboConfig, TurboEngine)

# the adventure at its widths in the port's benchmark: a row's state in
# shared memory leaves T = 53 instances a block on an H100
ADVENTURE = TurboConfig(tile=128, width=128, out_width=256, k_steps=32,
                        list_cap=12, elem_width=32)
H100_SMS = 132
# where a saved game resumes: a room, the task after its label (its clear,
# turn, scene, append and length, trim dispatch, race, score, turn check,
# room dispatch) and its history's length
ROOMS, AFTER, HISTORY = range(6), (1, 2, 3, 4, 5, 6, 10, 11, 12, 14), \
    range(1, 10)


def compile_src(src):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader)
    return compile_program(json5.loads(loader.add_line_numbers(src)))


def resumed_adventure(device, n: int, seed: int = 2_147_483_659):
    """The adventure (``bench.adventure_program``) at n rows resumed from
    saved games of their own: one state for each room, task after the
    room's label and history length (540, at 60 start pcs), its turn,
    score and history drawn from the seed, dealt to the rows in a shuffled
    order, so that the rows of a warp sit at different tasks."""
    compiled = compile_src(bench.adventure_program())
    labels = {t["name"]: k for k, t in enumerate(compiled.program["order"])
              if t["cmd"] == "label"}
    rng = random.Random(seed)
    states = []
    for room, after, hlen in itertools.product(ROOMS, AFTER, HISTORY):
        turn = rng.randint(10, 90)
        hist = ["".join(rng.choices(string.ascii_lowercase, k=4))
                for _ in range(hlen)]
        states.append({"inserts": {
            "turn": turn, "acc": rng.randint(100_000, 998_999),
            "hist": hist, "hlen": hlen, "scene": f"scene-{room}-{turn}",
            "choice": f"c{room}"}, "output": "",
            "order_index": labels[f"@room-{room}"] + 1 + after})
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    eng = TurboEngine(compiled, ADVENTURE, device=device)
    return eng, eng.load_batch([states[v] for v in
                                (rows % len(states)).tolist()])


@pytest.fixture(scope="module")
def adventure():
    return resumed_adventure("cpu", 8192)


def random_regs(n: int, n_instr: int, seed: int, regw: int = 12):
    """Rows of every status, at pcs in and past [0, n_instr)."""
    gen = torch.Generator().manual_seed(seed)
    regs = torch.randint(-50, 50, (n, regw), generator=gen,
                         dtype=torch.int32)
    regs[:, C_PC] = torch.randint(-2, n_instr + 3, (n,), generator=gen,
                                  dtype=torch.int32)
    regs[:, C_STATUS] = torch.tensor([RUNNING, RUNNING, RUNNING, DONE,
                                      PARKED], dtype=torch.int32)[
        torch.randint(0, 5, (n,), generator=gen)]
    return regs


def bins(regs, n_instr):
    pc, st = regs[:, C_PC], regs[:, C_STATUS]
    live = (st == RUNNING) & (pc >= 0) & (pc < n_instr)
    return torch.where(live, pc, torch.full_like(pc, n_instr))


# ---- the plain version -------------------------------------------------------

SIZES = [(1, 5), (37, 3), (1000, 40), (4099, 100)]


@pytest.mark.parametrize("n,n_instr", SIZES)
def test_the_twin_gives_a_permutation(n, n_instr):
    perm = ts.regroup_reference(random_regs(n, n_instr, n), n_instr)
    assert perm.dtype == torch.int32 and perm.shape == (n,)
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("n,n_instr", SIZES)
def test_running_rows_come_binned_by_pc_in_pc_order(n, n_instr):
    regs = random_regs(n, n_instr, n + 1)
    perm = ts.regroup_reference(regs, n_instr).long()
    key = bins(regs, n_instr)[perm]
    running = key < n_instr
    assert bool((key[1:] >= key[:-1]).all())
    assert torch.equal(key[running], regs[perm, C_PC][running])
    assert bool((regs[perm, C_STATUS][running] == RUNNING).all())


@pytest.mark.parametrize("n,n_instr", SIZES)
def test_rows_not_running_come_last(n, n_instr):
    regs = random_regs(n, n_instr, n + 2)
    perm = ts.regroup_reference(regs, n_instr).long()
    live = bins(regs, n_instr)[perm] < n_instr
    k = int(live.sum())
    assert bool(live[:k].all()) and not bool(live[k:].any())
    # a RUNNING row at a pc past the program is not stepped: it is last too
    rest = regs[perm[k:]]
    assert bool(((rest[:, C_STATUS] != RUNNING) | (rest[:, C_PC] < 0)
                 | (rest[:, C_PC] >= n_instr)).all())


@pytest.mark.parametrize("n,n_instr", SIZES)
def test_rows_keep_their_order_within_a_bin(n, n_instr):
    regs = random_regs(n, n_instr, n + 3)
    perm = ts.regroup_reference(regs, n_instr).long()
    key = bins(regs, n_instr)[perm]
    same = key[1:] == key[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())


def test_the_twin_is_the_identity_on_a_lockstep_batch(adventure):
    eng, _ = adventure
    fresh = eng.make_batch(1000)
    n_instr = eng.tables.host.n_instr
    assert int(fresh.regs[:, C_PC].unique().numel()) == 1
    ident = torch.arange(1000, dtype=torch.int32)
    assert torch.equal(ts.regroup_reference(fresh.regs, n_instr), ident)
    fresh.regs[:, C_STATUS] = DONE
    assert torch.equal(ts.regroup_reference(fresh.regs, n_instr), ident)


def test_the_chunk_keeps_the_scan_small():
    for n, n_instr in [(1, 0), (1000, 100), (131_072, 100),
                       (131_072, 5000), (1 << 21, 7000)]:
        chunk = ts.regroup_chunk(n, n_instr)
        chunks = -(-n // chunk)
        assert chunk % ts.REGROUP_THREADS == 0
        assert chunk >= min(ts.REGROUP_CHUNK, -(-n // 256) * 256)
        assert (n_instr + 1) * chunks <= max(ts.REGROUP_COUNTS,
                                             n_instr + 1)
    assert ts.regroup_chunk(131_072, 100) == ts.REGROUP_CHUNK


# ---- the launch order ------------------------------------------------------

def test_the_shape_decides_the_regroup():
    """More than one wave of resident blocks regroups: the adventure cell
    (131,072 rows, 53 a block: 2,474 blocks) does; promotion's width-2048
    sibling of 1,024 rows at 5 a block (205 blocks) does not."""
    waves = ts.BLOCKS_PER_SM * H100_SMS
    assert ts.regroups(131_072, 53, H100_SMS)
    assert not ts.regroups(1024, 5, H100_SMS)
    assert not ts.regroups(waves * 53, 53, H100_SMS)
    assert ts.regroups(waves * 53 + 1, 53, H100_SMS)


def test_a_launch_over_one_wave_takes_the_regroups_order(adventure):
    eng, batch = adventure
    tile = ts.tile_plan(eng.tables, batch, ADVENTURE.tile).tile
    order = ts.launch_order(eng.tables, batch.regs, tile, sms=1)
    assert torch.equal(order, ts.regroup_reference(
        batch.regs, eng.tables.host.n_instr))
    assert ts.launch_order(eng.tables, batch.regs, tile,
                           sms=H100_SMS) is None


def test_the_regroup_gives_each_warp_one_start_pc(adventure):
    """The adventure's resumed rows at 8,192 (60 start pcs): in row order a
    warp's running rows start at about 21 pcs; in the regroup's order at
    one, and at two where a bin ends inside a warp."""
    eng, batch = adventure
    n_instr = eng.tables.host.n_instr
    tile = ts.tile_plan(eng.tables, batch, ADVENTURE.tile).tile
    warps, pcs = ts.warp_starts(batch.regs, n_instr, tile).tolist()
    g_warps, g_pcs = ts.warp_starts(
        batch.regs, n_instr, tile,
        ts.regroup_reference(batch.regs, n_instr)).tolist()
    n = batch.regs.shape[0]
    assert warps == g_warps == 2 * (n // tile) + -(-(n % tile) // 32)
    assert pcs / warps > 15
    starts = int(batch.regs[:, C_PC].unique().numel())
    assert g_pcs <= g_warps + starts - 1


def test_warp_starts_counts_distinct_running_pcs():
    """Two blocks of 40 slots (two warps each, the second of 8): the
    distinct pcs of each warp's RUNNING rows."""
    regs = torch.zeros((75, 4), dtype=torch.int32)
    regs[:, C_PC] = torch.arange(75) % 3
    regs[32:40, C_STATUS] = DONE            # block 0's second warp: idle
    regs[40:72, C_PC] = 7                   # block 1's first warp: one pc
    regs[72:75, C_STATUS] = PARKED          # block 1's second warp: idle
    assert ts.warp_starts(regs, 10, 40).tolist() == [2, 4]
    regs[72, C_STATUS] = RUNNING
    assert ts.warp_starts(regs, 10, 40).tolist() == [3, 5]
    assert ts.warp_starts(regs, 2, 40).tolist() == [2, 3]   # pc 2, 7 past


# ---- on a card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_tables(n_instr: int):
    return SimpleNamespace(host=SimpleNamespace(n_instr=n_instr), scratch={})


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_instr", SIZES + [(131_072, 100),
                                               (50_001, 3000), (3, 0)])
def test_the_kernel_equals_the_twin(n, n_instr, cuda):
    tables = card_tables(n_instr)
    for seed in range(3):                     # the scratch kept, reused
        regs = random_regs(n, n_instr, seed)
        got = ts.regroup(tables, regs.to(cuda)).cpu()
        assert torch.equal(got, ts.regroup_reference(regs, n_instr)), seed
    lock = regs.clone()
    lock[:, C_STATUS], lock[:, C_PC] = RUNNING, 0
    assert torch.equal(ts.regroup(tables, lock.to(cuda)).cpu(),
                       torch.arange(n, dtype=torch.int32))


def hold_in_regroup_order(monkeypatch, eng, batch, launches: int):
    """turbo_step with every launch regrouped (one SM, so any grid past
    two blocks is more than a wave) == turbo_step_reference after every
    launch."""
    monkeypatch.setattr(ts, "sm_count", lambda device: 1)
    k = eng.tcfg.k_steps
    kern = type(batch)(*(t.clone() for t in batch))
    with EVENTS.recording() as rec:
        for launch in range(launches):
            ts.turbo_step(eng.tables, kern, k, eng.tcfg.tile)
            ts.turbo_step_reference(eng.tables, batch, k)
            for name, a, b in zip(batch._fields, kern, batch):
                assert torch.equal(a, b), (launch, name)
    assert rec.counters["kernel.regroup"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(16))
def test_the_kernel_in_the_regroups_order_on_random_programs(
        idx, cuda, monkeypatch):
    from interpolation_engine_tpu_torch._shared import json5
    program = (tp.random_scalar_program(random.Random(7000 + idx))
               if idx < 8 else tp.random_program(random.Random(9000 + idx)))
    eng = TurboEngine(compile_src(json5.dumps(program, indent=2)),
                      TurboConfig(tile=16, width=64, out_width=64,
                                  k_steps=2), device=cuda)
    batch = eng.make_batch(200)
    gen = torch.Generator().manual_seed(idx)
    for key in ("i", "turn", "k2"):     # lanes take their own branches
        slot = eng.plan.slot_of.get(key)
        if slot is not None:
            batch.regs[:, eng.cols.sint(slot)] = torch.randint(
                0, 40, (200,), generator=gen, dtype=torch.int32).to(cuda)
    hold_in_regroup_order(monkeypatch, eng, batch, 6)


@pytest.mark.cuda
def test_the_kernel_in_the_regroups_order_on_resumed_adventures(
        cuda, monkeypatch):
    eng, batch = resumed_adventure(cuda, 4096)
    hold_in_regroup_order(monkeypatch, eng, batch, 4)


@pytest.mark.cuda
def test_a_small_batch_is_not_regrouped(cuda):
    """Under one wave of blocks on the card itself the launch keeps the row
    order: no regroup counted, and the kernel still equals the plain
    version."""
    eng, batch = resumed_adventure(cuda, 2048)
    assert not ts.regroups(2048, ts.launch_plan(
        eng.tables, batch, ADVENTURE.tile).tile, ts.sm_count(cuda))
    kern = type(batch)(*(t.clone() for t in batch))
    with EVENTS.recording() as rec:
        ts.turbo_step(eng.tables, kern, 32, ADVENTURE.tile)
    ts.turbo_step_reference(eng.tables, batch, 32)
    assert "kernel.regroup" not in rec.counters
    assert rec.counters["turbo.warps"] > 0
    for a, b in zip(kern, batch):
        assert torch.equal(a, b)
