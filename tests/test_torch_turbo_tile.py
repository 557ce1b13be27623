"""The step kernel's tile (``ops/turbo_step.py`` ``tile_plan``) and a
rehearsal of the kernel itself on the CPU.

The plan tests hold the layout to its rules: it fits a block's shared
memory, every region starts 16-byte aligned, register and meta rows take an
odd number of words, regions do not overlap, and a batch packed into the
layout and unpacked again comes back unchanged.

The rehearsal compiles ``csrc/turbo_step.cu`` with g++ under a small
header that defines the CUDA qualifiers away and the one asynchronous copy
as ``memcpy``, and runs the kernel's phases as the card would between its
barriers: for each block, the entry check for every thread, then stage-in
for every thread, then ``run``, then stage-out. Shared memory starts as
garbage and a guard past its end must stay untouched. The result must equal
``turbo_step_reference`` bit for bit after every launch.

A plan of at most 8 rows a tile steps each row with a warp (the plan's
``lanes``, ``row_lanes``). The header models a warp as 32 host threads
that the host schedules as they come: ``__syncwarp`` is a barrier of the
32 and a vote is that barrier with the lanes' predicates reduced, so a
missing barrier or a register written by many lanes at once shows as a
wrong step count or byte, over several seeds. Those plans also run with one
thread a row, the other instance of the same step.
"""

import ctypes
import dataclasses
import functools
import random
import shutil
import subprocess
from dataclasses import astuple, fields
from pathlib import Path

import pytest
import torch

import bench
import torch_programs as tp

from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm.turbo import (
    C_STATUS, DONE, PARKED, TurboConfig, TurboEngine)

CSRC = Path(ts.__file__).resolve().parent.parent / "csrc"

ADVENTURE = TurboConfig(width=128, out_width=128, k_steps=64, list_cap=12,
                        elem_width=32)
SHAPES = {
    "adventure": (bench.adventure_program(), ADVENTURE),
    "spine": (bench.BENCH_PROGRAM, TurboConfig(width=128, out_width=128,
                                               k_steps=64)),
    "adventure_w512": (bench.adventure_program(), TurboConfig(
        width=512, out_width=512, k_steps=64, list_cap=12,
        elem_width=128)),
    "list_literal": ("{default_state: {order_index: 1, inserts: {l: ['a'], "
                     "k: 7}}, order: [{cmd:'set', item:['x{l}', 'y', '{k}'],"
                     " output_name:'l'}, {cmd:'print', text:'v={l}'}], "
                     "named_tasks: {}, save_states: {}}", ADVENTURE),
    "adventure_w80": (bench.adventure_program(), TurboConfig(
        width=80, out_width=192, k_steps=8, list_cap=12, elem_width=32)),
    # promoted siblings: the bench's width-512 cell 4x (literals in device
    # memory), and the JAX promotion tests' 192-byte batch 4x
    "adventure_w2048": (bench.adventure_program(), TurboConfig(
        width=2048, out_width=2048, k_steps=64, list_cap=12,
        elem_width=512)),
    "promoted_w768": (tp.WIDE_VALUE, TurboConfig(
        tile=8, width=768, out_width=768, k_steps=24)),
}
# cards with less shared memory than the H100's (per SM, per block opt-in,
# reserved per block), from NVIDIA's CUDA programming guide
CARDS = {"sm80": ts.SharedMemory(167_936, 166_912, 1024),
         "sm86": ts.SharedMemory(102_400, 101_376, 1024),
         "sm75": ts.SharedMemory(65_536, 65_536, 0)}


def compile_src(src):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader)
    return compile_program(json5.loads(loader.add_line_numbers(src)))


def engine(name):
    src, tcfg = SHAPES[name]
    return TurboEngine(compile_src(src), tcfg, device="cpu")


def seeded(batch, seed=0):
    """A batch of the same shapes filled with seeded random bytes."""
    gen = torch.Generator().manual_seed(seed)
    return type(batch)(*(torch.randint(
        -128 if t.dtype == torch.int32 else 0, 127 if t.dtype == torch.int32
        else 256, t.shape, generator=gen).to(t.dtype) for t in batch))


# ---- the plan ----------------------------------------------------------------

def regions(plan) -> dict:
    """name -> (offset, bytes) of every region of the plan in use."""
    t = plan.tile
    spans = {"prog": (0, ts.PROG_BYTES),
             "flat": (plan.flat_off, plan.flat_bytes),
             "lits": (plan.lits_off, plan.lits_bytes),
             "idx": (plan.idx_off, 4 * t),
             "regs": (plan.regs_off, t * plan.regs_is),
             "meta": (plan.meta_off, plan.planes * plan.meta_ps),
             "sbuf": (plan.sbuf_off, plan.rows * plan.sbuf_ps),
             "out": (plan.out_off, t * plan.out_is),
             "scratch": (plan.scr_off, t * plan.scr_is),
             "buf": (plan.buf_off, t * plan.buf_is)}
    return {k: v for k, v in spans.items() if v[0] >= 0 and v[1] > 0}


def fits(plan, shared):
    """The plan's regions fit its shared bytes, and those a block."""
    per_instance = sum(size for key, (_, size) in regions(plan).items()
                       if key not in ("prog", "flat", "lits")) // plan.tile
    tables = plan.flat_bytes + (plan.lits_bytes if plan.lits_off >= 0
                                else 0)
    assert 1 <= plan.tile <= 128
    assert plan.tile * per_instance + tables + ts.PROG_BYTES <= plan.smem
    assert plan.smem <= shared.per_block


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tile_fits_a_block_with_the_tables(name):
    eng = engine(name)
    plan = ts.tile_plan(eng.tables, eng.make_batch(4))
    shared = ts.H100_SHARED
    fits(plan, shared)
    # two blocks share an SM, with their reserved kilobyte each
    assert 2 * (plan.smem + shared.reserved) <= shared.per_sm
    if name == "list_literal":
        assert eng.tables.host.scratch_bytes > 0 and plan.scr_is > 0
    else:
        assert plan.scr_is == 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tile_fits_a_smaller_card(name):
    """On a card with less shared memory the tile shrinks to fit it."""
    eng = engine(name)
    batch = eng.make_batch(4)
    shared = CARDS["sm86"]
    plan = ts.tile_plan(eng.tables, batch, shared=shared)
    fits(plan, shared)
    assert plan.tile < ts.tile_plan(eng.tables, batch).tile
    if 2 * (plan.smem + shared.reserved) > shared.per_sm:
        # one block an SM only when two tiles of one instance do not fit
        half = shared.per_sm // 2 - shared.reserved
        assert ts.tile_plan(eng.tables, batch, tile=1).smem > half


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_regions_are_aligned_padded_and_disjoint(name):
    eng = engine(name)
    plan = ts.tile_plan(eng.tables, eng.make_batch(4))
    spans = sorted(regions(plan).values())
    for off, size in spans:
        assert off % 16 == 0
    for (a, sa), (b, _) in zip(spans, spans[1:]):
        assert a + sa <= b
    assert spans[-1][0] + spans[-1][1] <= plan.smem
    # every row of every instance an odd number of words apart
    strides = [plan.regs_is, plan.meta_is, plan.sbuf_is, plan.out_is,
               plan.buf_is] + ([plan.scr_is] if plan.scr_is else [])
    for stride in strides:
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
    assert plan.sbuf_ps % 4 == 0 and plan.meta_ps % 4 == 0
    # one register column, meta cell or byte of 32 neighbouring instances:
    # 32 distinct banks of four bytes
    for off, stride in ((plan.regs_off, plan.regs_is),
                        (plan.meta_off, plan.meta_is),
                        (plan.sbuf_off + 3 * plan.sbuf_ps, plan.sbuf_is),
                        (plan.buf_off, plan.buf_is)):
        banks = {((off + t * stride + 21) // 4) % 32 for t in range(32)}
        assert len(banks) == 32 or plan.tile < 32


def test_plan_fields_are_the_kernels_tile_struct():
    """The wrapper passes ``astuple(plan)``; the kernel reads it as its
    ``Tile`` struct, whose fields are listed in this order."""
    src = (CSRC / "turbo_step.cu").read_text()
    body = src[src.index("struct Tile {"):]
    body = body[:body.index("};")]
    names = [w.strip(" ,;\n") for line in body.splitlines()[1:]
             for w in line.replace("int ", "").split(",") if w.strip(" ;")]
    assert names == [f.name for f in fields(ts.TilePlan)]
    assert f"TILE_FIELDS = {len(names)};" in src


def test_the_word_row_is_the_kernels():
    """``WORD_ROW``, the shortest padded row the kernel stages a word a
    lane (``staged_word_bytes`` counts by it), is the kernel's: four warp
    instructions of 32 words."""
    src = (CSRC / "turbo_step.cu").read_text()
    assert "constexpr int WORD_ROW = 4 * 4 * WARP;" in src
    assert ts.WORD_ROW == 4 * 4 * ts.WARP == 512


def test_tile_caps_and_large_literals_stay_in_device_memory():
    eng = engine("adventure")
    batch = eng.make_batch(4)
    assert ts.tile_plan(eng.tables, batch, tile=16).tile == 16
    assert ts.tile_plan(eng.tables, batch, tile=10_000).tile <= ts.MAX_TILE
    small = ts.tile_plan(eng.tables, batch, shared=CARDS["sm75"])
    assert small.tile < ts.tile_plan(eng.tables, batch).tile
    assert small.lits_off == -1        # an eighth of 32 KB is too little
    big = ts.StepTables(host=eng.tables.host, flat=eng.tables.flat,
                        lits=torch.zeros((200, 128), dtype=torch.uint8))
    plan = ts.tile_plan(big, batch)
    assert plan.lits_off == -1 and "lits" not in regions(plan)
    assert ts.tile_plan(eng.tables, batch).lits_off > 0


def test_one_instance_too_big_raises_naming_the_bytes():
    eng = engine("spine")
    batch = eng.make_batch(2)
    wide = type(batch)(batch.regs, torch.zeros((460, 2, 512),
                                               dtype=torch.uint8),
                       batch.out, batch.meta)
    with pytest.raises(ValueError, match=r"one instance needs \d+ bytes"):
        ts.tile_plan(eng.tables, wide)
    # the same rows fit one block alone when two do not share an SM
    half = type(batch)(batch.regs, torch.zeros((300, 2, 512),
                                               dtype=torch.uint8),
                       batch.out, batch.meta)
    assert ts.tile_plan(eng.tables, half).tile >= 1


def _regions(plan, batch):
    """(offset, instance stride, plane stride, the batch's rows as a
    (planes, n, bytes) uint8 view) of each staged region."""
    regs, sbuf, out, meta = batch
    return [(plan.regs_off, plan.regs_is, 0, regs.view(torch.uint8)[None]),
            (plan.meta_off, plan.meta_is, plan.meta_ps,
             meta.view(torch.uint8)),
            (plan.sbuf_off, plan.sbuf_is, plan.sbuf_ps, sbuf),
            (plan.out_off, plan.out_is, 0, out[None])]


def _at(off, istride, pstride, planes, cnt, size):
    """Where in shared memory the bytes of (planes, cnt, size) rows go."""
    return (off + torch.arange(planes)[:, None, None] * pstride
            + torch.arange(cnt)[None, :, None] * istride
            + torch.arange(size)[None, None, :]).reshape(-1)


def tile_rows(plan, n, b):
    """The batch rows of tile b in row order: slots b * T on."""
    return torch.arange(b * plan.tile, min((b + 1) * plan.tile, n))


def pack(plan, batch, rows, sm=None):
    """The tile whose slots hold the batch's ``rows`` in the plan's layout,
    at the offsets ``stage_in`` uses: written into sm, a (smem,) uint8
    tensor (zeros when None), which is returned."""
    if sm is None:
        sm = torch.zeros(plan.smem, dtype=torch.uint8)
    for off, istride, pstride, data in _regions(plan, batch):
        picked = data[:, rows]
        sm[_at(off, istride, pstride, *picked.shape)] = picked.reshape(-1)
    return sm


def unpack(plan, sm, batch, rows):
    """The reverse of ``pack``, into the batch's ``rows``."""
    for off, istride, pstride, data in _regions(plan, batch):
        planes, _, size = data.shape
        data[:, rows] = sm[_at(off, istride, pstride, planes, len(rows),
                               size)].reshape(planes, len(rows), size)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pack_and_unpack_return_the_batch(name):
    eng = engine(name)
    plan = ts.tile_plan(eng.tables, eng.make_batch(1), tile=16)
    n = 3 * plan.tile + 5           # a ragged last tile of 5
    batch = seeded(eng.make_batch(n), seed=len(name))
    back = type(batch)(*(torch.zeros_like(t) for t in batch))
    for b in range(-(-n // plan.tile)):
        rows = tile_rows(plan, n, b)
        unpack(plan, pack(plan, batch, rows), back, rows)
    for got, want in zip(back, batch):
        assert torch.equal(got, want)


# ---- the rehearsal -----------------------------------------------------------

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <atomic>
#include <chrono>
#include <climits>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
template <class T> static inline T min(T a, T b) { return b < a ? b : a; }
template <class T> static inline T max(T a, T b) { return a < b ? b : a; }
struct uint4 { unsigned x, y, z, w; };
static void copy_async(void* s, const void* g, int bytes) {
  memcpy(s, g, bytes);
}
static void copy_async_wait() {}

// A warp on the host: 32 threads, one a lane, scheduled by the host as they
// come. __syncwarp is a barrier of the 32; a vote is that barrier, the
// lanes' predicates reduced as the last lane arrives. A lane that waits
// spins a little, then sleeps on the barrier's phase (a futex), so that the
// lanes still to come get the cores. A barrier some lane never reaches (a group that diverged)
// is given up after 20 s: the warp is marked hung, every later barrier
// passes, and the launch fails.
struct HostWarp {
  std::atomic<int> arrived{0};
  std::atomic<unsigned> phase{0};
  std::atomic<bool> vote{false}, hung{false};
  bool result = false;

  unsigned* futex() { return reinterpret_cast<unsigned*>(&phase); }

  bool arrive(bool p) {
    if (hung.load()) return false;
    if (p) vote.store(true, std::memory_order_relaxed);
    const unsigned ph = phase.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) == 31) {
      result = vote.exchange(false, std::memory_order_relaxed);
      arrived.store(0, std::memory_order_relaxed);
      phase.store(ph + 1, std::memory_order_release);
      syscall(SYS_futex, futex(), FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
              nullptr, 0);
      return result;
    }
    for (int spin = 0; spin < 2000; ++spin)
      if (phase.load(std::memory_order_acquire) != ph) return result;
    const auto t0 = std::chrono::steady_clock::now();
    const timespec nap{0, 50 * 1000 * 1000};
    while (phase.load(std::memory_order_acquire) == ph) {
      syscall(SYS_futex, futex(), FUTEX_WAIT_PRIVATE, ph, &nap, nullptr, 0);
      if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(20)) {
        hung.store(true);
        phase.fetch_add(1);
        syscall(SYS_futex, futex(), FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
                nullptr, 0);
        return false;
      }
    }
    return result;
  }
};

struct Dim { unsigned x; };
static thread_local Dim threadIdx;
static thread_local HostWarp* this_warp;
static void __syncwarp(unsigned = 0xffffffffu) { this_warp->arrive(false); }
static bool __any_sync(unsigned, bool p) { return this_warp->arrive(p); }

#include "turbo_step.cu"

// Phase 2 of one block: the one-thread groups in turn, or each warp's 32
// lanes as 32 host threads, the block's warps one after another. False
// when a warp hung.
static bool run_block(const Args& a, int b, uint8_t* sm) {
  if (a.tl.lanes == 1) {
    for (int t = 0; t < MAX_TILE; ++t) run<1>(a, b, t, sm);
    return true;
  }
  HostWarp warp;
  std::vector<std::thread> lanes;
  for (int l = 0; l < WARP; ++l)
    lanes.emplace_back([&a, b, sm, &warp, l] {
      this_warp = &warp;
      for (int w = 0; w < MAX_TILE / WARP; ++w) {
        threadIdx.x = w * WARP + l;
        run<WARP>(a, b, w * WARP + l, sm);
      }
    });
  for (auto& th : lanes) th.join();
  return !warp.hung.load();
}

// The kernel's launch, block by block of MAX_TILE threads, tile slot s
// stepping row perm[s] (perm null: row s); in a block each phase runs for
// every thread before the next one starts, as the kernel's barriers order
// them.
// 0: done; -1: arguments refused; -2: a block wrote past its shared memory;
// -3: a warp's lanes missed one another's barrier.
extern "C" int rehearse(const int* flat, const uint8_t* lits, int* regs,
                        uint8_t* sbuf, uint8_t* out, int* meta,
                        const int* perm, int n, int regw, int width,
                        int out_width, int k_steps, const int* plan,
                        int plan_len) {
  if (n <= 0 || k_steps <= 0) return 0;
  Args a;
  if (!make_args(&a, flat, lits, regs, sbuf, out, meta, perm, n, regw,
                 width, out_width, k_steps, plan, plan_len))
    return -1;
  const int T = a.tl.tile, nt = MAX_TILE, guard = 64;
  const int size = a.tl.smem + guard;
  uint8_t* sm = (uint8_t*)aligned_alloc(16, (size + 15) / 16 * 16);
  int rc = 0;
  for (int b = 0; b * T < n && rc == 0; ++b) {
    memset(sm, 0xA5, size);
    bool any = false;
    for (int t = 0; t < nt; ++t) any = running_at_entry(a, b, t, sm) || any;
    if (!any) continue;
    for (int t = 0; t < nt; ++t) stage_in(a, b, t, nt, sm);
    if (!run_block(a, b, sm)) rc = -3;
    for (int t = 0; t < nt; ++t) stage_out(a, b, t, nt, sm);
    for (int j = a.tl.smem; j < size; ++j)
      if (sm[j] != 0xA5) rc = -2;
  }
  free(sm);
  return rc;
}

// The staging of tile b alone on `image`, `size` bytes of shared memory
// (the plan's and a guard past it), each thread in turn as the kernel's
// barriers order them: with `in`, every thread's entry check (which notes
// the tile's rows) and then its stage-in; else its stage-out. 0: done;
// -1: arguments refused.
extern "C" int stage_block(const int* flat, const uint8_t* lits, int* regs,
                           uint8_t* sbuf, uint8_t* out, int* meta,
                           const int* perm, int n, int regw, int width,
                           int out_width, const int* plan, int plan_len,
                           int b, uint8_t* image, int size, int in) {
  Args a;
  if (!make_args(&a, flat, lits, regs, sbuf, out, meta, perm, n, regw,
                 width, out_width, 1, plan, plan_len) ||
      size < a.tl.smem || b < 0 || b * a.tl.tile >= n)
    return -1;
  uint8_t* sm = (uint8_t*)aligned_alloc(16, (size + 15) / 16 * 16);
  memcpy(sm, image, size);
  if (in) {
    for (int t = 0; t < MAX_TILE; ++t) running_at_entry(a, b, t, sm);
    for (int t = 0; t < MAX_TILE; ++t) stage_in(a, b, t, MAX_TILE, sm);
  } else {
    for (int t = 0; t < MAX_TILE; ++t) stage_out(a, b, t, MAX_TILE, sm);
  }
  memcpy(image, sm, size);
  free(sm);
  return 0;
}
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("rehearsal")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "librehearsal.so"
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-fno-strict-aliasing", "-I", str(CSRC), "-o", str(so),
                    str(tmp / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rehearse.argtypes = [p] * 7 + [i] * 5 + [ctypes.POINTER(i), i]
    lib.rehearse.restype = i
    lib.stage_block.argtypes = [p] * 7 + [i] * 4 + [ctypes.POINTER(i)] + [
        i, i, p, i, i]
    lib.stage_block.restype = i
    return lib


def rehearse(lib, tables, batch, k, plan, perm=None):
    regs, sbuf, out, meta = batch
    vals = astuple(plan)
    rc = lib.rehearse(tables.flat.data_ptr(), tables.lits.data_ptr(),
                      regs.data_ptr(), sbuf.data_ptr(), out.data_ptr(),
                      meta.data_ptr(),
                      None if perm is None else perm.data_ptr(),
                      regs.shape[0], regs.shape[1],
                      sbuf.shape[2], out.shape[1], k,
                      (ctypes.c_int * len(vals))(*vals), len(vals))
    assert rc == 0


def spread(eng, batch, seed=0):
    """Give each instance its own loop counter, so lanes reach their
    branches at other rounds."""
    for key in ("i", "turn", "k2"):
        slot = eng.plan.slot_of.get(key)
        if slot is not None:
            gen = torch.Generator().manual_seed(seed)
            batch.regs[:, eng.cols.sint(slot)] = torch.randint(
                0, 40, (batch.regs.shape[0],), generator=gen,
                dtype=torch.int32)


def hold(lib, eng, batch, k, launches, plan, order=None):
    """The rehearsed kernel == the plain version after every launch; tile
    slot s steps row ``order(batch)[s]`` (taken before each launch), or
    row s without an order."""
    kern = type(batch)(*(t.clone() for t in batch))
    for launch in range(launches):
        perm = None if order is None else order(kern)
        rehearse(lib, eng.tables, kern, k, plan, perm)
        ts.turbo_step_reference(eng.tables, batch, k)
        for name, a, b in zip(batch._fields, kern, batch):
            assert torch.equal(a, b), (launch, name)
    return kern


PROGRAMS = dict(tp.AGREEING, **tp.LIST_AGREEING, spine=bench.BENCH_PROGRAM,
                interp=bench.INTERP_PROGRAM,
                ring=bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'"),
                inexact=tp.INEXACT_DIV, await_not_ready=tp.AWAIT_NOT_READY,
                adventure=bench.adventure_program(),
                race_io=bench.race_io_program(),
                midblock_race=tp.MIDBLOCK_PARK % {"mode": "race"},
                parked_freeze_par=tp.PARKED_FREEZE_PAR,
                spill_parallel=tp.SPILL_PARALLEL,
                list_literal=SHAPES["list_literal"][0])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_rehearsed_kernel_equals_plain(name, rehearsal):
    eng = TurboEngine(compile_src(PROGRAMS[name]),
                      TurboConfig(width=128, out_width=192, k_steps=8),
                      device="cpu")
    batch = eng.make_batch(37)
    spread(eng, batch)
    hold(rehearsal, eng, batch, 8, 4, ts.tile_plan(eng.tables, batch,
                                                   tile=16))


RAGGED = ["1", "T-1", "T+1", "3T+5"]


def ragged_case(n):
    eng = engine("adventure")
    plan = ts.tile_plan(eng.tables, eng.make_batch(1), tile=13)
    T = plan.tile
    rows = {"1": 1, "T-1": T - 1, "T+1": T + 1, "3T+5": 3 * T + 5}[n]
    batch = eng.make_batch(rows)
    spread(eng, batch, seed=rows)
    return eng, batch, 16, 3, plan


@pytest.mark.parametrize("n", RAGGED)
def test_rehearsed_ragged_tiles(n, rehearsal):
    hold(rehearsal, *ragged_case(n))


SHAPED = ["adventure_w512", "adventure_w80", "list_literal", "spine",
          "adventure_w2048", "promoted_w768"]


def shape_case(name):
    eng = engine(name)
    batch = eng.make_batch(50)
    spread(eng, batch)
    plan = ts.tile_plan(eng.tables, batch)
    assert (plan.lits_off < 0) == (name in ("adventure_w512",
                                            "adventure_w2048"))
    return eng, batch, 16, 3, plan


@pytest.mark.parametrize("name", SHAPED)
def test_rehearsed_shapes(name, rehearsal):
    """Width 512 (literals left in device memory), width 80 with 32-byte
    elements (row tails unused), a list literal's scratch row, the default
    tile, and the promoted siblings' widths 2048 (literals in device
    memory, 5 instances a block) and 768."""
    hold(rehearsal, *shape_case(name))


@pytest.mark.parametrize("width,size", [(768, 600), (2048, 1800)])
def test_rehearsed_promoted_rows(width, size, rehearsal):
    """A sibling batch as promotion builds it, with values of 600 bytes and
    more at width 768 and of 1,800 at 2048: printed, copied, and parked
    once the output outgrows the sibling's buffer; with its tile_plan."""
    eng = TurboEngine(compile_src(tp.PROMOTED_PRINT), TurboConfig(
        width=width, out_width=width, k_steps=16), device="cpu")
    plan = ts.tile_plan(eng.tables, tp.promoted_batch(eng, size, 1))
    batch = tp.promoted_batch(eng, size, 2 * plan.tile + 5)   # ragged
    kern = hold(rehearsal, eng, batch, 2, 3, plan)
    status = kern.regs[:, C_STATUS]
    assert bool((status == PARKED).all())
    out = eng.results(kern)[0].output
    assert out == "<" + "B" * size + ">"


@pytest.mark.parametrize("card", sorted(CARDS))
def test_rehearsed_smaller_cards(card, rehearsal):
    """The tiles of cards with less shared memory: fewer instances a block,
    and on the smallest the literals left in device memory."""
    eng = engine("adventure")
    batch = eng.make_batch(40)
    spread(eng, batch)
    plan = ts.tile_plan(eng.tables, batch, shared=CARDS[card])
    assert plan.tile < 40
    hold(rehearsal, eng, batch, 16, 3, plan)


def odd_widths_case():
    eng = TurboEngine(compile_src(bench.BENCH_PROGRAM), TurboConfig(
        width=50, out_width=70, k_steps=8), device="cpu")
    batch = eng.make_batch(30)
    spread(eng, batch)
    return eng, batch, 8, 3, ts.tile_plan(eng.tables, batch, tile=8)


def test_rehearsed_odd_widths_stage_bytes(rehearsal):
    """Widths that are no multiple of 4 stage byte by byte."""
    hold(rehearsal, *odd_widths_case())


def parked_and_done_case():
    """The first 32 rows PARKED and DONE with seeded garbage, the rest
    RUNNING from a fresh start, at 16 instances a block."""
    eng = engine("adventure")
    plan = ts.tile_plan(eng.tables, eng.make_batch(1), tile=16)
    batch = seeded(eng.make_batch(5 * 16), seed=3)
    batch.regs[:, C_STATUS] = 0
    batch.regs[:, 0] = 0                       # pc 0
    batch.regs[:32, C_STATUS] = torch.tensor([PARKED, DONE] * 16,
                                             dtype=torch.int32)
    fresh = eng.make_batch(5 * 16)
    for t, f in zip(batch, fresh):            # the running rows start clean
        if t.dim() == 2:
            t[32:] = f[32:]
        else:
            t[:, 32:] = f[:, 32:]
    return eng, batch, 8, 2, plan


def hold_parked_and_done(lib, kind=None):
    """The parked and done rows keep every byte, in any row order
    (``row_order``'s ``kind``, or row s in slot s)."""
    eng, batch, k, launches, plan = parked_and_done_case()
    before = type(batch)(*(t.clone() for t in batch))
    order = kind and row_order(kind, eng, batch.regs.shape[0])
    kern = hold(lib, eng, batch, k, launches, plan, order)
    assert torch.equal(kern.regs[:32], before.regs[:32])
    assert torch.equal(kern.sbuf[:, :32], before.sbuf[:, :32])


def test_rehearsed_parked_and_done_tiles_are_left_alone(rehearsal):
    """The first tiles hold no RUNNING instance: the kernel skips them and
    leaves every byte of them as it was."""
    hold_parked_and_done(rehearsal)


def random_program_case(idx):
    from interpolation_engine_tpu_torch._shared import json5
    program = (tp.random_scalar_program(random.Random(7000 + idx))
               if idx < 6 else tp.random_program(random.Random(9000 + idx)))
    eng = TurboEngine(compile_src(json5.dumps(program, indent=2)),
                      TurboConfig(width=64, out_width=64, k_steps=2),
                      device="cpu")
    batch = eng.make_batch(24)
    spread(eng, batch, seed=idx)
    return eng, batch, 2, 8, ts.tile_plan(eng.tables, batch, tile=7)


@pytest.mark.parametrize("idx", range(12))
def test_rehearsed_random_programs(idx, rehearsal):
    hold(rehearsal, *random_program_case(idx))


# ---- the staging alone -------------------------------------------------------

GUARD = 64


def stage_block(lib, tables, batch, perm, plan, b, image, stage_in):
    regs, sbuf, out, meta = batch
    vals = astuple(plan)
    rc = lib.stage_block(tables.flat.data_ptr(), tables.lits.data_ptr(),
                         regs.data_ptr(), sbuf.data_ptr(), out.data_ptr(),
                         meta.data_ptr(), perm.data_ptr(), regs.shape[0],
                         regs.shape[1], sbuf.shape[2], out.shape[1],
                         (ctypes.c_int * len(vals))(*vals), len(vals), b,
                         image.data_ptr(), image.numel(), int(stage_in))
    assert rc == 0


def staging_engine(name):
    if name == "odd_widths":
        return odd_widths_case()[0]
    return engine(name)


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("name", sorted(SHAPES) + ["odd_widths"])
def test_staging_moves_exactly_the_tiles_rows(name, n, rehearsal):
    """Stage-in and stage-out alone, tile by tile, at each shape's plan
    (and widths of 50 and 70 bytes, which stage byte by byte) over a
    ragged batch of seeded bytes whose tile slots step a seeded
    permutation of the rows. Stage-in on garbage leaves the Python
    layout's pack of the tile's rows, the tables and the row indices, and
    every other byte of the image (the pads between rows, the render rows,
    the guard past the plan's bytes) as it was. Stage-out of an image
    changed everywhere writes exactly the tile's rows of that image into
    the batch, no other byte of the batch, and no byte of the image."""
    eng = staging_engine(name)
    plan = ts.tile_plan(eng.tables, eng.make_batch(4))
    T = plan.tile
    rows = {"1": 1, "T-1": T - 1, "T+1": T + 1, "3T+5": 3 * T + 5}[n]
    assert rows > 0
    batch = seeded(eng.make_batch(rows), seed=rows)
    perm = torch.randperm(rows, generator=torch.Generator().manual_seed(
        rows)).to(torch.int32)
    gen = torch.Generator().manual_seed(T)
    tables = eng.tables
    for b in range(-(-rows // T)):
        slots = perm[b * T:(b + 1) * T].long()
        garbage = torch.randint(0, 256, (plan.smem + GUARD,), generator=gen,
                                dtype=torch.uint8)
        image = garbage.clone()
        stage_block(rehearsal, tables, batch, perm, plan, b, image, True)
        want = garbage.clone()
        want[plan.flat_off:plan.flat_off + plan.flat_bytes] = \
            tables.flat.view(torch.uint8)
        if plan.lits_off >= 0:
            want[plan.lits_off:plan.lits_off + plan.lits_bytes] = \
                tables.lits.reshape(-1)
        want[plan.idx_off:plan.idx_off + 4 * len(slots)] = \
            slots.to(torch.int32).view(torch.uint8)
        pack(plan, batch, slots, want)
        # the parsed program (host pointers here) at 0 is thread 0's
        assert torch.equal(image[ts.PROG_BYTES:], want[ts.PROG_BYTES:]), b
        changed = torch.randint(0, 256, image.shape, generator=gen,
                                dtype=torch.uint8)
        kept = plan.idx_off + 4 * T        # the program and the row indices
        changed[:kept] = image[:kept]
        sent = changed.clone()
        expected = type(batch)(*(t.clone() for t in batch))
        unpack(plan, changed, expected, slots)
        stage_block(rehearsal, tables, batch, perm, plan, b, changed, False)
        assert torch.equal(changed, sent), b
        for field, got, w in zip(batch._fields, batch, expected):
            assert torch.equal(got, w), (b, field)


# ---- the rehearsal through a row order ---------------------------------------

# the cases above, by name: (engine, batch, k, launches, plan)
CASES = dict(
    {f"random_{i}": functools.partial(random_program_case, i)
     for i in range(12)},
    **{f"ragged_{n}": functools.partial(ragged_case, n) for n in RAGGED},
    **{f"shape_{name}": functools.partial(shape_case, name)
       for name in SHAPED},
    odd_widths=odd_widths_case)
ORDERS = ["reversed", "random", "regroup"]


def row_order(kind, eng, n):
    """Before each launch, the slots' rows: the rows reversed, a seeded
    shuffle (both fixed), or the regroup's order of the batch as it then
    stands (``regroup_reference``, which the card's regroup equals bit for
    bit)."""
    if kind == "reversed":
        perm = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    elif kind == "random":
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(n))
        perm = perm.to(torch.int32)
    else:
        return lambda batch: ts.regroup_reference(batch.regs,
                                                  eng.tables.host.n_instr)
    return lambda batch: perm


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_rehearsed_through_a_row_order(case, order, rehearsal):
    """Each case above with tile slot s stepping row perm[s]: the rows
    reversed, shuffled, or in the regroup's order (RUNNING rows by pc, the
    parked and done last), which moves at every launch. Rows stay where
    they are in the batch, so after every launch the batch equals the
    plain version's."""
    eng, batch, k, launches, plan = CASES[case]()
    hold(rehearsal, eng, batch, k, launches, plan,
         row_order(order, eng, batch.regs.shape[0]))


@pytest.mark.parametrize("order", ORDERS)
def test_rehearsed_parked_and_done_through_a_row_order(order, rehearsal):
    """Parked and done rows among the running ones, in each order; in the
    regroup's they fill the last tiles, which the kernel skips."""
    hold_parked_and_done(rehearsal, order)


def test_the_regroup_order_puts_the_parked_and_done_tiles_last():
    eng, batch, *_, plan = parked_and_done_case()
    perm = ts.regroup_reference(batch.regs, eng.tables.host.n_instr)
    status = batch.regs[perm.long(), C_STATUS].view(-1, plan.tile)
    assert bool((status[:3] == 0).all())
    assert bool((status[3:] != 0).all())


# ---- the lane group: a warp a row where the tile has at most 8 rows -------

WARP_ROWS = ts.MAX_TILE // ts.WARP


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_plan_gives_a_warp_a_row_only_to_small_tiles(name):
    """``row_lanes``: a warp where T x 32 fits the block's 256 threads, one
    thread a row otherwise; the narrow shapes keep one thread a row."""
    eng = engine(name)
    plan = ts.tile_plan(eng.tables, eng.make_batch(4))
    assert plan.lanes == (ts.WARP if plan.tile <= WARP_ROWS else 1)
    assert plan.lanes == ts.row_lanes(plan.tile)
    if name in ("adventure", "spine", "adventure_w80", "list_literal"):
        assert plan.tile > WARP_ROWS and plan.lanes == 1


def test_row_lanes_turns_at_eight_rows():
    assert [ts.row_lanes(t) for t in (1, 3, 5, 8, 9, 53, 256)] == [
        32, 32, 32, 32, 1, 1, 1]


@pytest.mark.parametrize("lanes,tile", [(32, 9), (32, 13), (16, 4), (0, 4),
                                        (2, 1)])
def test_the_kernel_refuses_a_lane_group_that_does_not_fit(lanes, tile,
                                                           rehearsal):
    """The launch's argument check, shared by the card's launch (there
    ``cudaErrorInvalidValue``): a warp a row for more than 8 rows a tile,
    or a group neither one thread nor a warp."""
    eng = engine("adventure")
    batch = eng.make_batch(20)
    plan = dataclasses.replace(ts.tile_plan(eng.tables, batch, tile=tile),
                               lanes=lanes)
    before = type(batch)(*(t.clone() for t in batch))
    vals = astuple(plan)
    regs, sbuf, out, meta = batch
    rc = rehearsal.rehearse(eng.tables.flat.data_ptr(),
                            eng.tables.lits.data_ptr(), regs.data_ptr(),
                            sbuf.data_ptr(), out.data_ptr(), meta.data_ptr(),
                            None, regs.shape[0], regs.shape[1],
                            sbuf.shape[2], out.shape[1], 4,
                            (ctypes.c_int * len(vals))(*vals), len(vals))
    assert rc == -1
    for a, b in zip(batch, before):
        assert torch.equal(a, b)


def prompt_chain_case(seed):
    """A few hundred rows of the ``prompt-chain`` cell (2048-byte slots,
    T = 3, the literals in device memory), resumed from the traffic's
    states drawn from the seed."""
    from portbench import run
    from interpolation_engine_tpu_torch._shared import planner
    from interpolation_engine_tpu_torch.vm.turbo import base_config
    traffic = run.load_cell("prompt-chain")["traffic"]
    text = run.program_text(traffic)
    plan = planner.plan_turbo(compile_src(text))
    eng = TurboEngine(plan.compiled, base_config(plan), device="cpu",
                      plan=plan)
    states = run.start_states(traffic, text, 2**31 + seed)
    picks = random.Random(seed).sample(states, 240)
    batch = eng.load_batch(picks)
    plan = ts.tile_plan(eng.tables, batch, eng.tcfg.tile)
    assert (plan.tile, plan.lanes, plan.lits_off) == (3, ts.WARP, -1)
    return eng, batch, 8, 2, plan


WARP_SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", WARP_SEEDS)
@pytest.mark.parametrize("name", ["adventure_w2048", "promoted_w768",
                                  "prompt_chain"])
def test_rehearsed_warp_a_row(name, seed, rehearsal):
    """The wide shapes through the warp path at their configurations'
    tiles (the width-2048 sibling, T = 5; ``promoted_w768``, tile 8; the
    ``prompt-chain`` cell, T = 3), each over several seeds (the rows' loop
    counters, or the prompt-chain states drawn): equal to the plain version
    after every launch, the guard untouched."""
    if name == "prompt_chain":
        case = prompt_chain_case(seed)
    else:
        eng = engine(name)
        batch = eng.make_batch(50)
        spread(eng, batch, seed=seed)
        case = (eng, batch, 16, 3, ts.tile_plan(eng.tables, batch,
                                                eng.tcfg.tile))
    assert case[-1].lanes == ts.WARP
    hold(rehearsal, *case)


# the cases above whose plan steps a row with a warp
WARP_CASES = sorted(name for name in CASES
                    if name.startswith("random_") or name in (
                        "shape_adventure_w2048", "odd_widths"))


@pytest.mark.parametrize("case", WARP_CASES)
def test_rehearsed_one_thread_a_row_at_small_tiles(case, rehearsal):
    """The cases whose tiles have at most 8 rows, with the plan's lane
    group set to one thread: the G = 1 instance of the same step, which
    the card runs at larger tiles, holds at these shapes too."""
    eng, batch, k, launches, plan = CASES[case]()
    assert plan.lanes == ts.WARP
    hold(rehearsal, eng, batch, k, launches,
         dataclasses.replace(plan, lanes=1))
