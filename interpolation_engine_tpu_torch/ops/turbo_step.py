"""The turbo VM step: the CUDA kernel's wrapper and its plain PyTorch version.

``turbo_step`` runs up to ``k_steps`` VM steps on every RUNNING instance of
a batch, in place. On CUDA tensors it launches ``csrc/turbo_step.cu`` (built
by ``ops/build.py``) or raises; on CPU tensors, and only there, it runs
``turbo_step_reference``. The reference is batched torch over the whole
``[N, ...]`` state and works on any device, so it can also be held against
the kernel on the card. The two agree bit for bit after every launch.

Both give each lane its own pc: at every one of the K inner steps each
RUNNING lane executes the instruction at its pc. (The TPU kernel ran the
lowest live pc per step instead, so its state after one launch differs; the
two agree when an instance is DONE or at the same park.)

A list write rewrites the out slot's element cells exactly as follows, in
both versions, so that they agree bit for bit: cells past the new count are
zero, and a cell's bytes past its element's length are zero (an int element
has length 0 and zero bytes). Cells are meta entries (etype, eint, elen)
plus ``elem_width`` bytes at ``_Cols.elem_pos``; the bytes a byte row holds
past its last cell are never written. (The TPU kernel left stale cells past
the count instead; no step reads them, so results agree.)

A park inside a parallel block suspends the current thread lane (the lane
yield of the TPU kernel): its state becomes WAIT and its saved pc the
parked pc. The host ring decides which lane runs next.

The kernel runs one block per tile of instances, staged in shared memory;
``tile_plan`` sizes the tile and lays it out for the card's shared memory,
and the wrapper hands the plan to the kernel (``launch_plan``: built once
per shape and kept with the tables). A tile is T consecutive slots of the
launch's row order: on a launch of more than one wave of blocks the
wrapper first groups the rows by pc on the card (``regroup``,
``csrc/regroup.cu``), so that a warp's rows start at one instruction;
otherwise slot s is row s (``launch_order``). Rows never move in the batch.

A kernel launch counts as ``kernel.turbo_step`` or ``kernel.regroup``, and
a call of a plain version as ``plain.turbo_step`` or ``plain.regroup``, in
``EVENTS`` (``core/events.py``); a sharded call is its shards' launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass, field
from functools import cached_property
from typing import Optional

import torch

from ..core.events import EVENTS
from ..vm import turbo_tables as tt
from ..vm.config import (DONE, PARKED, PM_DRAIN, PM_NONE, PM_WAIT, RUNNING,
                         T_DONE, T_FREE, T_NEW, T_READY, T_WAIT)
from ..vm.state import T_EMPTY, T_INT, T_LIST, T_STR
from ..vm.syncs import host_sync

# the fixed control columns of a register row (csrc/turbo_step.cu has the
# same); vm/turbo.py's _Cols lays out every column after C_BASE.
# C_CLREPOCH counts in-kernel ``clear``s: the host-side output spill
# (_out_prefix) is tagged with the epoch it was drained at, so a later
# device-side clear erases it (decode ignores a stale-epoch prefix)
C_PC, C_STATUS, C_STEPS, C_OUTLEN = 0, 1, 2, 3
C_CURTID, C_PARMODE, C_PARJOIN, C_PAREPOCH, C_CLREPOCH, C_BASE = \
    4, 5, 6, 7, 8, 9
MAX_WIDTH = 2048         # csrc/turbo_step.cu MAX_W
MAX_TILE = 256           # csrc/turbo_step.cu MAX_TILE: threads per block
WARP = 32                # csrc/turbo_step.cu WARP: the wide lane group
PROG_BYTES = 256         # csrc/turbo_step.cu PROG_BYTES: the parsed program
ROW_PAD = 4              # bytes past a byte row's 16-byte round-up
WORD_ROW = 512           # csrc/turbo_step.cu WORD_ROW: the shortest padded
                         # row the kernel stages a word a lane, a warp a row
BLOCKS_PER_SM = 2        # the tile is sized for this many blocks an SM
REGROUP_THREADS = 256    # csrc/regroup.cu THREADS: a chunk's block
REGROUP_CHUNK = 1024     # rows a chunk of the regroup, at least
REGROUP_COUNTS = 65_536  # the most bin counts its one-block scan takes
_POW10 = [10 ** k for k in range(10)]


@dataclass
class StepTables:
    """A plan's tables on one device: ``flat`` and ``lits`` for the kernel
    and the plain version's data, ``host`` (numpy) for the plain version's
    control flow."""
    host: tt.TurboTables
    flat: torch.Tensor   # int32
    lits: torch.Tensor   # (L, W) uint8
    # launch_plan's plans, by the batch's shapes and the tile cap
    plans: dict = field(default_factory=dict, repr=False, compare=False)
    # regroup's scratch (RegroupScratch), by rows and stream
    scratch: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def on(cls, host: tt.TurboTables, device) -> "StepTables":
        return cls(host=host,
                   flat=torch.from_numpy(host.flat()).to(device),
                   lits=torch.from_numpy(host.lits).to(device))


def _check(tables: StepTables, batch) -> None:
    regs, sbuf, out, meta = batch
    dev = regs.device
    for name, t, dtype, dim in (("regs", regs, torch.int32, 2),
                                ("sbuf", sbuf, torch.uint8, 3),
                                ("out", out, torch.uint8, 2),
                                ("meta", meta, torch.int32, 3)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"{name}: want {dtype} {dim}-d on {dev}, got "
                             f"{t.dtype} {t.dim()}-d on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n = regs.shape[0]
    if sbuf.shape[1] != n or out.shape[0] != n or meta.shape[1] != n:
        raise ValueError(f"row counts differ: regs {n}, sbuf "
                         f"{sbuf.shape[1]}, out {out.shape[0]}, meta "
                         f"{meta.shape[1]}")
    host = tables.host
    if sbuf.shape[2] != host.width:
        raise ValueError(f"sbuf width {sbuf.shape[2]} != tables' "
                         f"{host.width}")
    if tuple(meta.shape[::2]) != (host.n_lists, 3 * host.list_cap):
        raise ValueError(f"meta {tuple(meta.shape)}: want "
                         f"({host.n_lists}, N, {3 * host.list_cap})")
    if host.slots.size:
        if int(host.slots[:, 1:4].max()) >= regs.shape[1]:
            raise ValueError("register row narrower than the slot columns")
        if int(host.slots[:, 4].max()) >= sbuf.shape[0]:
            raise ValueError("fewer string rows than the plan's slots")
        lists = host.slots[host.slots[:, 5] >= 0]
        last = lists[:, 6] + (host.list_cap - 1) // host.pack
        if last.size and int(last.max()) >= sbuf.shape[0]:
            raise ValueError("fewer element rows than the plan's lists")
    if C_BASE + 3 * host.n_threads > regs.shape[1]:
        raise ValueError("register row narrower than the lane columns")
    if tables.flat.device != dev or tables.lits.device != dev:
        raise ValueError(f"tables on {tables.flat.device}, batch on {dev}")


@dataclass(frozen=True)
class SharedMemory:
    """A card's shared memory, in bytes: on each SM, the most one block may
    take (the opt-in), and what stays reserved for each resident block."""
    per_sm: int
    per_block: int
    reserved: int


# NVIDIA H100 (sm_90): 228 KB on each SM, of which one block may take 227 KB
H100_SHARED = SharedMemory(per_sm=233_472, per_block=232_448, reserved=1024)


def shared_memory(device) -> SharedMemory:
    """CUDA ``device``'s shared memory (``cudaDeviceGetAttribute``)."""
    from .build import call
    vals = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        call("turbo_shared_memory", vals)
    return SharedMemory(*vals)


@dataclass(frozen=True)
class TilePlan:
    """Where one block's tile of ``tile`` instances lives in dynamic shared
    memory, in bytes: the kernel's ``Tile`` (``csrc/turbo_step.cu``), field
    for field and in this order. The parsed program takes the first
    ``PROG_BYTES``; ``*_off`` is a region's offset, ``*_is`` the stride
    from one instance to the next, ``*_ps`` from one meta plane or sbuf row
    to the next (row r of instance t of the sbuf region is at
    ``sbuf_off + r * sbuf_ps + t * sbuf_is``). ``lits_off`` is -1 when the
    literals stay in device memory. ``idx_off`` holds the batch row of each
    of the tile's slots (T int32). ``rows``, ``planes`` and ``cells`` are
    the batch's R, M and 3E. ``lanes`` is the lane group that steps each
    row, ``row_lanes(tile)``: 1 thread, or a warp."""
    tile: int
    smem: int
    flat_off: int
    flat_bytes: int
    lits_off: int
    lits_bytes: int
    idx_off: int
    regs_off: int
    regs_is: int
    meta_off: int
    meta_is: int
    meta_ps: int
    sbuf_off: int
    sbuf_is: int
    sbuf_ps: int
    out_off: int
    out_is: int
    scr_off: int
    scr_is: int
    buf_off: int
    buf_is: int
    rows: int
    planes: int
    cells: int
    lanes: int

    @cached_property
    def c_fields(self):
        """The fields, in order, as the C array of ints the launch takes."""
        vals = astuple(self)
        return (ctypes.c_int * len(vals))(*vals)


def _r16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@dataclass(frozen=True)
class TileShape:
    """What one launch puts in a block's shared memory: the program
    tables' bytes (``flat``, the literals, a list literal's scratch row)
    and the batch's row shapes (regs (N, regw), sbuf (rows, N, width), out
    (N, out_width), meta (planes, N, cells))."""
    flat_bytes: int
    lits_bytes: int
    scratch_bytes: int
    regw: int
    rows: int
    width: int
    out_width: int
    planes: int
    cells: int

    @classmethod
    def of(cls, tables: StepTables, shapes) -> "TileShape":
        """From a plan's step tables and a batch's (regs, sbuf, out, meta)
        shapes."""
        (_, regw), (rows, _, width), (_, out_width), (planes, _, cells) = \
            shapes
        return cls(4 * tables.flat.numel(), tables.lits.numel(),
                   tables.host.scratch_bytes, regw, rows, width, out_width,
                   planes, cells)


def _strides(shape: TileShape):
    """One instance's bytes in each region (tile_plan's layout): the
    register row and a meta plane's row take an odd number of words; a
    byte row (string, output, scratch, render) its bytes rounded up to 16
    plus ``ROW_PAD``. Returns (regs, meta, sbuf, out, scr, buf)."""
    def odd_words(n):
        return 4 * (n | 1)

    def byte_row(n):
        return _r16(n) + ROW_PAD if n else 0
    return (odd_words(shape.regw), odd_words(shape.cells),
            byte_row(shape.width), byte_row(shape.out_width),
            byte_row(shape.scratch_bytes), byte_row(shape.width))


def instance_bytes(shape: TileShape) -> int:
    """Shared-memory bytes one instance takes in a tile: its rows and its
    row index."""
    regs, meta, sbuf, out, scr, buf = _strides(shape)
    return (4 + regs + shape.planes * meta + shape.rows * sbuf + out + scr
            + buf)


def _layout(shape: TileShape, t: int, lits_shared: bool):
    """The regions' offsets for a tile of t instances, and its bytes."""
    regs, meta, sbuf, out, scr, buf = _strides(shape)
    off = {}
    at = PROG_BYTES
    for name, size in (("flat", shape.flat_bytes),
                       ("lits", shape.lits_bytes if lits_shared else 0),
                       ("idx", 4 * t), ("regs", t * regs),
                       ("meta", shape.planes * t * meta),
                       ("sbuf", shape.rows * t * sbuf), ("out", t * out),
                       ("scr", t * scr), ("buf", t * buf)):
        off[name] = at
        at += _r16(size)
    return off, at


def _fit(shape: TileShape, tile: int, shared: SharedMemory):
    """(T, literals staged): the most instances, up to ``tile`` and
    ``MAX_TILE``, that fit a block's share when ``BLOCKS_PER_SM`` blocks
    share an SM (fewer blocks when not even one instance fits); T is 0 when
    one instance fits in no block."""
    per_instance = instance_bytes(shape)
    for bps in range(BLOCKS_PER_SM, 0, -1):
        budget = min(shared.per_block, shared.per_sm // bps - shared.reserved)
        lits_shared = 8 * _r16(shape.lits_bytes) <= budget
        fixed = _layout(shape, 0, lits_shared)[1]
        t = min(tile, MAX_TILE, max(budget - fixed, 0) // per_instance)
        while t > 0 and _layout(shape, t, lits_shared)[1] > budget:
            t -= 1
        if t > 0:
            return t, lits_shared
    return 0, False


def row_lanes(tile: int) -> int:
    """The lane group that steps each row of a tile of ``tile`` rows: a
    warp (``WARP`` lanes) where the tile's warps fit the block's
    ``MAX_TILE`` threads, else one thread. Wide rows make small tiles, and
    there a warp copies and scans a row's kilobytes 32 lanes wide; a tile of
    more rows keeps one thread a row."""
    return WARP if tile * WARP <= MAX_TILE else 1


def fits_one_instance(shape: TileShape, shared: SharedMemory) -> bool:
    """Whether the step kernel can launch a batch of ``shape`` on a card
    with ``shared`` memory: one instance fits in a block beside the
    tables."""
    return _fit(shape, 1, shared)[0] > 0


def tile_plan(tables: StepTables, batch, tile: int = 128,
              shared: SharedMemory = H100_SHARED) -> TilePlan:
    """The kernel's tile on a card with ``shared`` memory: T instances per
    block (at most ``tile`` and ``MAX_TILE``), as many as fit in a block's
    share when ``BLOCKS_PER_SM`` blocks share an SM (fewer blocks when not
    even one instance fits), the layout of the program tables and of the
    tile's state in it, and the lane group of each row (``row_lanes``).

    Each region starts 16-byte aligned. Per instance, the register row and
    each meta plane take an odd number of words, so that the 32 threads of
    a warp reading one column hit 32 distinct banks; a byte row (string,
    output, scratch and render rows) takes its bytes rounded up to 16 plus
    ``ROW_PAD``, 4, an odd number of words too, so the kernel's byte loops
    hit distinct banks, and rows are copied by words instead of 16-byte
    units. On an H100 that ran a little faster than a pad of 16 (16-byte
    rows, 4-way conflicts on byte loops) and far faster than a pad of 0
    (32-way conflicts), and two blocks an SM faster than one or three.
    The literals are staged when they take at most an eighth of the
    block's budget; else they stay in device memory. Raises ValueError
    when one instance does not fit beside the tables."""
    shape = TileShape.of(tables, [t.shape for t in batch])
    t, lits_shared = _fit(shape, tile, shared)
    if t == 0:
        raise ValueError(
            f"one instance needs {instance_bytes(shape)} bytes of shared "
            f"memory beside {_layout(shape, 0, False)[1]} bytes of tables; "
            f"a block has {shared.per_block}")
    off, total = _layout(shape, t, lits_shared)
    regs_is, meta_is, sbuf_is, out_is, scr_is, buf_is = _strides(shape)
    return TilePlan(
        tile=t, smem=total, flat_off=off["flat"],
        flat_bytes=shape.flat_bytes,
        lits_off=off["lits"] if lits_shared else -1,
        lits_bytes=shape.lits_bytes, idx_off=off["idx"],
        regs_off=off["regs"], regs_is=regs_is,
        meta_off=off["meta"], meta_is=meta_is, meta_ps=t * meta_is,
        sbuf_off=off["sbuf"], sbuf_is=sbuf_is, sbuf_ps=t * sbuf_is,
        out_off=off["out"], out_is=out_is, scr_off=off["scr"], scr_is=scr_is,
        buf_off=off["buf"], buf_is=buf_is, rows=shape.rows,
        planes=shape.planes, cells=shape.cells, lanes=row_lanes(t))


def launch_plan(tables: StepTables, batch, tile: int = 128) -> TilePlan:
    """The plan ``turbo_step`` launches ``batch`` with on its card:
    ``tile_plan`` for the card's shared memory, made once for each shape of
    batch and kept with ``tables`` (which live on that card). Each plan
    made is counted: ``turbo.tile_rows`` its T, ``turbo.lits_in_device`` 1
    where the literals stay in device memory."""
    regs, sbuf, out, meta = batch
    key = (tuple(regs.shape), tuple(sbuf.shape), out.shape[1],
           tuple(meta.shape), tile)
    plan = tables.plans.get(key)
    if plan is None:
        plan = tables.plans[key] = tile_plan(
            tables, batch, tile, shared_memory(regs.device))
        EVENTS.count("turbo.tile_rows", plan.tile)
        EVENTS.count("turbo.lits_in_device", int(plan.lits_off < 0))
    return plan


def _state_regions(plan: TilePlan, batch):
    """The regions of a row that a launch stages, as kernel A's
    ``stage_state`` copies them: (bytes a row, planes, shared stride from
    one instance to the next, shared stride from one plane to the next)
    for the registers, the meta planes, the string rows and the output."""
    regs, sbuf, out, _ = batch
    return ((4 * regs.shape[1], 1, plan.regs_is, 0),
            (4 * plan.cells, plan.planes, plan.meta_is, plan.meta_ps),
            (sbuf.shape[2], plan.rows, plan.sbuf_is, plan.sbuf_ps),
            (out.shape[1], 1, plan.out_is, 0))


def staged_bytes(plan: TilePlan, batch) -> int:
    """The batch bytes a launch of ``plan`` stages in and back out, by
    host arithmetic from the shapes: each row's registers, meta planes,
    string rows and output, twice (a tile none of whose rows runs stages
    nothing; this counts it all the same)."""
    return 2 * batch.regs.shape[0] * sum(
        size * planes for size, planes, _, _ in _state_regions(plan, batch))


def staged_word_bytes(plan: TilePlan, batch) -> int:
    """The part of ``staged_bytes`` that kernel A moves a word a lane, a
    warp a row (``stage_words``): the regions whose rows are whole words,
    at least ``WORD_ROW`` bytes, and 4-byte but not 16-byte aligned in
    shared memory (the padded rows of ``tile_plan``'s layout)."""
    return 2 * batch.regs.shape[0] * sum(
        size * planes
        for size, planes, istride, pstride in _state_regions(plan, batch)
        if size % 4 == 0 and size >= WORD_ROW
        and (istride | pstride) % 4 == 0 and (istride | pstride) % 16)


@functools.cache
def sm_count(device) -> int:
    """CUDA ``device``'s SMs."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def regroups(n: int, tile: int, sms: int) -> bool:
    """Whether a launch of n rows at ``tile`` instances a block regroups
    its rows: when its grid is more than one wave of resident blocks
    (``BLOCKS_PER_SM`` on each of ``sms`` SMs). In one wave every block
    runs at once and the regroup's few microseconds are not won back."""
    return -(-n // tile) > BLOCKS_PER_SM * sms


def _regroup_key(regs: torch.Tensor, n_instr: int) -> torch.Tensor:
    """Each row's bin: its pc when RUNNING at a pc in [0, n_instr), else
    n_instr."""
    pc = regs[:, C_PC]
    live = (regs[:, C_STATUS] == RUNNING) & (pc >= 0) & (pc < n_instr)
    return pc.masked_fill(~live, n_instr)


def regroup_reference(regs: torch.Tensor, n_instr: int) -> torch.Tensor:
    """The plain version of ``csrc/regroup.cu``: the rows of ``regs``
    (N, REGW) int32 as an int32 permutation, RUNNING rows binned by pc in
    pc order, then every other row (and a RUNNING row at a pc past the
    program), each bin in row order: a stable sort by the bin."""
    EVENTS.count("plain.regroup")
    key = _regroup_key(regs, n_instr)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def regroup_chunk(n: int, n_instr: int) -> int:
    """Rows a block of the regroup takes: ``REGROUP_CHUNK``, or more where
    the bins (n_instr + 1) times the chunks would pass ``REGROUP_COUNTS``,
    in whole rounds of ``REGROUP_THREADS``."""
    chunks = max(1, min(-(-n // REGROUP_CHUNK),
                        REGROUP_COUNTS // (n_instr + 1)))
    rows = -(-n // chunks)
    return -(-rows // REGROUP_THREADS) * REGROUP_THREADS


@dataclass
class RegroupScratch:
    """What ``regroup`` writes on the card for a batch of one shape, made
    once: the rows' bins, the chunks' bin counts and the permutation."""
    chunk: int
    keys: torch.Tensor
    counts: torch.Tensor
    perm: torch.Tensor


def regroup(tables: StepTables, regs: torch.Tensor) -> torch.Tensor:
    """``regroup_reference``'s permutation of the rows of ``regs``: on the
    card by ``csrc/regroup.cu`` on the current stream, with no host sync,
    into a tensor kept with ``tables`` that the next regroup of that shape
    on that stream overwrites; on the CPU by the plain version."""
    n_instr = tables.host.n_instr
    if regs.device.type != "cuda":
        return regroup_reference(regs, n_instr)
    from .build import launch
    n = regs.shape[0]
    stream = torch.cuda.current_stream(regs.device).cuda_stream
    scr = tables.scratch.get((n, stream))
    if scr is None:
        chunk = regroup_chunk(n, n_instr)
        counts = (n_instr + 1) * -(-n // chunk)

        def ints(k):
            return torch.empty(k, dtype=torch.int32, device=regs.device)
        scr = tables.scratch[(n, stream)] = RegroupScratch(
            chunk, ints(n), ints(counts), ints(n))
    launch("regroup", regs.data_ptr(), n, regs.shape[1], n_instr, scr.chunk,
           scr.keys.data_ptr(), scr.counts.data_ptr(), scr.perm.data_ptr(),
           stream)
    return scr.perm


def warp_starts(regs: torch.Tensor, n_instr: int, tile: int,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(running warps, the sum over them of their distinct start pcs) of a
    launch of ``regs`` at ``tile`` instances a block, slot s stepping row
    ``order[s]`` (row s without an order), on the device: a warp is 32
    consecutive slots of a block, running when one of its rows is."""
    key = _regroup_key(regs, n_instr)
    if order is not None:
        key = key[order.long()]
    n = key.shape[0]
    blocks, lanes = -(-n // tile), -(-tile // 32) * 32
    slot = torch.arange(n, device=key.device)
    grid = torch.full((blocks, lanes), n_instr, dtype=key.dtype,
                      device=key.device)
    grid[slot // tile, slot % tile] = key
    warps = grid.view(-1, 32)
    run = warps < n_instr
    lower = torch.ones(32, 32, dtype=torch.bool,
                       device=key.device).tril(-1)
    seen = ((warps[:, :, None] == warps[:, None, :]) & lower).any(dim=2)
    return torch.stack([run.any(dim=1).sum(), (run & ~seen).sum()])


def launch_order(tables: StepTables, regs: torch.Tensor, tile: int,
                 sms: int) -> Optional[torch.Tensor]:
    """The row order of a launch over ``regs`` at ``tile`` instances a
    block on a card of ``sms`` SMs: ``regroup``'s permutation where
    ``regroups`` says so, else None (slot s
    steps row s). While ``EVENTS`` records, and only then, it also reads
    back ``warp_starts`` of that order (through ``host_sync``) into the
    counters ``turbo.warps`` and ``turbo.warp_pcs``."""
    order = None
    if regroups(regs.shape[0], tile, sms):
        order = regroup(tables, regs)
    if EVENTS.recorded is not None:
        warps, pcs = host_sync(warp_starts(regs, tables.host.n_instr, tile,
                                           order).tolist)
        EVENTS.count("turbo.warps", warps)
        EVENTS.count("turbo.warp_pcs", pcs)
    return order


def count_launch(plan: TilePlan, batch) -> None:
    """A launch's counters, host arithmetic with no sync:
    ``turbo.warp_row_launches`` once where a warp steps each row of the
    plan; while recording, ``turbo.staged_bytes`` and
    ``turbo.staged_word_bytes``."""
    if plan.lanes > 1:
        EVENTS.count("turbo.warp_row_launches")
    if EVENTS.recorded is not None:
        EVENTS.count("turbo.staged_bytes", staged_bytes(plan, batch))
        EVENTS.count("turbo.staged_word_bytes",
                     staged_word_bytes(plan, batch))


def turbo_step(tables: StepTables, batch, k_steps: int, tile: int = 128):
    """``k_steps`` VM steps on every RUNNING lane of ``batch`` (a
    ``TurboBatch`` of regs (N, REGW) int32, sbuf (R, N, W) uint8, out
    (N, OW) uint8, meta (M, N, 3E) int32), in place; returns ``batch``.
    On the card, one kernel a launch, one block per tile of ``launch_plan``
    (at most ``tile`` instances a block, each stepped by the plan's lane
    group), in ``launch_order``; counted by ``count_launch``."""
    _check(tables, batch)
    regs, sbuf, out, meta = batch
    if regs.device.type == "cpu":
        return turbo_step_reference(tables, batch, k_steps)
    if regs.device.type != "cuda":
        raise ValueError(f"no turbo step for device {regs.device}")
    if sbuf.shape[2] > MAX_WIDTH:
        raise ValueError(f"width {sbuf.shape[2]} > kernel maximum "
                         f"{MAX_WIDTH}")
    from .build import launch
    with torch.cuda.device(regs.device):
        plan = launch_plan(tables, batch, tile)
        order = launch_order(tables, regs, plan.tile, sm_count(regs.device))
        count_launch(plan, batch)
        launch("turbo_step", tables.flat.data_ptr(), tables.lits.data_ptr(),
               regs.data_ptr(), sbuf.data_ptr(), out.data_ptr(),
               meta.data_ptr(), None if order is None else order.data_ptr(),
               regs.shape[0], regs.shape[1], sbuf.shape[2], out.shape[1],
               int(k_steps), plan.c_fields, len(plan.c_fields),
               torch.cuda.current_stream(regs.device).cuda_stream)
    return batch


def kernel_attributes(device, lanes: int = 1) -> dict:
    """The compiled step kernel's attributes on CUDA ``device`` for lane
    groups of ``lanes`` (1 or ``WARP``: ``turbo_step_kernel<1>`` or
    ``<32>``) (``cudaFuncGetAttributes``): registers and local (stack)
    bytes per thread, static shared bytes, the most threads a block may
    have, and the dynamic shared bytes allowed (the opt-in, after the first
    launch)."""
    from .build import call
    vals = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        call("turbo_step_attributes", lanes, vals)
    return dict(zip(("registers", "local_bytes", "static_shared_bytes",
                     "max_threads", "max_dynamic_shared_bytes"), vals))


def sharded_turbo_step(tables: dict, batch, k_steps: int, tile: int = 128):
    """``turbo_step`` on every shard of a ``ShardedTurboBatch``
    (``parallel/mesh.py``), in place; ``tables`` maps each mesh device to
    the plan's ``StepTables`` there. Each shard launches on its device's
    current stream, with no synchronisation between shards: launches on
    different cards run at once, launches on one card queue in order. No
    collectives: instances never interact. CPU shards run the plain
    version."""
    for shard, _ in batch.parts():
        turbo_step(tables[shard.regs.device], shard, k_steps, tile)
    return batch


def sharded_turbo_step_reference(tables: dict, batch, k_steps: int):
    """The plain version of ``sharded_turbo_step``: ``turbo_step_reference``
    on every shard, the same way."""
    for shard, _ in batch.parts():
        turbo_step_reference(tables[shard.regs.device], shard, k_steps)
    return batch


def turbo_step_reference(tables: StepTables, batch, k_steps: int):
    """The plain PyTorch version of ``turbo_step_kernel``: the same steps
    on the same tensors, on any device."""
    EVENTS.count("plain.turbo_step")
    regs = batch.regs
    host = tables.host
    for _ in range(k_steps):
        live = regs[:, C_STATUS] == RUNNING
        pcs = regs[:, C_PC].clone()
        pcs_live = torch.unique(pcs[live]).tolist()
        if not pcs_live:
            break
        for pc in pcs_live:
            if 0 <= pc < host.n_instr:
                idx = torch.nonzero(live & (pcs == pc)).squeeze(1)
                lanes = _Lanes(tables, batch, idx)
                _EXEC[int(host.ins[pc, 0])](lanes, host, pc, host.ins[pc])
                _lane_yield(lanes, host)
                lanes.commit()
    return batch


class _Lanes:
    """The lanes at one pc: copies of their register rows and of the
    string, output and meta rows an instruction touches, written back by
    commit."""

    def __init__(self, tables: StepTables, batch, idx):
        self.t = tables
        self.batch = batch
        self.idx = idx
        self.m = idx.numel()
        self.dev = idx.device
        self.W = tables.host.width
        self.regs = batch.regs.index_select(0, idx)
        self.rows: dict = {}
        self.metas: dict = {}
        self.out = None

    # registers (int64 views of int32 cells)
    def reg(self, c: int) -> torch.Tensor:
        return self.regs[:, c].long()

    def set(self, c: int, val, mask=None) -> None:
        val = torch.as_tensor(val, dtype=torch.int64, device=self.dev)
        val = val.expand(self.m)
        if mask is not None:
            val = torch.where(mask, val, self.reg(c))
        self.regs[:, c] = _wrap32(val).int()

    # byte rows
    def row(self, r: int) -> torch.Tensor:
        if r not in self.rows:
            self.rows[r] = self.batch.sbuf[r].index_select(0, self.idx)
        return self.rows[r]

    def set_row(self, r: int, val, mask) -> None:
        self.rows[r] = torch.where(mask[:, None], val, self.row(r))

    # list meta planes, (m, 3E) int64
    def meta(self, plane: int) -> torch.Tensor:
        if plane not in self.metas:
            self.metas[plane] = self.batch.meta[plane].index_select(
                0, self.idx).long()
        return self.metas[plane]

    def set_meta(self, plane: int, val, mask) -> None:
        self.metas[plane] = torch.where(mask[:, None], val, self.meta(plane))

    def out_rows(self) -> torch.Tensor:
        if self.out is None:
            self.out = self.batch.out.index_select(0, self.idx)
        return self.out

    def full(self, v) -> torch.Tensor:
        return torch.full((self.m,), v, dtype=torch.int64, device=self.dev)

    def no(self) -> torch.Tensor:
        return torch.zeros(self.m, dtype=torch.bool, device=self.dev)

    def advance(self, park, next_pc) -> None:
        """ok lanes move to next_pc, parked lanes park; both count a step."""
        self.set(C_PC, next_pc, ~park)
        self.set(C_STATUS, PARKED, park)
        self.set(C_STEPS, self.reg(C_STEPS) + 1)

    def commit(self) -> None:
        b = self.batch
        b.regs.index_copy_(0, self.idx, self.regs)
        for r, val in self.rows.items():
            b.sbuf[r].index_copy_(0, self.idx, val)
        for p, val in self.metas.items():
            b.meta[p].index_copy_(0, self.idx, val.int())
        if self.out is not None:
            b.out.index_copy_(0, self.idx, self.out)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (as int64)."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _pow10(e: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_POW10, dtype=torch.int64,
                        device=e.device)[e.clamp(0, 9)]


def _int_to_dec(v: torch.Tensor):
    """Python str() of int32 values → ((m, 11) uint8, (m,) length)."""
    neg = v < 0
    mag = v.abs()
    nd = 1 + sum((mag >= p).long() for p in _POW10[1:])
    pos = torch.arange(11, device=v.device)[None, :]
    q = pos - neg.long()[:, None]
    valid = (q >= 0) & (q < nd[:, None])
    dig = (mag[:, None] // _pow10(nd[:, None] - 1 - q)) % 10 + 48
    buf = torch.where(valid, dig, 0)
    buf = torch.where(neg[:, None] & (pos == 0), 45, buf)
    return buf.to(torch.uint8), nd + neg.long()


def _parse_dec(buf: torch.Tensor, ln: torch.Tensor):
    """Optionally signed decimal of at most 9 digits → (value, ok)."""
    pos = torch.arange(buf.shape[1], device=buf.device)[None, :]
    b = buf.long()
    b0 = b[:, 0]
    has_sign = (ln > 0) & ((b0 == 45) | (b0 == 43))
    neg = has_sign & (b0 == 45)
    start = has_sign.long()[:, None]
    in_rng = (pos >= start) & (pos < ln[:, None])
    is_digit = (b >= 48) & (b <= 57)
    ndig = ln - has_sign.long()
    ok = (ndig > 0) & (ndig <= 9) & (~in_rng | is_digit).all(1)
    val = torch.where(in_rng, (b - 48) * _pow10(ln[:, None] - 1 - pos),
                      0).sum(1)
    return torch.where(neg, -val, val), ok


def _brace_or_escape(buf: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(buf.shape[1], device=buf.device)[None, :]
    bad = (buf == 123) | (buf == 125) | (buf == 92)
    return (bad & (pos < ln[:, None])).any(1)


def _place(buf, ln, src, sln):
    """buf[:, ln:ln+sln] = src[:, :sln], keeping what fits in buf."""
    pos = torch.arange(buf.shape[1], device=buf.device)[None, :]
    j = pos - ln[:, None]
    valid = (j >= 0) & (j < sln[:, None])
    g = torch.gather(src.expand(buf.shape[0], -1), 1,
                     j.clamp(0, src.shape[1] - 1))
    return torch.where(valid, g, buf)


def _const(L: _Lanes, data: bytes) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8,
                        device=L.dev)[None, :]


def _masked(buf, ln, width: int):
    """buf[:, :width] with bytes at or past ln (m,) zeroed."""
    pos = torch.arange(width, device=buf.device)[None, :]
    if buf.shape[1] < width:
        buf = torch.nn.functional.pad(buf, (0, width - buf.shape[1]))
    return torch.where(pos < ln[:, None], buf[:, :width], 0)


# ---- list cells ---------------------------------------------------------------

def _sections(meta, E: int):
    """(etype, eint, elen) sections of (m, 3E) meta planes."""
    return meta[:, :E], meta[:, E:2 * E], meta[:, 2 * E:]


def _pool(L: _Lanes, host, slot: int) -> torch.Tensor:
    """(m, E, elem_width) bytes of every element cell of list slot."""
    row0, ew, pack = int(host.slots[slot, 6]), host.elem_width, host.pack
    return torch.stack(
        [L.row(row0 + e // pack)[:, (e % pack) * ew:(e % pack + 1) * ew]
         for e in range(host.list_cap)], 1)


def _set_list(L: _Lanes, host, slot: int, meta, pool, mask) -> None:
    """Write a whole list (meta (m, 3E), pool (m, E, ew)) into slot's
    plane and element cells, on the masked lanes."""
    row0, ew, pack = int(host.slots[slot, 6]), host.elem_width, host.pack
    L.set_meta(int(host.slots[slot, 5]), meta, mask)
    for r in range((host.list_cap + pack - 1) // pack):
        new = L.row(row0 + r).clone()
        for q in range(pack):
            e = r * pack + q
            if e < host.list_cap:
                new[:, q * ew:(q + 1) * ew] = pool[:, e]
        L.set_row(row0 + r, new, mask)


def _cell_bytes(L: _Lanes, host, vbuf, vln) -> torch.Tensor:
    """The (m, ew) cell of an element value: its bytes, then zeros."""
    ew = host.elem_width
    if vbuf is None:
        return torch.zeros((L.m, ew), dtype=torch.uint8, device=L.dev)
    return _masked(vbuf.expand(L.m, -1), vln.clamp(max=ew), ew)


def _cell_set(meta, pool, sel, E: int, vt, vi, vln, cell):
    """meta/pool with cell sel (m, E) bool replaced by one element."""
    et, ei, el = _sections(meta, E)
    meta = torch.cat([torch.where(sel, vt[:, None], et),
                      torch.where(sel, vi[:, None], ei),
                      torch.where(sel, vln[:, None], el)], 1)
    return meta, torch.where(sel[:, :, None], cell[:, None, :], pool)


def _gather_cells(meta, pool, src, keep, E: int):
    """Cells e of a new list taken from cells src[:, e] (m, E), zero where
    keep (m, E) is false."""
    src = src.clamp(0, E - 1)
    secs = [torch.where(keep, torch.gather(sec, 1, src), 0)
            for sec in _sections(meta, E)]
    g = torch.gather(pool, 1, src[:, :, None].expand(-1, -1,
                                                     pool.shape[2]))
    return torch.cat(secs, 1), torch.where(keep[:, :, None], g, 0)


def _elem_read(L: _Lanes, host, slot: int, j):
    """Element j (m,) of list slot → (etype, eint, elen, (m, W) bytes zero
    past min(elen, elem_width))."""
    E, ew = host.list_cap, host.elem_width
    et, ei, el = (torch.gather(sec, 1, j[:, None])[:, 0]
                  for sec in _sections(L.meta(int(host.slots[slot, 5])), E))
    cell = _pool(L, host, slot)[torch.arange(L.m, device=L.dev), j]
    return et, ei, el, _masked(cell, el.clamp(max=ew), L.W)


def _repr_list(L: _Lanes, host, slot: int):
    """Python ``str(list)`` of list slot → ((m, W) bytes, min(length, W),
    park); the TPU kernel's _repr_list (vm/turbo.py:657). Parks on an
    element of the wrong kind for the slot's element kind and on a string
    element holding a byte outside printable ASCII, ``'`` or ``\\``."""
    E, ew, W = host.list_cap, host.elem_width, L.W
    clen, plane, ek = (int(x) for x in host.slots[slot, [3, 5, 7]])
    et_all, ei_all, el_all = _sections(L.meta(plane), E)
    pool = _pool(L, host, slot)
    n = L.reg(clen)
    buf = torch.zeros((L.m, W), dtype=torch.uint8, device=L.dev)
    ln = L.full(0)
    park = L.no()
    cpos = torch.arange(ew, device=L.dev)[None, :]

    def put(src, sln):
        nonlocal buf, ln
        buf = _place(buf, ln, src, sln)
        ln = ln + sln

    def lit(data, live):
        put(_const(L, data), torch.where(live, len(data), 0))

    put(_const(L, b"["), L.full(1))
    for e in range(E):
        live = e < n
        et, ei, el = et_all[:, e], ei_all[:, e], el_all[:, e]
        cell = pool[:, e]
        elc = el.clamp(0, ew)
        bad = (el > ew) | (((cell < 32) | (cell > 126) | (cell == 39)
                            | (cell == 92)) & (cpos < elc[:, None])).any(1)
        if e > 0 and ek != tt.KIND_STR:
            lit(b", ", live)
        if ek == tt.KIND_STR:
            park |= live & ((et != T_STR) | bad)
            lit(b"'" if e == 0 else b", '", live)
            put(cell, torch.where(live, elc, 0))
            lit(b"'", live)
        elif ek == tt.KIND_INT:
            park |= live & (et != T_INT)
            dbuf, dln = _int_to_dec(ei)
            put(dbuf, torch.where(live, dln, 0))
        else:
            is_str = live & (et == T_STR)
            park |= is_str & bad
            dbuf, dln = _int_to_dec(ei)
            lit(b"'", is_str)
            put(cell, torch.where(is_str, elc, 0))
            put(dbuf, torch.where(live & ~is_str, dln, 0))
            lit(b"'", is_str)
    put(_const(L, b"]"), L.full(1))
    return buf, ln.clamp(max=W), park | (ln > W)


def _render(L: _Lanes, host, seg0: int, nseg: int):
    """Template → (buf (m, W) zero past the length, min(length, W),
    missing, park); the TPU kernel's _render (vm/turbo.py:744)."""
    W = L.W
    buf = torch.zeros((L.m, W), dtype=torch.uint8, device=L.dev)
    ln = L.full(0)
    missing = L.no()
    park = L.no()
    for kind, v in host.segs[seg0:seg0 + nseg].tolist():
        if kind == tt.SEG_LIT:
            n = int(host.lit_len[v])
            buf = _place(buf, ln, L.t.lits[v][None, :], L.full(n))
            ln = ln + n
            continue
        k, cst, cint, clen, srow = host.slots[v, :5].tolist()
        st = L.reg(cst)
        missing |= st == T_EMPTY
        if k == tt.KIND_LIST:
            # str(list) in a template is the list's repr
            jbuf, jln, jpark = _repr_list(L, host, v)
            is_list = st == T_LIST
            park |= is_list & (jpark | _brace_or_escape(jbuf, jln))
            sln = torch.where(is_list, jln, 0)
            buf = _place(buf, ln, jbuf, sln)
            ln = ln + sln
        if k == tt.KIND_INT or k == tt.KIND_MIX:
            dbuf, dln = _int_to_dec(L.reg(cint))
            if k == tt.KIND_MIX:
                dln = torch.where(st == T_INT, dln, 0)
            buf = _place(buf, ln, dbuf, dln)
            ln = ln + dln
        if k == tt.KIND_STR or k == tt.KIND_MIX:
            vb, vl = L.row(srow), L.reg(clen)
            is_str = st == T_STR
            park |= is_str & _brace_or_escape(vb, vl)
            sln = torch.where(is_str, vl, 0)
            buf = _place(buf, ln, vb, sln)
            ln = ln + sln
    park |= ln > W
    return _masked(buf, ln, W), ln.clamp(max=W), missing, park


def _match_at(L: _Lanes, host, kind, a, b, buf, ln):
    """Anchored match of one decomposed pattern against buf[:, :ln]."""
    if kind == tt.PAT_ANY:
        return torch.ones(L.m, dtype=torch.bool, device=L.dev)

    def head(row):
        n = int(host.lit_len[row])
        return n, (buf[:, :n] == L.t.lits[row, :n]).all(1)

    def tail(row):
        n = int(host.lit_len[row])
        j = (ln[:, None] - n + torch.arange(n, device=L.dev)[None, :])
        got = torch.gather(buf, 1, j.clamp(0, buf.shape[1] - 1))
        return n, (got == L.t.lits[row, :n]).all(1)

    if kind == tt.PAT_EXACT:
        n, eq = head(a)
        return (ln == n) & eq
    if kind == tt.PAT_PREFIX:
        n, eq = head(a)
        return (ln >= n) & eq
    if kind == tt.PAT_SUFFIX:
        n, eq = tail(a)
        return (ln >= n) & eq
    n1, eq1 = head(a)
    n2, eq2 = tail(b)
    return (ln >= n1 + n2) & eq1 & eq2


def _match(L: _Lanes, host, ent, buf, ln):
    """Including the end anchor's match before one trailing newline."""
    kind, a, b, _tgt = ent
    hit = _match_at(L, host, kind, a, b, buf, ln)
    if kind in (tt.PAT_ANY, tt.PAT_PREFIX):
        return hit
    last = torch.gather(buf, 1, (ln - 1).clamp(min=0)[:, None])[:, 0]
    has_nl = (ln > 0) & (last == 10)
    trimmed = torch.where(has_nl, ln - 1, ln)
    return hit | (has_nl & _match_at(L, host, kind, a, b, buf, trimmed))


def _eval_rpn(L: _Lanes, host, q0: int, nq: int):
    stack = []
    park = L.no()
    for op, arg in host.rpn[q0:q0 + nq].tolist():
        if op == tt.RPN_CONST:
            stack.append(L.full(arg))
        elif op == tt.RPN_SLOT:
            _k, cst, cint, clen, srow = host.slots[arg, :5].tolist()
            st = L.reg(cst)
            if srow >= 0:
                parsed, ok = _parse_dec(L.row(srow), L.reg(clen))
                stack.append(torch.where(st == T_STR, parsed, L.reg(cint)))
                park |= ((st == T_EMPTY) | ((st == T_STR) & ~ok)
                         | (st == T_LIST))
            else:
                stack.append(L.reg(cint))
                park |= st != T_INT
        elif op == tt.RPN_LENGTH:
            _k, cst, _ci, clen, _r = host.slots[arg, :5].tolist()
            park |= L.reg(cst) != T_LIST
            stack.append(L.reg(clen))
        elif op == tt.RPN_NEG:
            stack.append(_wrap32(-stack.pop()))
        elif op == tt.RPN_SIGN:
            stack.append(torch.sign(stack.pop()))
        else:
            b = stack.pop()
            a = stack.pop()
            if op == tt.RPN_ADD:
                r = a + b
            elif op == tt.RPN_SUB:
                r = a - b
            elif op == tt.RPN_MUL:
                r = a * b
            elif op == tt.RPN_MIN2:
                r = torch.minimum(a, b)
            elif op == tt.RPN_MAX2:
                r = torch.maximum(a, b)
            else:
                safe = torch.where(b == 0, 1, b)
                q = torch.div(a, safe, rounding_mode="floor")
                m = a - q * safe
                if op == tt.RPN_DIV:
                    park |= (b == 0) | (m != 0)
                    r = q
                else:
                    park |= b == 0
                    r = m
            stack.append(_wrap32(r))
    return stack.pop(), park


def _eval_src(L: _Lanes, host, kind: int, c: int, d: int):
    """An item source (SRC_*, c, d) → (vt, vi, vbuf or None, vln, park);
    the TPU kernel's _eval_item (vm/turbo.py:883). A copy of a list slot
    parks (a nested list is the host's)."""
    if kind == tt.SRC_INT:
        return L.full(T_INT), L.full(c), None, L.full(0), L.no()
    if kind == tt.SRC_STR:
        return (L.full(T_STR), L.full(0), L.t.lits[c][None, :],
                L.full(int(host.lit_len[c])), L.no())
    if kind == tt.SRC_COPY:
        k, cst, cint, clen, srow = host.slots[c, :5].tolist()
        st = L.reg(cst)
        if k == tt.KIND_LIST:
            return st, L.full(0), None, L.full(0), ~L.no()
        if srow >= 0:
            return st, L.reg(cint), L.row(srow), L.reg(clen), st == T_EMPTY
        return st, L.reg(cint), None, L.full(0), st == T_EMPTY
    buf, vln, missing, park = _render(L, host, c, d)
    return L.full(T_STR), L.full(0), buf, vln, park | missing


def _eval_item(L: _Lanes, host, row: int):
    """The item source of the items table's row."""
    return _eval_src(L, host, *(int(x) for x in host.items[row]))


# ---- one function per opcode: (lanes, tables, pc, ins row) -------------------

def _halt(L, host, pc, ins):
    L.set(C_STATUS, DONE)


def _nop(L, host, pc, ins):
    L.advance(L.no(), pc + 1)


def _goto(L, host, pc, ins):
    L.advance(L.no(), int(ins[1]))


def _park(L, host, pc, ins):
    slot = int(ins[1])
    if slot < 0:
        L.set(C_STATUS, PARKED)
        return
    ready = L.reg(int(host.slots[slot, 1])) != T_EMPTY
    L.set(C_PC, pc + 1, ready)
    L.set(C_STEPS, L.reg(C_STEPS) + 1, ready)
    L.set(C_STATUS, PARKED, ~ready)


def _clear(L, host, pc, ins):
    L.set(C_CLREPOCH, L.reg(C_CLREPOCH) + 1)
    L.out = torch.zeros_like(L.out_rows())
    L.set(C_OUTLEN, 0)
    L.advance(L.no(), pc + 1)


def _delete(L, host, pc, ins):
    a, b = int(ins[1]), int(ins[2])
    for s in host.ints[a:a + b].tolist():
        L.set(int(host.slots[s, 1]), T_EMPTY)
    L.advance(L.no(), pc + 1)


def _write_scalar(L, host, slot: int, vt, vi, vln, vbuf, ok) -> None:
    """A scalar result into slot: its registers, and its byte row when it
    has one and the value brings bytes (a full row, as the TPU kernel)."""
    _k, ost, oint, olen, orow = host.slots[slot, :5].tolist()
    if vbuf is not None and orow >= 0:
        L.set_row(orow, vbuf.expand(L.m, -1), ok)
    L.set(ost, vt, ok)
    L.set(oint, vi, ok)
    L.set(olen, vln, ok)


def _set(L, host, pc, ins):
    out_slot, src, c, d = (int(x) for x in ins[1:5])
    vt, vi, vbuf, vln, park = _eval_src(L, host, src, c, d)
    _write_scalar(L, host, out_slot, vt, vi, vln, vbuf, ~park)
    L.advance(park, pc + 1)


def _math(L, host, pc, ins):
    out_slot, q0, nq = (int(x) for x in ins[1:4])
    val, park = _eval_rpn(L, host, q0, nq)
    _write_scalar(L, host, out_slot, L.full(T_INT), val, L.full(0), None,
                  ~park)
    L.advance(park, pc + 1)


def _print(L, host, pc, ins):
    seg0, nseg, single = (int(x) for x in ins[1:4])
    buf, vln, missing, park = _render(L, host, seg0, nseg)
    park = park | missing
    if single >= 0:
        park |= L.reg(int(host.slots[single, 1])) != T_STR
    ol = L.reg(C_OUTLEN)
    park |= ol + vln > L.out_rows().shape[1]
    ok = ~park
    L.out = torch.where(ok[:, None], _place(L.out, ol, buf, vln), L.out)
    L.set(C_OUTLEN, ol + vln, ok)
    L.advance(park, pc + 1)


def _goto_map(L, host, pc, ins):
    op, a, b, c, d, null_pc = (int(x) for x in ins[:6])
    decided = L.no()
    tgt = L.full(0)
    if op == tt.OP_GOTOMAP:
        buf, ln, missing, park = _render(L, host, a, b)
        for ent in host.ents[c:c + d].tolist():
            hit = _match(L, host, ent, buf, ln) & ~decided
            tgt = torch.where(hit, ent[3], tgt)
            decided |= hit
    else:
        missing = L.reg(int(host.slots[a, 1])) == T_EMPTY
        park = L.no()
        val = L.reg(int(host.slots[a, 2]))
        for kind, v, _b, target in host.ents[c:c + d].tolist():
            hit = ~decided if kind == tt.PAT_ANY else (val == v) & ~decided
            tgt = torch.where(hit, target, tgt)
            decided |= hit
    if null_pc >= 0:
        tgt = torch.where(missing, null_pc, tgt)
        routed = missing | decided
    else:
        routed = decided & ~missing
    L.advance(park | ~routed, tgt)


def _for_head(L, host, pc, ins):
    lc, n, exit_pc, p0, npairs = (int(x) for x in ins[1:6])
    counter = L.reg(lc)
    cur = torch.where(counter == 0, 1, counter)
    exiting = cur > n
    L.set(lc, torch.where(exiting, 0, cur))
    k = cur - 1
    for slot, e0 in host.pairs[p0:p0 + npairs].tolist():
        _k, cst, cint, clen, srow = host.slots[slot, :5].tolist()
        for j, (kind, v) in enumerate(host.elems[e0:e0 + n].tolist()):
            sel = (k == j) & ~exiting
            if kind == tt.ELEM_INT:
                L.set(cst, T_INT, sel)
                L.set(cint, v, sel)
                L.set(clen, 0, sel)
            else:
                L.set(cst, T_STR, sel)
                L.set(cint, 0, sel)
                L.set(clen, int(host.lit_len[v]), sel)
                if srow >= 0:
                    L.set_row(srow, L.t.lits[v][None, :].expand(L.m, -1),
                              sel)
    L.advance(L.no(), torch.where(exiting, exit_pc, pc + 1))


def _for_next(L, host, pc, ins):
    lc, head_pc = int(ins[1]), int(ins[2])
    L.set(lc, L.reg(lc) + 1)
    L.advance(L.no(), head_pc)


# ---- lists ----------------------------------------------------------------------

def _list_regs(L, host, slot: int, count, ok) -> None:
    _k, ost, oint, olen, _r = host.slots[slot, :5].tolist()
    L.set(ost, T_LIST, ok)
    L.set(oint, 0, ok)
    L.set(olen, count, ok)


def _src_list(L, host, slot: int):
    """(stype, count, meta, pool) of list slot."""
    cst, clen, plane = (int(x) for x in host.slots[slot, [1, 3, 5]])
    return L.reg(cst), L.reg(clen), L.meta(plane), _pool(L, host, slot)


def _set_list_copy(L, host, pc, ins):
    out_slot, src = int(ins[1]), int(ins[2])
    _k, cst, cint, clen, _r = host.slots[src, :5].tolist()
    st = L.reg(cst)
    park = st == T_EMPTY
    ok = ~park
    if out_slot != src:
        _st, _n, meta, pool = _src_list(L, host, src)
        _set_list(L, host, out_slot, meta, pool, ok)
    _k, ost, oint, olen, _r = host.slots[out_slot, :5].tolist()
    vals = (st, L.reg(cint), L.reg(clen))
    for c, v in zip((ost, oint, olen), vals):
        L.set(c, v, ok)
    L.advance(park, pc + 1)


def _list_new(L, host, pc, ins):
    out_slot, i0, n = (int(x) for x in ins[1:4])
    E = host.list_cap
    meta = torch.zeros((L.m, 3 * E), dtype=torch.int64, device=L.dev)
    pool = torch.zeros((L.m, E, host.elem_width), dtype=torch.uint8,
                       device=L.dev)
    park = L.no()
    cells = torch.arange(E, device=L.dev)[None, :]
    for e in range(n):
        vt, vi, vbuf, vln, p = _eval_item(L, host, i0 + e)
        park |= p | (vln > host.elem_width)
        meta, pool = _cell_set(meta, pool, cells == e, E, vt, vi, vln,
                               _cell_bytes(L, host, vbuf, vln))
    ok = ~park
    _set_list(L, host, out_slot, meta, pool, ok)
    _list_regs(L, host, out_slot, n, ok)
    L.advance(park, pc + 1)


def _list_append(L, host, pc, ins):
    out_slot, src, irow = (int(x) for x in ins[1:4])
    E = host.list_cap
    st, n, meta, pool = _src_list(L, host, src)
    vt, vi, vbuf, vln, park = _eval_item(L, host, irow)
    park = park | (st != T_LIST) | (n >= E) | (vln > host.elem_width)
    ok = ~park
    sel = torch.arange(E, device=L.dev)[None, :] == n[:, None]
    meta, pool = _cell_set(meta, pool, sel, E, vt, vi, vln,
                           _cell_bytes(L, host, vbuf, vln))
    _set_list(L, host, out_slot, meta, pool, ok)
    _list_regs(L, host, out_slot, n + 1, ok)
    L.advance(park, pc + 1)


def _list_remove(L, host, pc, ins):
    out_slot, src, irow = (int(x) for x in ins[1:4])
    E, ew = host.list_cap, host.elem_width
    st, n, meta, pool = _src_list(L, host, src)
    vt, vi, vbuf, vln, park = _eval_item(L, host, irow)
    park = park | (st != T_LIST)
    et, ei, el = _sections(meta, E)
    # first match: int == int by value, str == str by bytes; never int/str
    eq = (vt[:, None] == T_INT) & (et == T_INT) & (ei == vi[:, None])
    if vbuf is not None:
        want = _cell_bytes(L, host, vbuf, vln)
        cpos = torch.arange(ew, device=L.dev)[None, None, :]
        same = ((pool == want[:, None, :])
                | (cpos >= vln[:, None, None])).all(2)
        eq |= ((vt[:, None] == T_STR) & (et == T_STR) & (el == vln[:, None])
               & (vln[:, None] <= ew) & same)
    cells = torch.arange(E, device=L.dev)[None, :]
    eq &= cells < n[:, None]
    found = eq.any(1)
    m = torch.where(found, eq.long().argmax(1), E)
    shift = found[:, None] & (cells >= m[:, None])
    meta, pool = _gather_cells(meta, pool, cells + shift.long(),
                               (cells + shift.long()) < E, E)
    ok = ~park
    _set_list(L, host, out_slot, meta, pool, ok)
    _list_regs(L, host, out_slot, torch.where(found, n - 1, n), ok)
    L.advance(park, pc + 1)


def _list_index(L, host, pc, ins):
    out_slot, src, kind, d, e = (int(x) for x in ins[1:6])
    E = host.list_cap
    _k, cst, _ci, clen, _r = host.slots[src, :5].tolist()
    n = L.reg(clen)
    park = L.reg(cst) != T_LIST
    if kind == tt.IDX_CONST:
        idx = L.full(d)
    elif kind == tt.IDX_COPY:
        _k, ist_c, iint, ilen, irow = host.slots[d, :5].tolist()
        ist = L.reg(ist_c)
        if irow >= 0:
            parsed, pok = _parse_dec(L.row(irow), L.reg(ilen))
            idx = torch.where(ist == T_INT, L.reg(iint), parsed)
            park |= ((ist == T_EMPTY) | (ist == T_LIST)
                     | ((ist == T_STR) & ~pok))
        else:
            idx = L.reg(iint)
            park |= ist != T_INT
    else:
        rbuf, rln, missing, p = _render(L, host, d, e)
        idx, pok = _parse_dec(rbuf, rln)
        park |= missing | p | ~pok
    # 1-based; 0 raises on the host; negatives count from the end
    park |= idx == 0
    j = torch.where(idx > 0, idx - 1, n + idx)
    park |= (j < 0) | (j >= n)
    et, ei, el, ebuf = _elem_read(L, host, src, j.clamp(0, E - 1))
    _write_scalar(L, host, out_slot, et, ei, el, ebuf, ~park)
    L.advance(park, pc + 1)


def _list_slice(L, host, pc, ins):
    out_slot, src, f0, fn, t0, tn = (int(x) for x in ins[1:7])
    E = host.list_cap
    st, n, meta, pool = _src_list(L, host, src)
    frm, p1 = _eval_rpn(L, host, f0, fn)
    to, p2 = _eval_rpn(L, host, t0, tn)
    # 1-based right-inclusive, with the right-bound-0 quirk, then Python's
    # own slice clamping (the executor's _py_slice_index)
    park = (st != T_LIST) | p1 | p2 | (frm == 0)
    s0 = torch.where(frm > 0, frm - 1, n + frm)
    e0 = torch.where(to > 0, to - 1, torch.where(to < 0, n + to, 0)) + 1
    pys = torch.where(s0 < 0, (s0 + n).clamp(min=0), torch.minimum(s0, n))
    pye = torch.where(e0 < 0, (e0 + n).clamp(min=0), torch.minimum(e0, n))
    count = (pye - pys).clamp(min=0)
    cells = torch.arange(E, device=L.dev)[None, :]
    meta, pool = _gather_cells(meta, pool, cells + pys[:, None],
                               cells < count[:, None], E)
    ok = ~park
    _set_list(L, host, out_slot, meta, pool, ok)
    _list_regs(L, host, out_slot, count, ok)
    L.advance(park, pc + 1)


def _list_join(L, host, pc, ins):
    out_slot, src, seg0, nb, nm, na = (int(x) for x in ins[1:7])
    E, ew = host.list_cap, host.elem_width
    st, n, meta, pool = _src_list(L, host, src)
    bbuf, bln, bmiss, bpark = _render(L, host, seg0, nb)
    mbuf, mln, mmiss, mpark = _render(L, host, seg0 + nb, nm)
    abuf, aln, amiss, apark = _render(L, host, seg0 + nb + nm, na)
    park = (st != T_LIST) | bmiss | bpark | mmiss | mpark | amiss | apark
    et, _ei, el = _sections(meta, E)
    buf, ln = bbuf, bln
    for e in range(E):
        live = e < n
        if e > 0:
            sln = torch.where(live, mln, 0)
            buf, ln = _place(buf, ln, mbuf, sln), ln + sln
        park |= live & (et[:, e] != T_STR)
        sln = torch.where(live, el[:, e].clamp(0, ew), 0)
        buf, ln = _place(buf, ln, pool[:, e], sln), ln + sln
    buf, ln = _place(buf, ln, abuf, aln), ln + aln
    park |= ln > L.W
    _write_scalar(L, host, out_slot, L.full(T_STR), L.full(0), ln,
                  _masked(buf, ln, L.W), ~park)
    L.advance(park, pc + 1)


def _list_concat(L, host, pc, ins):
    out_slot, i0, k = (int(x) for x in ins[1:4])
    E = host.list_cap
    cells = torch.arange(E, device=L.dev)[None, :]
    meta = torch.zeros((L.m, 3 * E), dtype=torch.int64, device=L.dev)
    pool = torch.zeros((L.m, E, host.elem_width), dtype=torch.uint8,
                       device=L.dev)
    park = L.no()
    off = L.full(0)
    for s in host.ints[i0:i0 + k].tolist():
        st, n, smeta, spool = _src_list(L, host, s)
        park |= st != T_LIST
        c = cells - off[:, None]
        sel = (c >= 0) & (c < n[:, None])
        gmeta, gpool = _gather_cells(smeta, spool, c, sel, E)
        meta = torch.where(sel.repeat(1, 3), gmeta, meta)
        pool = torch.where(sel[:, :, None], gpool, pool)
        off = off + n
    park |= off > E
    ok = ~park
    _set_list(L, host, out_slot, meta, pool, ok)
    _list_regs(L, host, out_slot, off, ok)
    L.advance(park, pc + 1)


def _for_head_dyn(L, host, pc, ins):
    lc, exit_pc, d0, npairs = (int(x) for x in ins[1:5])
    E = host.list_cap
    pairs = host.dpairs[d0:d0 + npairs].tolist()
    park = L.no()
    n = None
    for _v, ls in pairs:
        _k, cst, _ci, clen, _r = host.slots[ls, :5].tolist()
        park |= L.reg(cst) != T_LIST
        if n is None:
            n = L.reg(clen)
        else:
            # differing lengths: the host raises the exact assert
            park |= L.reg(clen) != n
    counter = L.reg(lc)
    cur = torch.where(counter == 0, 1, counter)
    exiting = cur > n
    k = (cur - 1).clamp(0, E - 1)
    reads = [_elem_read(L, host, ls, k) for _v, ls in pairs]
    ok = ~park
    take = ok & ~exiting   # an exiting lane keeps the last values
    for (var, _ls), (et, ei, el, ebuf) in zip(pairs, reads):
        _write_scalar(L, host, var, et, ei, el, ebuf, take)
    L.set(lc, torch.where(exiting, 0, cur), ok)
    L.advance(park, torch.where(exiting, exit_pc, pc + 1))


# ---- parallel thread lanes --------------------------------------------------------

def _par_begin(L, host, pc, ins):
    mode, k, join_pc, e0, l0, nl = (int(x) for x in ins[1:7])
    nt = host.n_threads
    entries = host.ints[e0:e0 + k].tolist()
    L.set(C_CURTID, 0)
    L.set(C_PARMODE, mode)
    L.set(C_PARJOIN, join_pc)
    for lane in range(nt):
        L.set(C_BASE + lane, entries[lane] if lane < k else 0)
        L.set(C_BASE + nt + lane, T_NEW if lane < k else T_FREE)
        L.set(C_BASE + 2 * nt + lane, 0)
    # loop counters of the block restart (a raced lane may have left one
    # mid-loop)
    for col in host.ints[l0:l0 + nl].tolist():
        L.set(col, 0)
    L.advance(L.no(), entries[0])


def _thread_end(L, host, pc, ins):
    k, join_pc = int(ins[1]), int(ins[2])
    nt = host.n_threads
    cur = L.reg(C_CURTID).clamp(0, nt - 1)
    lanes = torch.arange(nt, device=L.dev)[None, :]
    tst = torch.stack([L.reg(C_BASE + nt + lane) for lane in range(nt)], 1)
    tst = torch.where(lanes == cur[:, None], T_DONE, tst)
    started = lanes < k
    new_left = (started & (tst == T_NEW)).any(1)
    wait_left = (started & (tst == T_WAIT)).any(1)
    ready_left = (started & (tst == T_READY)).any(1)
    all_done = (~started | (tst == T_DONE)).all(1)
    wait_mode = L.reg(C_PARMODE) == PM_WAIT
    # a race completes only when no lane has a slice coming
    complete = (wait_mode & all_done) | \
        (~wait_mode & ~new_left & ~wait_left & ~ready_left)
    drain = ~wait_mode & ~complete
    # the next runnable lane, cyclic from cur + 1
    order = (cur[:, None] + 1 + lanes) % nt
    st_o = torch.gather(tst, 1, order)
    runnable = ((st_o == T_NEW) | (st_o == T_READY)) & (order < k)
    any_run = runnable.any(1)
    nxt = torch.gather(order, 1, runnable.long().argmax(1)[:, None])[:, 0]
    nxt = torch.where(any_run, nxt, 0)
    tpc = torch.stack([L.reg(C_BASE + lane) for lane in range(nt)], 1)
    tpc_nxt = torch.gather(tpc, 1, nxt[:, None])[:, 0]
    for lane in range(nt):
        L.set(C_BASE + nt + lane, torch.where(complete, T_FREE,
                                              tst[:, lane]))
    L.set(C_PARMODE, torch.where(complete, PM_NONE,
                                 torch.where(drain, PM_DRAIN,
                                             L.reg(C_PARMODE))))
    L.set(C_PARJOIN, torch.where(complete, 0, L.reg(C_PARJOIN)))
    L.set(C_PAREPOCH, L.reg(C_PAREPOCH) + complete.long())
    L.set(C_CURTID, torch.where(complete, -1,
                                torch.where(any_run, nxt, -1)))
    L.set(C_PC, torch.where(complete, join_pc,
                            torch.where(any_run, tpc_nxt, L.reg(C_PC))))
    L.set(C_STATUS, torch.where(complete | any_run, RUNNING, PARKED))
    L.set(C_STEPS, L.reg(C_STEPS) + 1)


def _lane_yield(L: _Lanes, host) -> None:
    """A park inside a parallel block suspends the current lane: WAIT, and
    its saved pc and park pc become the parked pc. It never switches lanes:
    whether the parked IO completes at once is the host ring's knowledge
    (the TPU kernel's _lane_yield, vm/turbo.py:1827)."""
    nt = host.n_threads
    if nt == 0:
        return
    parked = ((L.reg(C_STATUS) == PARKED) & (L.reg(C_PARMODE) > 0)
              & (L.reg(C_CURTID) >= 0))
    if not bool(parked.any()):
        return
    cur = L.reg(C_CURTID).clamp(0, nt - 1)
    pc = L.reg(C_PC)
    for lane in range(nt):
        sel = parked & (cur == lane)
        L.set(C_BASE + nt + lane, T_WAIT, sel)
        L.set(C_BASE + 2 * nt + lane, pc, sel)
        L.set(C_BASE + lane, pc, sel)


_EXEC = {
    tt.OP_HALT: _halt, tt.OP_NOP: _nop, tt.OP_GOTO: _goto,
    tt.OP_PARK: _park, tt.OP_CLEAR: _clear, tt.OP_DELETE: _delete,
    tt.OP_SET: _set, tt.OP_MATH: _math, tt.OP_PRINT: _print,
    tt.OP_GOTOMAP: _goto_map, tt.OP_GOTOMAP_INT: _goto_map,
    tt.OP_FORHEAD: _for_head, tt.OP_FORNEXT: _for_next,
    tt.OP_SETLIST: _set_list_copy, tt.OP_LISTNEW: _list_new,
    tt.OP_LISTAPPEND: _list_append, tt.OP_LISTREMOVE: _list_remove,
    tt.OP_LISTINDEX: _list_index, tt.OP_LISTSLICE: _list_slice,
    tt.OP_LISTJOIN: _list_join, tt.OP_LISTCONCAT: _list_concat,
    tt.OP_FORHEADDYN: _for_head_dyn, tt.OP_PARBEGIN: _par_begin,
    tt.OP_THREADEND: _thread_end,
}
