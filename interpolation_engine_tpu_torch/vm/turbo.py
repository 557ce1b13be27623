"""Turbo engine on PyTorch: a turbo-planned program over a batch of instances.

The counterpart of ``interpolation_engine_tpu/vm/turbo.py``. The planner
(``compiler/turbo.py``, shared) lowers a program to per-pc instruction IR
with static insert slots. On the TPU that IR was baked into one Mosaic
kernel per program at trace time. Here it becomes int32 tables
(``vm/turbo_tables.py``) that ONE compiled CUDA kernel reads
(``csrc/turbo_step.cu``): a program never triggers a build.

Semantics contract, as in the JAX package: identical to the host oracle or
PARK. A lane that meets anything the step cannot reproduce byte-exactly
parks; the host ring runs the original task on the exact host executor and
resumes the lane.

Layouts (N instances, R byte rows, W slot bytes, OW output bytes):

  regs : (N, REGW)   int32  the register columns of ``_Cols`` (same layout
                            as the JAX package, so codecs and tests read both)
  sbuf : (R, N, W)   uint8  one byte row per str/mix slot, then per list
                            slot its meta row (unused here, kept zero) and
                            its packed element rows
  out  : (N, OW)     uint8  output buffer bytes
  meta : (M, N, 3E)  int32  per list slot (``_Cols.list_ord`` order) the
                            element scalars: [0,E) etype, [E,2E) eint,
                            [2E,3E) elen

The TPU kept bytes in int32 planes only because Mosaic has no int8
vectors; here they are uint8. A list's element ints need 32 bits, so the
JAX package's int32 meta row moves into ``meta``, and the sbuf row keeps
its index so every other row keeps the JAX row numbering. The step
updates these tensors in place.

Every plan that ``plan_turbo`` accepts runs, parallel thread lanes and
lists included. The ring is the JAX package's: its vectorized fast park
path first (a literal-prompt user_input on a backend that answers at once,
and a drained race whose one waiting lane is cancelled, resumed by batched
torch writes on the device), then the exact slow path for the rest, with
lane servicing for instances parked inside a parallel block. A value that
outgrows its slot moves the instance into one sibling batch
``promote_factor`` times wider, run concurrently with this one. An
instance that even the sibling cannot hold escapes: at the end of the run,
every escaped instance runs in one batch of the general engine
(``vm/driver.py`` ``DeviceRunner``) on the engine's device, sharing its
LaneRing, IO managers and global instance ids.

Step counts: the JAX fast path resumes a drained race at its join without
the lane's thread end, one step fewer than its exact ring. Here both paths
count as the exact ring does, and leave every register as it leaves them.

Over several devices (``mesh=``, ``parallel/mesh.py``) the batch is a
``ShardedTurboBatch`` and the step launches the kernel per shard
(``build_sharded_step_fn``, the JAX package's ``shard_map`` step); the ring
reads and writes the shards through the same helpers, which see one device's
batch as a single shard. Sibling engines over disjoint instance ids
(``make_shard_engines``, ``run_pipelined``) share one plan, one LaneRing and
the device tables, and overlap one engine's host service with another's
launch.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._shared import (context, events, executor, io_manager, isa, planner,
                       vm_config)
from .._shared import lanering as lanering_mod
from ..ops.turbo_step import (C_BASE, C_CLREPOCH, C_CURTID, C_OUTLEN,
                              C_PAREPOCH, C_PARJOIN, C_PARMODE, C_PC,
                              C_STATUS, C_STEPS, MAX_WIDTH, StepTables,
                              TileShape, fits_one_instance, shared_memory,
                              sharded_turbo_step, turbo_step)
from ..parallel.mesh import ShardedTurboBatch, make_mesh, shard_turbo_batch
from . import state as vs
from .state import T_INT, T_LIST, T_STR
from .turbo_tables import build_tables

from .config import (DONE, PARKED, PM_DRAIN, PM_NONE, RUNNING, T_DONE,
                     T_FREE, T_NEW, T_READY, T_WAIT)

NotTurbo = planner.NotTurbo


@dataclass(frozen=True)
class TurboConfig:
    tile: int = 128     # most instances per CUDA block (ops/turbo_step.py
    #                     tile_plan takes fewer where shared memory is short)
    width: int = 128    # slot string bytes
    out_width: int = 256
    k_steps: int = 32   # VM steps per kernel launch
    list_cap: int = 12  # elements per list slot
    elem_width: int = 32  # bytes per list element

    def widened(self, f: int) -> "TurboConfig":
        """This config with width, out_width and elem_width ``f`` times
        wider: the promotion sibling's widening."""
        return replace(self, width=f * self.width,
                       out_width=f * self.out_width,
                       elem_width=f * self.elem_width)


def base_config(plan) -> TurboConfig:
    """The base TurboConfig for ``plan``: the first of ``TurboConfig()``
    and its widenings by 4 (width, out_width and elem_width, as the
    promotion sibling widens) whose width holds the plan's longest byte
    literal: widths 128, 512 and 2048, ``MAX_WIDTH``. A literal past
    ``MAX_WIDTH`` raises ``NotTurbo``. A widened config is counted as
    ``turbo.base_width`` (its width)."""
    lits = _LitTable(MAX_WIDTH)
    lits.collect(plan.instrs)
    longest = int(lits.lengths().max())
    cfg = TurboConfig()
    while cfg.width < longest:
        cfg = cfg.widened(4)
    if cfg.width > TurboConfig.width:
        events.EVENTS.count("turbo.base_width", cfg.width)
    return cfg


class _Cols:
    """Register-column layout, identical to the JAX package's ``_Cols``
    (``interpolation_engine_tpu/vm/turbo.py:140``):

      0-3   pc, status, steps, out_len
      4-7   cur_tid, par_mode, par_join, par_epoch
      8     clear-epoch (output-spill invalidation)
      9..   tpc[NT], tstate[NT], tparg[NT]      (parallel thread lanes)
      then  stype[S], sint[S], slen[S]          (slen of a list = count)
      then  loop counters [n_loops]

    REGW is padded to a multiple of 128. Byte rows exist only for slots
    that can hold a string (kind 'str'/'mix'); each list slot owns one meta
    row (its element scalars live in the batch's ``meta`` tensor) plus
    ceil(E / PACK) packed element rows after the string rows, PACK =
    width // elem_width elements per row."""

    def __init__(self, S: int, kinds=None, n_loops: int = 0,
                 nt: int = 0, list_cap: int = 12, width: int = 128,
                 elem_width: int = 32, elem_kinds=None):
        self.ekinds = dict(elem_kinds or {})
        self.S = S
        self.n_loops = n_loops
        self.nt = nt
        self.E = list_cap
        self.ew = elem_width
        self.pack = max(width // elem_width, 1)
        self.width = width
        if 3 * self.E > 128:
            raise NotTurbo(f"list_cap {self.E} exceeds the meta row "
                           f"(3*E must fit 128 lanes)")
        self.kinds = list(kinds) if kinds else ["mix"] * S
        if len(self.kinds) < S:
            self.kinds += ["mix"] * (S - len(self.kinds))
        self._threads0 = C_BASE
        self._slots0 = self._threads0 + 3 * nt
        self._loops0 = self._slots0 + 3 * S
        self.list_ord = {}
        for s, k in enumerate(self.kinds):
            if k == "list":
                self.list_ord[s] = len(self.list_ord)
        n_cols = self._loops0 + n_loops
        self.regw = max(((n_cols + 127) // 128) * 128, 128)
        if self.regw > 512:
            raise NotTurbo(
                f"{S} slots / {nt} lanes need {n_cols} register "
                f"columns (> 512)")
        self.str_row = {}
        for s, k in enumerate(self.kinds):
            if k in ("str", "mix"):
                self.str_row[s] = len(self.str_row)
        self.elem_rows = (self.E + self.pack - 1) // self.pack
        self.meta_row = {}    # list slot -> meta row index
        self.list_row0 = {}   # list slot -> first element byte row
        nrows = len(self.str_row)
        for s in sorted(self.list_ord):
            self.meta_row[s] = nrows
            self.list_row0[s] = nrows + 1
            nrows += 1 + self.elem_rows
        self.n_rows = max(nrows, 1)

    def stype(self, s: int) -> int:
        return self._slots0 + s

    def sint(self, s: int) -> int:
        return self._slots0 + self.S + s

    def slen(self, s: int) -> int:
        return self._slots0 + 2 * self.S + s

    def loop(self, loop_id: int) -> int:
        return self._loops0 + min(loop_id, max(self.n_loops - 1, 0))

    def kind(self, s: int) -> str:
        return self.kinds[s]

    def ekind(self, s: int) -> str:
        """Element kind of list slot s ('int'/'str'/'mix'): a list repr
        parks on an element of the other kind."""
        return self.ekinds.get(s, "mix")

    # thread lanes
    def tpc(self, lane: int) -> int:
        return self._threads0 + lane

    def tstate(self, lane: int) -> int:
        return self._threads0 + self.nt + lane

    def tparg(self, lane: int) -> int:
        return self._threads0 + 2 * self.nt + lane

    def elem_pos(self, s: int, e: int) -> tuple:
        """(byte row, byte offset) of element e of list slot s."""
        return (self.list_row0[s] + e // self.pack,
                (e % self.pack) * self.ew)


def _make_cols(plan, tcfg: TurboConfig) -> _Cols:
    return _Cols(max(plan.n_slots, 1), plan.slot_kinds,
                 plan.compiled.n_loops, nt=plan.needs_threads,
                 list_cap=tcfg.list_cap, width=tcfg.width,
                 elem_width=tcfg.elem_width, elem_kinds=plan.elem_kinds)


class _LitTable:
    """The plan's byte literals as one (L, W) uint8 table with per-row
    lengths, read by the step kernel like the rest of the plan's tables.
    Rows are registered in the same order as the JAX package's
    ``_LitTable``."""

    def __init__(self, w: int):
        self.w = w
        self.index: dict[bytes, int] = {}

    def register(self, data: bytes) -> int:
        if len(data) > self.w:
            raise NotTurbo(f"literal longer than slot width: {data[:32]!r}…")
        if data not in self.index:
            self.index[data] = len(self.index)
        return self.index[data]

    def array(self) -> np.ndarray:
        table = np.zeros((max(len(self.index), 1), self.w), np.uint8)
        for data, i in self.index.items():
            table[i, :len(data)] = np.frombuffer(data, np.uint8)
        return table

    def lengths(self) -> np.ndarray:
        lens = np.zeros((max(len(self.index), 1),), np.int32)
        for data, i in self.index.items():
            lens[i] = len(data)
        return lens

    def collect(self, instrs) -> None:
        p = planner
        for ins in instrs:
            if isinstance(ins, p.IForHead):
                for _slot, elems in ins.pairs:
                    for kind, v in elems:
                        if kind == "str":
                            self.register(v)
            elif isinstance(ins, p.ISet):
                self._collect_item(ins.src)
            elif isinstance(ins, p.IListNew):
                for e in ins.elems:
                    self._collect_item(e)
            elif isinstance(ins, (p.IListAppend, p.IListRemove)):
                self._collect_item(ins.item)
            elif isinstance(ins, p.IListJoin):
                self._collect_tmpl(ins.before)
                self._collect_tmpl(ins.between)
                self._collect_tmpl(ins.after)
            elif isinstance(ins, p.IPrint):
                self._collect_tmpl(ins.tmpl)
            elif isinstance(ins, p.IGotoMap):
                self._collect_tmpl(ins.tmpl)
                for pat, _tpc in ins.entries:
                    for part in pat[1:]:
                        self.register(part)
        # the JAX package registers no list_index template (its kernel
        # build then fails on the literal); register them after every JAX
        # row, so the rows above stay the JAX package's
        for ins in instrs:
            if isinstance(ins, p.IListIndex) and ins.index[0] == "tmpl":
                self._collect_tmpl(ins.index[1])

    def _collect_item(self, src) -> None:
        if src[0] == "str":
            self.register(src[1])
        elif src[0] == "tmpl":
            self._collect_tmpl(src[1])

    def _collect_tmpl(self, tmpl):
        for seg in tmpl:
            if isinstance(seg, planner.Lit):
                self.register(seg.data)


class TurboBatch(NamedTuple):
    regs: torch.Tensor   # (N, REGW) int32
    sbuf: torch.Tensor   # (R, N, W) uint8
    out: torch.Tensor    # (N, OW) uint8
    meta: torch.Tensor   # (M, N, 3E) int32


def _meta_rows(cols: _Cols) -> list:
    """The sbuf row of each meta plane, in plane order."""
    return [cols.meta_row[s] for s in sorted(cols.list_ord,
                                             key=cols.list_ord.get)]


def from_jax_batch(cols: _Cols, regs, sbuf, out, *, device) -> TurboBatch:
    """The JAX package's TurboBatch (as numpy: int32 regs, int32 byte
    planes) as the port's tensors on ``device``. Lanes [0, 3E) of each
    list slot's meta row move into ``meta``; the row itself stays zero.

    A batch sharded over a JAX mesh needs no converter of its own: gathered
    to the host (``jax.device_get``) it is one numpy batch, which this
    function carries across and ``parallel.mesh.shard_turbo_batch`` splits
    over the port's mesh."""
    sbuf = np.array(sbuf, np.int32)
    rows = _meta_rows(cols)
    meta = sbuf[rows, :, :3 * cols.E].copy()
    sbuf[rows] = 0
    return TurboBatch(
        regs=torch.from_numpy(np.array(regs, np.int32)).to(device),
        sbuf=torch.from_numpy(sbuf.astype(np.uint8)).to(device),
        out=torch.from_numpy(np.array(out, np.uint8)).to(device),
        meta=torch.from_numpy(meta).to(device))


def to_jax_batch(cols: _Cols, batch: TurboBatch) -> tuple:
    """The reverse of ``from_jax_batch``: numpy int32 (regs, sbuf, out)."""
    regs, sbuf, out = (t.cpu().numpy().astype(np.int32)
                       for t in batch[:3])
    sbuf[_meta_rows(cols), :, :3 * cols.E] = batch.meta.cpu().numpy()
    return regs, sbuf, out


def tables_on(plan_tables, devices) -> dict:
    """The plan's host ``TurboTables`` as ``StepTables`` on each distinct
    device, once."""
    return {dev: StepTables.on(plan_tables, dev)
            for dev in dict.fromkeys(devices)}


def build_sharded_step_fn(plan_tables, tcfg: TurboConfig, mesh):
    """The step over a mesh (the JAX package's ``build_sharded_step_fn``,
    ``vm/turbo.py:1991``): ``step(sharded) -> sharded`` launches the step
    kernel on every shard, in place. The plan's host ``TurboTables`` go to
    each distinct device of the mesh once (``step.tables``); shards on one
    device share them."""
    tables = tables_on(plan_tables, make_mesh(devices=mesh))
    k, tile = tcfg.k_steps, tcfg.tile

    def step(batch: ShardedTurboBatch) -> ShardedTurboBatch:
        return sharded_turbo_step(tables, batch, k, tile)
    step.tables = tables
    return step


class TurboEncodeError(ValueError):
    """State no longer fits the static slot model (long string, new key,
    list value)."""


@dataclass
class InstanceResult:
    """One instance's final state; the fields of the JAX package's
    ``vm/driver.py`` InstanceResult."""
    output: str
    inserts: dict
    status: int
    steps: int
    error: Optional[str] = None


_MISS = object()


def _drive_sync(fn):
    """Wrap an async backend method declared ``sync_io`` into a plain call
    (the JAX package's ``_drive_sync``, ``vm/turbo.py:2036``): drive the
    coroutine one slice; completing within it is the declared contract, and
    a suspension violates it."""
    def call(prompt, default=""):
        coro = fn(prompt, default)
        try:
            coro.send(None)
        except StopIteration as si:
            return si.value
        coro.close()
        raise RuntimeError(
            "backend declares sync_io=True but user_input suspended")
    return call


def _column_writer(regs: torch.Tensor, mask):
    """``put(c, v)``: register column c := v on the rows of the bool
    ``mask`` (every row when it is None), in place; v is a scalar or one
    value per row."""
    def put(c: int, v) -> None:
        v = torch.as_tensor(v, dtype=torch.int32, device=regs.device)
        if mask is None:
            regs[:, c] = v
        else:
            regs[:, c] = torch.where(mask, v, regs[:, c])
    return put


class TurboEngine:
    """Run one turbo-planned program over a batch of instances on
    ``device``: CUDA tensors go through the hand-written step kernel, CPU
    tensors through its plain PyTorch version.

    The ring is the JAX package's: each round the vectorized fast path
    services what it can (``_classify_parked``, ``_fast_service``,
    ``_fast_cancel``: one small column download, the backend calls, device
    writes), and the exact slow path the rest: one gather of those parked
    rows, exact host service per row (through the shared LaneRing for a row
    parked inside a parallel block), one scatter back. ``IE_TPU_FAST_RING=0``
    sends every park through the exact path.

    Known decode-order divergence (as in the JAX package): decoded insert
    dicts list keys in static slot order, not dynamic first-write order.

    Exactly one of ``device`` and ``mesh`` (a sequence of devices, see
    ``parallel.mesh.make_mesh``) places the batch. ``plan``, ``lanering``
    and ``step_tables`` (a sibling's, for the same ``tcfg`` and devices)
    let sibling engines share one plan, one LaneRing and one copy of the
    device tables; ``instance_ids`` maps this engine's rows to the
    LaneRing's global instance ids (the row itself by default).
    ``promote_factor`` is how much wider (width, out_width, elem_width) the
    sibling batch is that takes instances outgrowing their slots; 0 turns
    promotion off, as in that sibling itself. On a card, a ``tcfg`` whose
    one instance does not fit a block's shared memory beside the step
    tables raises ``NotTurbo`` (``step_fits``), as a program the planner
    rejects does; the check runs where the tables are built, so tables
    handed in have passed it.
    """

    def __init__(self, compiled, tcfg: TurboConfig = None, io_factory=None,
                 *, device=None, mesh=None, plan=None, lanering=None,
                 instance_ids=None, step_tables=None,
                 promote_factor: int = 4):
        if (device is None) == (mesh is None):
            raise TypeError("TurboEngine takes exactly one of device= and "
                            "mesh=")
        if context.CTX.inserts_dir:
            raise NotTurbo("--inserts-dir fallback needs the general engine")
        self.compiled = compiled
        self.plan = plan or planner.plan_turbo(compiled)
        self.tcfg = tcfg or TurboConfig()
        self.cols = _make_cols(self.plan, self.tcfg)
        self.mesh = None if mesh is None else make_mesh(devices=mesh)
        self.device = torch.device(device) if mesh is None else self.mesh[0]
        devices = self.mesh or (self.device,)
        if step_tables is None:
            host = _plan_tables(self.plan, self.cols, self.tcfg)
            if not step_fits(self.device, self.cols, self.tcfg, host):
                raise NotTurbo(f"one instance at {self.tcfg} does not fit a "
                               f"block's shared memory on {self.device}")
            step_tables = tables_on(host, devices)
        elif set(step_tables) != set(devices):
            raise ValueError(f"step_tables on {list(step_tables)}, the "
                             f"engine on {list(dict.fromkeys(devices))}")
        self.step_tables = step_tables
        self.tables = step_tables[self.device]
        self.io_factory = io_factory or (lambda i: io_manager.IOManager(
            io_manager.BufferBackend()))
        self._slot_keys = list(self.plan.slot_names)
        self._lanering = lanering if lanering is not None \
            else lanering_mod.LaneRing(compiled)
        self.instance_ids = instance_ids
        self._ios: dict = {}
        # output spill: instance → (drained_output, clear_epoch). When a
        # row's output outgrows the device buffer the ring drains it here;
        # a stale epoch (an in-kernel `clear` ran since) voids the prefix.
        self._out_prefix: dict = {}
        # fast_parks: parks the vectorized fast path serviced; escapes:
        # instances queued for a promotion (or an escape)
        self.ring_stats = {"rounds": 0, "parks": 0, "escapes": 0,
                           "fast_parks": 0, "parks_by_kind": {},
                           "ring_ms": 0.0}
        self._n_live = 0
        # promotion: instance → record (_queue_promotion); the sibling's
        # results of migrated instances; the sibling runs in flight; every
        # row that left this batch (its lane IO is the sibling's now)
        self.promote_factor = promote_factor
        self._promote_states: dict = {}
        self._escape_states: dict = {}
        self._escape_results: dict = {}
        self._promo_tasks: list = []
        self._migrated: set = set()
        # the general-engine runners of this run's escapes
        self.escape_runners: list = []
        # the promotion sibling, decided at the first promotion:
        # (TurboConfig, its host TurboTables) or (None, None)
        self._wide = None
        self._wide_tables = None    # the siblings' StepTables, built once
        # the vectorized fast park path (read as the JAX package reads it)
        self._fast_enabled = os.environ.get("IE_TPU_FAST_RING", "1") != "0"
        self._fast_tables = None
        self._fast_call: dict = {}   # row → bound sync call | None
        self._fast_call_ok = None    # (n,) int8: 1 sync, -1 no, 0 unknown
        self._cancel_ok = None       # (n,) int8: empty_choice_pure probe
        self._meta_idx: dict = {}    # device → _meta_cols as a tensor

    # ---- batch lifecycle ---------------------------------------------------

    def make_batch(self, n: int, args: list = ()):
        """N fresh instances: one prototype row, encoded on the host and
        broadcast on the device. Nothing is padded: the kernel masks the
        ragged last tile itself. Under a mesh, a ``ShardedTurboBatch``
        split over its devices."""
        ctx = context
        inserts = dict(self.compiled.program["default_state"]["inserts"])
        for i, arg in enumerate(args, start=1):
            inserts[f"ARG{i}"] = (
                str(arg).replace(ctx.INSERT_START,
                                 ctx.ESCAPE + ctx.INSERT_START)
                        .replace(ctx.INSERT_STOP,
                                 ctx.ESCAPE + ctx.INSERT_STOP))
        row = self._encode_row(inserts, output="", pc=0, steps=0)
        dev = self.device

        def bcast(a: np.ndarray, shape) -> torch.Tensor:
            return torch.from_numpy(a).to(dev).expand(shape).contiguous()

        self._n_live = n
        self._reset_run_state()
        regs, sbuf, out, meta = batch_shapes(self.cols, self.tcfg, n)
        batch = TurboBatch(regs=bcast(row["regs"][None], regs),
                           sbuf=bcast(row["sbuf"][:, None, :], sbuf),
                           out=bcast(row["out"][None], out),
                           meta=bcast(row["meta"][:, None, :], meta))
        if self.mesh is None:
            return batch
        return shard_turbo_batch(batch, self.mesh)

    def _reset_run_state(self) -> None:
        self._out_prefix.clear()
        self._promote_states.clear()
        self._escape_states.clear()
        self._escape_results.clear()
        self._migrated.clear()
        self.escape_runners.clear()

    def _encode_slot(self, regs: np.ndarray, sbuf: np.ndarray,
                     meta: np.ndarray, key, value) -> None:
        """Encode ONE insert value into its slot's register cells, byte rows
        and meta plane, in place (regs: (REGW,), sbuf: (R, W), meta:
        (M, 3E); the caller guarantees the slot's cells and rows are
        zeroed). Values that violate the plan's slot-kind or element-kind
        inference raise."""
        w = self.tcfg.width
        cols = self.cols
        s = self.plan.slot_of.get(str(key))
        if s is None:
            raise TurboEncodeError(f"key {key!r} has no slot")
        if isinstance(value, bool) or \
                not isinstance(value, (int, str, list)):
            raise TurboEncodeError(f"value of {key!r} is not "
                                   f"int/str/list")
        if isinstance(value, int):
            if not (-2**31 <= value < 2**31):
                raise TurboEncodeError(f"int {key!r} exceeds int32")
            if cols.kind(s) in ("str", "none", "list"):
                raise TurboEncodeError(
                    f"int value in non-int slot {key!r}")
            regs[cols.stype(s)] = T_INT
            regs[cols.sint(s)] = value
        elif isinstance(value, list):
            if cols.kind(s) != "list":
                raise TurboEncodeError(
                    f"list value in scalar slot {key!r}")
            if len(value) > cols.E:
                raise TurboEncodeError(
                    f"list {key!r} exceeds {cols.E} elements")
            regs[cols.stype(s)] = T_LIST
            regs[cols.slen(s)] = len(value)
            cells = meta[cols.list_ord[s]]
            ek = cols.ekind(s)
            for e, elem in enumerate(value):
                if isinstance(elem, bool) or \
                        not isinstance(elem, (int, str)):
                    raise TurboEncodeError(
                        f"element of {key!r} is not int/str")
                if (isinstance(elem, int) and ek == "str") or \
                        (isinstance(elem, str) and ek == "int"):
                    raise TurboEncodeError(
                        f"element kind of {key!r} violates the "
                        f"plan ({ek}-only list)")
                if isinstance(elem, int):
                    if not (-2**31 <= elem < 2**31):
                        raise TurboEncodeError(
                            f"element of {key!r} exceeds int32")
                    cells[e] = T_INT
                    cells[cols.E + e] = elem
                else:
                    data = elem.encode("utf-8")
                    if len(data) > cols.ew:
                        raise TurboEncodeError(
                            f"element of {key!r} exceeds {cols.ew}B")
                    cells[e] = T_STR
                    cells[2 * cols.E + e] = len(data)
                    row, off = cols.elem_pos(s, e)
                    sbuf[row, off:off + len(data)] = \
                        np.frombuffer(data, np.uint8)
        else:
            data = value.encode("utf-8")
            if len(data) > w:
                raise TurboEncodeError(f"string {key!r} exceeds {w}B")
            if s not in cols.str_row:
                raise TurboEncodeError(
                    f"string value in int-only slot {key!r}")
            regs[cols.stype(s)] = T_STR
            regs[cols.slen(s)] = len(data)
            sbuf[cols.str_row[s], :len(data)] = \
                np.frombuffer(data, np.uint8)

    def _zero_slot(self, regs: np.ndarray, sbuf: np.ndarray,
                   meta: np.ndarray, s: int) -> None:
        """Zero slot s's register cells, byte rows and meta plane (the
        encode invariant: bytes and cells past a value's length are
        zero)."""
        cols = self.cols
        regs[cols.stype(s)] = 0
        regs[cols.sint(s)] = 0
        regs[cols.slen(s)] = 0
        if s in cols.str_row:
            sbuf[cols.str_row[s], :] = 0
        if s in cols.list_ord:
            meta[cols.list_ord[s], :] = 0
            r0 = cols.list_row0[s]
            sbuf[r0:r0 + cols.elem_rows, :] = 0

    def _encode_row(self, inserts: dict, output: str, pc: int,
                    steps: int) -> dict:
        """Encode one instance's state into per-field numpy rows."""
        cols = self.cols
        regs = np.zeros((cols.regw,), np.int32)
        regs[C_PC] = pc
        regs[C_STATUS] = RUNNING
        regs[C_STEPS] = steps
        sbuf = np.zeros((cols.n_rows, self.tcfg.width), np.uint8)
        meta = np.zeros((len(cols.list_ord), 3 * cols.E), np.int32)
        out = np.zeros((self.tcfg.out_width,), np.uint8)
        for key, value in inserts.items():
            self._encode_slot(regs, sbuf, meta, key, value)
        out_data = output.encode("utf-8")
        if len(out_data) > self.tcfg.out_width:
            raise TurboEncodeError("output exceeds the device buffer")
        out[:len(out_data)] = np.frombuffer(out_data, np.uint8)
        regs[C_OUTLEN] = len(out_data)
        return {"regs": regs, "sbuf": sbuf, "out": out, "meta": meta}

    def _decode_row(self, sub: dict, j: int, i: int = None) -> dict:
        """Row j of a host copy (regs and meta int32, sbuf and out uint8)
        as a reference-format ``{"inserts", "output"}`` dict; instance i's
        spilled output prefix is folded in."""
        cols = self.cols
        regs = sub["regs"][j]
        inserts = {}
        for s, key in enumerate(self._slot_keys):
            vt = int(regs[cols.stype(s)])
            if vt == T_INT:
                inserts[key] = int(regs[cols.sint(s)])
            elif vt == T_STR:
                ln = int(regs[cols.slen(s)])
                row = cols.str_row[s]
                inserts[key] = sub["sbuf"][row, j, :ln].tobytes().decode(
                    "utf-8", "replace")
            elif vt == T_LIST:
                count = int(regs[cols.slen(s)])
                cells = sub["meta"][cols.list_ord[s], j]
                elems = []
                for e in range(min(count, cols.E)):
                    if int(cells[e]) == T_INT:
                        elems.append(int(cells[cols.E + e]))
                    else:
                        el = int(cells[2 * cols.E + e])
                        row, off = cols.elem_pos(s, e)
                        elems.append(
                            sub["sbuf"][row, j, off:off + el].tobytes()
                            .decode("utf-8", "replace"))
                inserts[key] = elems
        ln = int(regs[C_OUTLEN])
        output = sub["out"][j, :ln].tobytes().decode("utf-8", "replace")
        if i is not None and i in self._out_prefix:
            text, epoch = self._out_prefix[i]
            if epoch == int(regs[C_CLREPOCH]):
                output = text + output
            else:
                # an in-kernel clear ran after the drain — prefix is dead
                del self._out_prefix[i]
        return {"inserts": inserts, "output": output}

    # ---- save/load (reference-format state dicts) ----------------------------

    def export_state(self, batch, i: int) -> dict:
        """Instance i as the reference's runtime-state dict, its spilled
        output folded in, with the cursor chains rebuilt from (pc, loop
        columns); inside a parallel block, one chain per lane from the
        lane columns, which map one to one onto the general engine's
        thread fields. The same contract as ``DeviceRunner.export_state``,
        so a turbo save loads on either engine and on the host."""
        from .driver import emit_cursors, emit_par_cursors
        sub, _ = self._gather_sub(batch, np.asarray([i]))
        state = self._decode_row(sub, 0, i)
        regs, cols = sub["regs"][0], self.cols
        pc = min(int(regs[C_PC]), self.compiled.n_instr - 1)
        counters = regs[cols._loops0:cols._loops0 + cols.n_loops]
        if int(regs[C_PARMODE]) > 0:
            st = {"pc": int(regs[C_PC]), "status": int(regs[C_STATUS]),
                  "cur_tid": int(regs[C_CURTID]),
                  "par_join": int(regs[C_PARJOIN]),
                  "tpc": [regs[cols.tpc(lane)] for lane in range(cols.nt)],
                  "tstate": [regs[cols.tstate(lane)]
                             for lane in range(cols.nt)]}
            emit_par_cursors(self.compiled, state, st, counters)
        else:
            emit_cursors(self.compiled, state, pc, counters)
        return state

    def load_state(self, state: dict, i: int = None) -> dict:
        """A reference-format state dict as one turbo row (regs, sbuf, out,
        meta): the cursor chain resolves to a pc and the for-counters land
        in the loop columns. An output longer than ``out_width // 2`` goes
        to instance i's host-side spill. A state saved inside a parallel
        block re-seeds its lanes as ``IParBegin`` would, at their saved
        resume pcs (the host re-runs the block: lanes with cursors resume,
        the others restart)."""
        from .driver import pc_of_state
        cols = self.cols
        counters = np.zeros((max(cols.n_loops, 1),), np.int32)
        pc, leftovers, par = pc_of_state(self.compiled, state, counters)
        if leftovers:
            raise ValueError(
                f"state has block cursors below a host-op task "
                f"{sorted(leftovers)}; resume requires the host engine")
        if par is not None and par["k"] > cols.nt:
            raise ValueError(
                f"state resumes a parallel block with {par['k']} lanes; "
                f"this plan carries {cols.nt}")
        output = state.get("output", "")
        if i is not None and \
                len(output.encode("utf-8")) > self.tcfg.out_width // 2:
            self._out_prefix[i] = (output, 0)   # a fresh row's clear epoch
            output = ""
        row = self._encode_row(dict(state.get("inserts", {})), output, pc, 0)
        regs = row["regs"]
        regs[cols._loops0:cols._loops0 + cols.n_loops] = \
            counters[:cols.n_loops]
        if par is not None:
            regs[C_PARMODE] = par["mode"]
            regs[C_PARJOIN] = par["join_pc"]
            regs[C_CURTID] = 0
            regs[C_PC] = par["tpc"][0]
            for lane in range(cols.nt):
                live = lane < par["k"]
                regs[cols.tpc(lane)] = par["tpc"][lane] if live else 0
                regs[cols.tstate(lane)] = T_NEW if live else T_FREE
                regs[cols.tparg(lane)] = 0
        return row

    @staticmethod
    def _canon(v):
        """A type-faithful structural key: ``json.dumps`` would merge a
        tuple with a list, a bool with an int and ``np.int32(3)`` with
        ``3``, and so accept a state the encoder must reject."""
        if isinstance(v, dict):
            return ("d", tuple(sorted((repr(k), TurboEngine._canon(x))
                                      for k, x in v.items())))
        if isinstance(v, (list, tuple)):
            return (type(v).__name__, tuple(TurboEngine._canon(x)
                                            for x in v))
        return (type(v).__name__, repr(v))

    def load_batch(self, states: list):
        """A batch resuming the given reference-format states, one instance
        each. States are deduplicated by structural identity first (a
        rollout resumes thousands of instances from a handful of states):
        the U distinct rows are encoded and uploaded once, then expanded on
        the device by an index gather; a duplicate with a long output gets
        its own spill. Under a mesh, a ``ShardedTurboBatch``. Recorded as
        a ``turbo.load_batch`` span."""
        with events.EVENTS.span("turbo.load_batch"):
            return self._load_batch(states)

    def _load_batch(self, states: list):
        self._reset_run_state()
        uniq: list = []
        seen: dict = {}
        index = []
        for j, st in enumerate(states):
            key = repr(self._canon(st))
            u = seen.get(key)
            if u is None:
                u = seen[key] = len(uniq)
                uniq.append(self.load_state(st, i=j))
            elif len(st.get("output", "").encode("utf-8")) > \
                    self.tcfg.out_width // 2:
                self._out_prefix[j] = (st.get("output", ""), 0)
            index.append(u)
        self._n_live = len(states)
        dev = self.device

        def up(field, axis):
            return torch.from_numpy(np.stack([r[field] for r in uniq],
                                             axis=axis)).to(dev)
        idx = torch.tensor(index, dtype=torch.int64, device=dev)
        batch = TurboBatch(
            regs=up("regs", 0).index_select(0, idx),
            sbuf=up("sbuf", 1).index_select(1, idx),
            out=up("out", 0).index_select(0, idx),
            meta=up("meta", 1).index_select(1, idx))
        if self.mesh is None:
            return batch
        return shard_turbo_batch(batch, self.mesh)

    # ---- stepping -----------------------------------------------------------

    def step_fn(self, n: int):
        """``step(batch) -> batch``: k_steps VM steps on every RUNNING lane
        of an n-row batch, updating its tensors in place (the TPU's
        ``input_output_aliases``); under a mesh, on every shard. Each call
        is recorded as a ``turbo.launch`` span."""
        tables, k, tile = self.tables, self.tcfg.k_steps, self.tcfg.tile

        def step(batch):
            with events.EVENTS.span("turbo.launch"):
                return launch(batch)

        def launch(batch):
            if _n_rows(batch) != n:
                raise ValueError(f"step built for {n} rows, got "
                                 f"{_n_rows(batch)}")
            if isinstance(batch, ShardedTurboBatch) != (self.mesh
                                                        is not None):
                raise ValueError("a sharded batch needs an engine over a "
                                 "mesh, and the reverse")
            if self.mesh is not None:
                return sharded_turbo_step(self.step_tables, batch, k, tile)
            return turbo_step(tables, batch, k, tile)
        return step

    # ---- host ring -----------------------------------------------------------

    @property
    def instance_ids(self):
        return self._instance_ids

    @instance_ids.setter
    def instance_ids(self, ids) -> None:
        self._instance_ids = list(ids) if ids else None
        self._row_index = None if self._instance_ids is None else {
            g: r for r, g in enumerate(self._instance_ids)}

    def _gid(self, row: int) -> int:
        """Global instance id of a batch row, the LaneRing's key."""
        return self._instance_ids[row] if self._instance_ids else row

    def _row_of(self, gid: int, n: int):
        """Batch row of a global id, or None when a sibling engine owns it
        or the batch has no such row."""
        if self._instance_ids is not None:
            return self._row_index.get(gid)
        return gid if 0 <= gid < n else None

    def _io_for(self, i: int):
        io = self._ios.get(i)
        if io is None:
            io = self._ios[i] = self.io_factory(i)
        return io

    def _runtime_for(self, i: int, rts: dict):
        return rts.setdefault(i, executor.Runtime(
            self._io_for(i),
            self.compiled.program.get("completion_args", {}),
            self.compiled.program.get("named_tasks", {})))

    # ---- the vectorized fast park path ---------------------------------------

    def _build_fast_tables(self):
        """Static per-pc fast-service eligibility, on the host (the JAX
        package's ``_build_fast_tables``, ``vm/turbo.py:2611``):
        ``fast_top[pc]``, a user_input park with a literal prompt and a
        literal output name whose slot has a string row; ``fast_drain[pc]``,
        such a park that is also its lane's last task (the next row is
        OP_THREAD_END), so a drained race completes right after it;
        ``cancel_any[pc]``, a literal await_insert, and ``cancel_pure[pc]``,
        an empty user_choice (on a backend that declares
        ``empty_choice_pure``), where the LaneRing cancels a drained race's
        one waiting lane with no state write (a lane parks at an await only
        while its key is missing, so the cancel always lands). ``sites``
        maps each fast pc to (prompt, out slot)."""
        if self._fast_tables is not None:
            return self._fast_tables
        P = self.plan.n_instr
        fast_top = np.zeros((P,), bool)
        fast_drain = np.zeros((P,), bool)
        cancel_any = np.zeros((P,), bool)
        cancel_pure = np.zeros((P,), bool)
        sites: dict = {}
        code = self.compiled.code

        def literal(s) -> bool:
            return isinstance(s, str) and not any(c in s for c in "{}\\")
        for pc, kind in self.plan.park_kind_of.items():
            task = self.compiled.source_tasks[pc]
            if kind == vm_config.PARK_AWAIT_INSERT:
                if literal(task.get("name") if task else None):
                    cancel_any[pc] = True
                continue
            if kind == vm_config.PARK_USER_CHOICE and task and \
                    task.get("cmd") == "user_choice" and \
                    task.get("list") == []:
                cancel_pure[pc] = True
                continue
            if kind != vm_config.PARK_USER_INPUT or not task or \
                    task.get("cmd") != "user_input":
                continue
            name, prompt = task.get("output_name"), task.get("prompt")
            if not (literal(name) and literal(prompt)):
                continue
            out_slot = self.plan.slot_of.get(name)
            if out_slot is None or out_slot not in self.cols.str_row:
                continue
            sites[pc] = (prompt, out_slot)
            fast_top[pc] = True
            if pc + 1 < len(code) and \
                    int(code[pc + 1][0]) == isa.OP_THREAD_END:
                fast_drain[pc] = True
        self._fast_tables = (fast_top, fast_drain, sites, cancel_any,
                             cancel_pure)
        return self._fast_tables

    def _fast_ready(self) -> bool:
        """Whether this round may take the fast path at all: it is on, the
        program has a fast site, and no log or event sink wants the
        per-park records only the exact path writes."""
        if not self._fast_enabled:
            return False
        _, _, sites, cancel_any, cancel_pure = self._build_fast_tables()
        return bool(sites or cancel_any.any() or cancel_pure.any()) and \
            not context.log_enabled() and not events.EVENTS.enabled

    def _meta_cols(self) -> list:
        # C_STATUS leads, so one download serves the round's liveness check
        # and the classification
        cols = [C_STATUS, C_PC, C_PARMODE]
        cols += [self.cols.tstate(l) for l in range(self.cols.nt)]
        cols += [self.cols.tparg(l) for l in range(self.cols.nt)]
        return cols

    def _meta_full(self, batch) -> np.ndarray:
        """The ``_meta_cols`` of every row on the host, one download per
        shard: uint8 while every pc fits a byte (status, modes and lane
        states always do), else int32."""
        dtype = torch.uint8 if self.plan.n_instr < 256 else torch.int32
        parts = []
        for shard, _, _ in _shards(batch):
            dev = shard.regs.device
            idx = self._meta_idx.get(dev)
            if idx is None:
                idx = self._meta_idx[dev] = torch.tensor(
                    self._meta_cols(), dtype=torch.int64, device=dev)
            parts.append(shard.regs.index_select(1, idx).to(dtype)
                         .to("cpu").numpy())
        return np.concatenate(parts)

    def _fast_call_avail(self, parked: np.ndarray, n: int) -> np.ndarray:
        """Per-row sync-call availability (1: a sync user_input call, -1:
        none, 0: not resolved yet). Each row is resolved once, through its
        IO manager's backend; after that this is a numpy slice."""
        ok = self._fast_call_ok
        if ok is None or len(ok) != n:
            ok = self._fast_call_ok = np.zeros((n,), np.int8)
        calls = self._fast_call
        for i in parked[ok[parked] == 0].tolist():
            call = calls.get(i, _MISS)
            if call is _MISS:
                b = getattr(self._io_for(i), "backend", None)
                call = getattr(b, "user_input_sync", None)
                if call is None and getattr(b, "sync_io", False):
                    call = _drive_sync(b.user_input)
                calls[i] = call
            ok[i] = 1 if call is not None else -1
        return ok

    def _cancel_avail(self, parked: np.ndarray, n: int) -> np.ndarray:
        """Per-row consent to cancel an empty user_choice lane on the device:
        the backend declares ``empty_choice_pure`` (its wait on an empty
        list has no effect before it suspends)."""
        ok = self._cancel_ok
        if ok is None or len(ok) != n:
            ok = self._cancel_ok = np.zeros((n,), np.int8)
        for i in parked[ok[parked] == 0].tolist():
            b = getattr(self._io_for(i), "backend", None)
            ok[i] = 1 if getattr(b, "empty_choice_pure", False) else -1
        return ok

    def _classify_parked(self, batch, parked: np.ndarray,
                         meta_np: np.ndarray = None):
        """Split the parked rows into fast site groups ({site pc: rows}),
        drain cancels ((rows, waiting-lane pcs)) and the exact remainder.
        Fast needs a fast site (a top-level park there, or a drained race
        with one waiting lane, parked at a lane-final site), a sync
        backend, no log or event sink and no pending lane IO for the
        instance. Numpy over ``meta_np`` (``_meta_full``); no per-row
        Python once each row's backend is resolved."""
        none = (np.zeros((0,), np.int64), np.zeros((0,), np.int64))
        if len(parked) == 0 or not self._fast_ready():
            return {}, none, parked
        fast_top, fast_drain, _, cancel_any, cancel_pure = \
            self._build_fast_tables()
        has_cancel = bool(cancel_any.any() or cancel_pure.any())
        k = len(parked)
        n = _n_rows(batch)
        if meta_np is None:
            meta_np = self._meta_full(batch)
        meta = meta_np[parked].astype(np.int32)[:, 1:]     # drop C_STATUS
        P = self.plan.n_instr
        pcs, pm = meta[:, 0], meta[:, 1]
        top_mask = (pm == PM_NONE) & fast_top[np.clip(pcs, 0, P - 1)]
        site_pcs = np.where(top_mask, pcs, -1)
        nt = self.cols.nt
        cancel_mask = np.zeros((k,), bool)
        if nt:
            tst = meta[:, 2:2 + nt]
            targ = meta[:, 2 + nt:2 + 2 * nt]
            is_wait = tst == T_WAIT
            okstates = (is_wait | (tst == T_DONE) | (tst == T_FREE)).all(1)
            wl = is_wait.argmax(1)
            wpc = np.clip(targ[np.arange(k), wl], 0, P - 1)
            drainable = (pm == PM_DRAIN) & (is_wait.sum(1) == 1) & okstates
            dmask = drainable & fast_drain[wpc]
            site_pcs = np.where(dmask, wpc, site_pcs)
            fast_mask = top_mask | dmask
            if has_cancel:
                cancel_mask = drainable & cancel_any[wpc]
                pure = drainable & cancel_pure[wpc]
                if pure.any():
                    cancel_mask |= pure & (
                        self._cancel_avail(parked, n)[parked] == 1)
        else:
            wpc = np.zeros((k,), np.int64)
            fast_mask = top_mask
        fast_mask &= self._fast_call_avail(parked, n)[parked] == 1
        fast_mask &= ~cancel_mask
        pend = self._lanering.pending
        if pend and (fast_mask.any() or cancel_mask.any()):
            # pending lane IO sends a row down the exact path
            prows = [r for r in (self._row_of(g, n) for g in pend)
                     if r is not None]
            if prows:
                keep = ~np.isin(parked, prows)
                fast_mask &= keep
                cancel_mask &= keep
        groups: dict = {}
        fp = parked[fast_mask]
        if len(fp):
            sp = site_pcs[fast_mask]
            for pc in np.unique(sp):
                groups[int(pc)] = fp[sp == pc]
        cancels = (parked[cancel_mask], wpc[cancel_mask])
        return groups, cancels, parked[~(fast_mask | cancel_mask)]

    def _fast_resume(self, batch, out_slot: int, drain: bool,
                     uniq: np.ndarray, mi: np.ndarray = None) -> None:
        """The device-side resume of one fast site, in place on every shard
        (the JAX package's ``_fast_resume_fn`` and, with ``mi`` None, its
        lockstep ``_fast_resume_all_fn``, ``vm/turbo.py:2906-3029``).
        ``uniq`` (U, W+2) uint8 holds the deduped responses, each with its
        length little-endian in the last two columns; ``mi`` (n, 2) the
        rows' mask and index into ``uniq`` (None: every row, response 0).
        Each shard gets its slice of ``mi``: two uploads at most.

        The response goes into the out slot's string row, type and length.
        A top-level park resumes at pc + 1, one step on. A drained race
        completes as the exact ring and the thread end after it leave it:
        the waiting lane's saved pc one on, at the join, lanes freed,
        parallel registers cleared, epoch bumped, two steps on."""
        cols = self.cols
        w = self.tcfg.width
        for shard, off, size in _shards(batch):
            part = None if mi is None else mi[off:off + size]
            if part is not None and not part[:, 0].any():
                continue
            dev = shard.regs.device
            table = torch.from_numpy(uniq).to(dev)
            lens = table[:, w].int() + table[:, w + 1].int() * 256
            if part is None:
                m, rlen, res = None, lens[0], table[0, :w]
            else:
                part = torch.from_numpy(part).to(dev)
                m, inv = part[:, 0] != 0, part[:, 1].long()
                rlen, res = lens[inv], table[inv, :w]
            regs = shard.regs
            put = _column_writer(regs, m)
            if drain:
                for l in range(cols.nt):
                    waiting = regs[:, cols.tstate(l)] == T_WAIT
                    put(cols.tpc(l), regs[:, cols.tpc(l)] + waiting.int())
                    put(cols.tstate(l), T_FREE)
                put(C_PC, regs[:, C_PARJOIN])
                put(C_STEPS, regs[:, C_STEPS] + 2)
                put(C_CURTID, -1)
                put(C_PARMODE, PM_NONE)
                put(C_PARJOIN, 0)
                put(C_PAREPOCH, regs[:, C_PAREPOCH] + 1)
            else:
                put(C_PC, regs[:, C_PC] + 1)
                put(C_STEPS, regs[:, C_STEPS] + 1)
            put(C_STATUS, RUNNING)
            put(cols.stype(out_slot), T_STR)
            put(cols.sint(out_slot), 0)
            put(cols.slen(out_slot), rlen)
            row = shard.sbuf[cols.str_row[out_slot]]
            if m is None:
                row.copy_(res.expand_as(row))
            else:
                row.copy_(torch.where(m[:, None], res, row))

    def _fast_cancel(self, batch, rows: np.ndarray,
                     wpcs: np.ndarray) -> None:
        """The drain cancel on the device, in place (the JAX package's
        ``_fast_cancel_fn`` and ``_fast_cancel``, ``vm/turbo.py:2753-2820``):
        for ``rows``, each a drained race whose one waiting lane (at
        ``wpcs``) the LaneRing would cancel, complete the block with no slot
        write: pc := join, RUNNING, one step on, lanes freed, parallel
        registers cleared, epoch bumped; as the exact ring leaves it."""
        n = _n_rows(batch)
        mask = np.zeros((n,), bool)
        mask[rows] = True
        for shard, off, size in _shards(batch):
            part = mask[off:off + size]
            if not part.any():
                continue
            regs = shard.regs
            put = _column_writer(regs, torch.from_numpy(part).to(
                regs.device))
            put(C_PC, regs[:, C_PARJOIN])
            put(C_STATUS, RUNNING)
            put(C_STEPS, regs[:, C_STEPS] + 1)
            put(C_CURTID, -1)
            put(C_PARMODE, PM_NONE)
            put(C_PARJOIN, 0)
            put(C_PAREPOCH, regs[:, C_PAREPOCH] + 1)
            for l in range(self.cols.nt):
                put(self.cols.tstate(l), T_FREE)
        # a user_choice lane ran its task's prefix (TASK_START) and its
        # park (VM_PARK) on the exact path before the cancel; an
        # await_insert lane spawns nothing
        kinds = [self.plan.park_kind_of.get(int(pc), 0) for pc in wpcs]
        n_choice = kinds.count(vm_config.PARK_USER_CHOICE)
        if n_choice:
            self._count_events(n_choice)
        self.ring_stats["fast_parks"] += len(rows)

    @staticmethod
    def _count_events(k: int) -> None:
        """Move the event counters as k exact parks of a task would; the
        fast path runs only with every sink off, so only counters move."""
        c = events.EVENTS.counters
        for kind in (events.TASK_START, events.VM_PARK):
            c[kind] = c.get(kind, 0) + k

    async def _fast_service(self, batch, groups: dict) -> int:
        """Service the fast site groups (the JAX package's
        ``_fast_service``, ``vm/turbo.py:3031``): each row's sync backend
        call (the one piece of per-row work), a dict dedup of the responses,
        one device resume per site. A response wider than the slot
        promotes its instance (``_promote_after_fast``). Returns the rows
        serviced."""
        ctx = context
        fast_drain, sites = self._build_fast_tables()[1:3]
        w = self.tcfg.width
        n = _n_rows(batch)
        n_done = 0
        for site_pc, rows in groups.items():
            prompt, out_slot = sites[site_pc]
            calls = self._fast_call
            rows_l = rows.tolist()
            results = [calls[i](prompt) for i in rows_l]
            self._count_events(len(rows_l))
            self.ring_stats["fast_parks"] += len(rows_l)
            n_done += len(rows_l)
            if len(set(results)) == 1:       # every row the same answer
                uniq, inv = {results[0]: 0}, None
            else:
                uniq, inv = {}, []
                for r in results:
                    u = uniq.get(r)
                    if u is None:
                        u = uniq[r] = len(uniq)
                    inv.append(u)
            enc, too_wide = [], set()
            for r, u in uniq.items():
                if not isinstance(r, str):
                    raise TypeError(f"sync backend returned non-str "
                                    f"user_input result {type(r).__name__}")
                data = (r.replace(ctx.INSERT_START,
                                  ctx.ESCAPE + ctx.INSERT_START)
                         .replace(ctx.INSERT_STOP,
                                  ctx.ESCAPE + ctx.INSERT_STOP)
                         .encode("utf-8"))
                if len(data) > w:
                    too_wide.add(u)
                    data = b""
                enc.append(data)
            if too_wide:
                inv_l = inv if inv is not None else [0] * len(rows_l)
                wide = [k for k, u in enumerate(inv_l) if u in too_wide]
                await self._promote_after_fast(
                    batch, [rows_l[k] for k in wide], site_pc,
                    [results[k] for k in wide])
                keep = [k for k, u in enumerate(inv_l) if u not in too_wide]
                rows_l = [rows_l[k] for k in keep]
                inv = [inv_l[k] for k in keep]
                if not rows_l:
                    continue
            table = np.zeros((len(enc), w + 2), np.uint8)
            for u, data in enumerate(enc):
                table[u, :len(data)] = np.frombuffer(data, np.uint8)
                table[u, w] = len(data) & 0xFF
                table[u, w + 1] = len(data) >> 8
            if len(rows_l) == n and len(enc) == 1:
                # lockstep: every row at this site with one response
                self._fast_resume(batch, out_slot, fast_drain[site_pc],
                                  table)
                continue
            mi = np.zeros((n, 2), np.uint8 if len(enc) <= 256 else np.int32)
            mi[rows_l, 0] = 1
            if inv is not None:
                mi[rows_l, 1] = inv
            self._fast_resume(batch, out_slot, fast_drain[site_pc], table,
                              mi)
        return n_done

    async def _promote_after_fast(self, batch, rows: list, site_pc: int,
                                  raw_results: list) -> None:
        """Fast-serviced responses too wide for their slot (the JAX
        package's ``_promote_after_fast``, ``vm/turbo.py:3130``, for several
        rows at once): the backend answered already, so the store is done
        on each decoded row on the host and the instance queued for
        promotion at the state the exact path would leave. For a drained
        race that is its waiting lane READY at the thread end, the block
        still open; the sibling runs the thread end."""
        ctx = context
        task = self.compiled.source_tasks[site_pc]
        # a site group's rows ascend, as _gather_sub needs
        sub, idx = self._gather_sub(batch, np.asarray(rows, np.int64))
        cols = self.cols
        lc0, lc1 = cols._loops0, cols._loops0 + cols.n_loops
        for j, (i, raw) in enumerate(zip(rows, raw_results)):
            state = self._decode_row(sub, j, i)
            state["inserts"][task["output_name"]] = (
                raw.replace(ctx.INSERT_START, ctx.ESCAPE + ctx.INSERT_START)
                   .replace(ctx.INSERT_STOP, ctx.ESCAPE + ctx.INSERT_STOP))
            regs = sub["regs"][j]
            par = None
            if int(regs[C_PARMODE]) == PM_DRAIN:
                lanes = range(cols.nt)
                tstate = regs[[cols.tstate(l) for l in lanes]].copy()
                tpc = regs[[cols.tpc(l) for l in lanes]].copy()
                cur = int(np.argmax(tstate == T_WAIT))
                tstate[cur], tpc[cur] = T_READY, site_pc + 1
                par = {"cur": cur, "mode": PM_DRAIN,
                       "join": int(regs[C_PARJOIN]), "tstate": tstate,
                       "tpc": tpc,
                       "tparg": regs[[cols.tparg(l) for l in lanes]].copy()}
            self._queue_promotion(sub, j, i, state, site_pc + 1,
                                  int(regs[C_STEPS]) + 1,
                                  regs[lc0:lc1].copy(), par,
                                  int(regs[C_PAREPOCH]))
        self._scatter_sub(batch, sub, idx)

    # ---- promotion to a wider sibling batch ----------------------------------

    def _queue_promotion(self, sub: dict, j: int, i: int, state: dict,
                         pc: int, steps: int, counters, par,
                         epoch: int) -> None:
        """Row j (instance i) outgrew this engine's widths: queue its state
        for the wider sibling (the JAX package's ``_queue_promotion``,
        ``vm/turbo.py:3188``), or, with promotion off, for an escape, and
        retire the row here; ``results`` reads the migrated result."""
        self._out_prefix.pop(i, None)
        rec = {"state": {"inserts": dict(state["inserts"]),
                         "output": state["output"]},
               "pc": int(pc), "steps": int(steps),
               "counters": np.asarray(counters, np.int32).copy(),
               "par": par, "epoch": int(epoch)}
        if self.promote_factor and self.promote_factor > 1:
            self._promote_states[i] = rec
        else:
            self._escape_states[i] = rec
        self._migrated.add(i)
        sub["regs"][j, C_STATUS] = DONE
        sub["regs"][j, C_PC] = self.plan.n_instr - 1

    def _row_from_record(self, rec: dict, i: int) -> dict:
        """A promotion record as one row of this engine (the sibling's
        side); raises TurboEncodeError when this engine cannot hold it
        either."""
        cols = self.cols
        output = rec["state"]["output"]
        spill = len(output.encode("utf-8")) > self.tcfg.out_width // 2
        row = self._encode_row(dict(rec["state"]["inserts"]),
                               "" if spill else output, rec["pc"],
                               rec["steps"])
        regs = row["regs"]
        lc0 = cols._loops0
        k = min(cols.n_loops, len(rec["counters"]))
        regs[lc0:lc0 + k] = rec["counters"][:k]
        regs[C_PAREPOCH] = rec["epoch"]
        par = rec["par"]
        if par is not None:
            regs[C_CURTID] = par["cur"]
            regs[C_PARMODE] = par["mode"]
            regs[C_PARJOIN] = par["join"]
            for l in range(cols.nt):
                regs[cols.tstate(l)] = par["tstate"][l]
                regs[cols.tpc(l)] = par["tpc"][l]
                regs[cols.tparg(l)] = par["tparg"][l]
        if spill:
            self._out_prefix[i] = (output, 0)   # a fresh row's clear epoch
        return row

    def _stack_rows(self, rows: list) -> TurboBatch:
        """Encoded rows as this engine's batch on its device."""
        def stack(key, axis):
            return torch.from_numpy(np.stack([r[key] for r in rows],
                                             axis=axis)).to(self.device)
        self._n_live = len(rows)
        return TurboBatch(regs=stack("regs", 0), sbuf=stack("sbuf", 1),
                          out=stack("out", 0), meta=stack("meta", 1))

    def _wide_tcfg(self):
        """The promotion sibling's TurboConfig, or None when there is no
        sibling: promotion is off, or the step does not take the sibling on
        this engine's device (its slots are wider than the kernel's, or one
        instance does not fit a block's shared memory). Decided at the
        first call; the host tables built for the fit are the sibling's."""
        if self._wide is not None:
            return self._wide[0]
        self._wide = (None, None)
        f, t = self.promote_factor, self.tcfg
        if not f or f <= 1:
            return None
        limit = step_max_width(self.device)
        if limit is not None and t.width * f > limit:
            return None
        wide = t.widened(f)
        cols = _make_cols(self.plan, wide)
        host = _plan_tables(self.plan, cols, wide)
        if step_fits(self.device, cols, wide, host):
            self._wide = (wide, host)
        return self._wide[0]

    async def _flush_promotions(self) -> None:
        """Run every queued promotion in one sibling batch, ``promote_factor``
        times wider in width, out_width and elem_width, with this engine's
        tile, device (a mesh's first), plan, LaneRing, cached IO managers
        (an instance keeps the backend that already answered it) and fast
        path switch, and promotion off. The siblings' step tables are built
        once. What even the sibling cannot hold, or every record when the
        card's kernel cannot take the sibling (``_wide_tcfg``), is queued
        for an escape."""
        if not self._promote_states:
            return
        tcfg = self._wide_tcfg()
        if tcfg is None:
            self._escape_states.update(self._promote_states)
            self._promote_states.clear()
            return
        if self._wide_tables is None:
            self._wide_tables = tables_on(self._wide[1], (self.device,))
        kept: list = []
        wide = TurboEngine(
            self.compiled, tcfg, io_factory=lambda r: self._io_for(kept[r]),
            device=self.device, plan=self.plan, lanering=self._lanering,
            step_tables=self._wide_tables, promote_factor=0)
        wide._fast_enabled = self._fast_enabled
        rows = []
        for i in sorted(self._promote_states):
            rec = self._promote_states.pop(i)
            try:
                rows.append(wide._row_from_record(rec, len(kept)))
                kept.append(i)
            except TurboEncodeError:
                self._escape_states[i] = rec
        if not rows:
            return
        wide.instance_ids = [self._gid(i) for i in kept]
        final = await wide.run_async(wide._stack_rows(rows))
        for i, res in zip(kept, wide.results(final, len(kept))):
            self._escape_results[i] = res

    def _escape_vmconfig(self, out_need: int, str_need: int):
        """A general-engine VMConfig that holds any state the turbo slot
        model holds, and the output (``out_need`` bytes) and longest string
        or element (``str_need``) of the escaping instances: max_str and
        out_size doubled until they hold twice those (the JAX package's
        ``_escape_vmconfig``, ``vm/turbo.py:3161``)."""
        cols, plan = self.cols, self.plan
        n_lists = max(len(cols.list_ord), 1)
        out_size = max(4096, 4 * self.tcfg.out_width)
        while out_size < 2 * out_need:
            out_size *= 2
        max_str = max(2 * self.tcfg.width, 512)
        while max_str < 2 * str_need:
            max_str *= 2
        return vm_config.VMConfig(
            max_str=max_str, max_key=64,
            n_slots=max(plan.n_slots + 16, 48),
            arena_size=max(16384,
                           2 * (plan.n_slots + cols.E * n_lists) * max_str),
            pool_size=max(96, 4 * cols.E * n_lists),
            out_size=out_size,
            max_loops=max(self.compiled.n_loops, 8),
            max_threads=max(plan.needs_threads, 8))

    def _escape_row(self, rec: dict, i: int, cfg) -> dict:
        """An escape record as one general-engine row. ``rng`` is the row
        index ``i`` in this engine, as in the JAX package; inside a
        parallel block the lanes carry over, a waiting lane with its park
        kind."""
        counters = np.zeros((cfg.max_loops,), np.int32)
        k = min(cfg.max_loops, len(rec["counters"]))
        counters[:k] = rec["counters"][:k]
        row = vs.encode_instance(dict(rec["state"]["inserts"]), cfg,
                                 output=rec["state"]["output"], pc=rec["pc"],
                                 counters=counters, rng=i,
                                 steps=rec["steps"])
        row["par_epoch"] = np.int32(rec["epoch"])
        par = rec["par"]
        if par is not None:
            for lane in range(min(len(par["tstate"]), cfg.max_threads)):
                row["tpc"][lane] = par["tpc"][lane]
                row["tstate"][lane] = par["tstate"][lane]
                row["tpark_arg"][lane] = par["tparg"][lane]
                if par["tstate"][lane] == T_WAIT:
                    row["tpark_kind"][lane] = self.plan.park_kind_of.get(
                        int(par["tparg"][lane]), vm_config.PARK_HOST_OP)
            row.update(cur_tid=np.int32(par["cur"]),
                       par_mode=np.int32(par["mode"]),
                       par_join=np.int32(par["join"]))
        return row

    async def _flush_escapes(self) -> None:
        """Run every queued escape in one batch of the general engine (the
        JAX package's ``_flush_escapes``, ``vm/turbo.py:3305``), on this
        engine's device (a mesh's first), with its LaneRing, its cached IO
        managers (an instance keeps the backend that already answered it)
        and the instances' global ids. A failure fails the run."""
        if not self._escape_states:
            return
        from .driver import DeviceRunner
        ids = sorted(self._escape_states)
        recs = [self._escape_states.pop(i) for i in ids]

        def str_need(rec) -> int:
            sizes = [0]
            for v in rec["state"]["inserts"].values():
                for e in (v if isinstance(v, list) else [v]):
                    if isinstance(e, str):
                        sizes.append(len(e.encode("utf-8")))
            return max(sizes)

        cfg = self._escape_vmconfig(
            max(len(r["state"]["output"].encode("utf-8")) for r in recs),
            max(str_need(r) for r in recs))
        runner = DeviceRunner(
            self.compiled, cfg, io_factory=lambda r: self._io_for(ids[r]),
            device=self.device, lanering=self._lanering,
            instance_ids=[self._gid(i) for i in ids])
        self.escape_runners.append(runner)
        batch = vs.stack_rows([self._escape_row(rec, i, cfg)
                               for i, rec in zip(ids, recs)], self.device)
        final = await runner.run_async(batch)
        for i, res in zip(ids, runner.results(final)):
            self._escape_results[i] = res

    # ---- the exact park path -------------------------------------------------

    async def _service_lanes(self, sub: dict, j: int, i: int,
                             rts: dict) -> bool:
        """Service row j (instance i), parked inside a parallel block,
        through the shared LaneRing (``vm/lanering.py``): waiting lanes get
        persistent host IO tasks, completions merge last-write-wins, and
        the instance resumes on the device at the next runnable lane or the
        block's join. Returns True when the row resumed."""
        cols = self.cols
        regs = sub["regs"][j]
        state = self._decode_row(sub, j, i)
        nt = cols.nt
        tstate = np.asarray([regs[cols.tstate(l)] for l in range(nt)],
                            np.int32)
        tpc = np.asarray([regs[cols.tpc(l)] for l in range(nt)], np.int32)
        tparg = np.asarray([regs[cols.tparg(l)] for l in range(nt)],
                           np.int32)
        tpark_kind = np.asarray(
            [self.plan.park_kind_of.get(int(tparg[l]), vm_config.PARK_HOST_OP)
             if int(tstate[l]) == vm_config.T_WAIT else 0
             for l in range(nt)], np.int32)
        lc0, lc1 = cols._loops0, cols._loops0 + cols.n_loops
        counters = np.asarray(regs[lc0:lc1]).copy()
        view = {"tstate": tstate, "tpc": tpc, "tpark_kind": tpark_kind,
                "tpark_arg": tparg, "counters": counters, "state": state,
                "cur": int(regs[C_CURTID]),
                "par_mode": int(regs[C_PARMODE]),
                "par_join": int(regs[C_PARJOIN]),
                "par_epoch": int(regs[C_PAREPOCH])}
        rt = self._runtime_for(i, rts)
        before = self._snapshot_inserts(state["inserts"])
        before_output = state["output"]
        res = await self._lanering.service(rt, self._gid(i), view,
                                           engine="turbo")
        if res == "parked":
            return False
        steps = int(regs[C_STEPS]) + 1
        if res == "complete":
            next_pc, par = view["par_join"], None
            epoch = view["par_epoch"] + 1
        else:
            next_pc = int(view["tpc"][view["cur"]])
            par = {"cur": view["cur"], "mode": view["par_mode"],
                   "join": view["par_join"], "tstate": view["tstate"],
                   "tpc": view["tpc"], "tparg": view["tpark_arg"]}
            epoch = view["par_epoch"]
        try:
            self._write_row_delta(sub, j, before, before_output,
                                  view["state"], next_pc, steps, i)
        except TurboEncodeError:
            self._queue_promotion(sub, j, i, view["state"], next_pc, steps,
                                  view["counters"], par, epoch)
            return True
        # lane and block bookkeeping past what the delta write covers
        regs = sub["regs"][j]
        regs[lc0:lc1] = view["counters"][:cols.n_loops]
        if res == "complete":
            regs[C_CURTID] = -1
            regs[C_PARMODE] = PM_NONE
            regs[C_PARJOIN] = 0
            regs[C_PAREPOCH] += 1
            for l in range(nt):
                regs[cols.tstate(l)] = T_FREE
        else:
            regs[C_CURTID] = view["cur"]
            for l in range(nt):
                regs[cols.tstate(l)] = view["tstate"][l]
                regs[cols.tpc(l)] = view["tpc"][l]
        return True

    async def _service(self, sub: dict, j: int, i: int, rts: dict) -> bool:
        """Service parked row j (instance i) in place in ``sub``. Returns
        True when the row resumed."""
        if int(sub["regs"][j, C_PARMODE]) > 0:
            return await self._service_lanes(sub, j, i, rts)
        pc = int(sub["regs"][j, C_PC])
        task = self.compiled.source_tasks[pc]
        state = self._decode_row(sub, j, i)
        kind = self.plan.park_kind_of.get(pc, 0)
        steps = int(sub["regs"][j, C_STEPS]) + 1

        if kind == vm_config.PARK_AWAIT_INSERT and task is not None:
            if not lanering_mod.await_insert_ready(task, state["inserts"]):
                return False  # still parked
            # nothing changed but pc/steps — delta writes registers only
            self._write_row_delta(sub, j, state["inserts"],
                                  state["output"], state, pc + 1, steps, i)
            return True

        if task is None:
            raise RuntimeError(f"instance {i}: parked at pc={pc} with no "
                               f"source task")
        rt = self._runtime_for(i, rts)
        before = self._snapshot_inserts(state["inserts"])
        before_output = state["output"]
        cols = self.cols
        lc0, lc1 = cols._loops0, cols._loops0 + cols.n_loops
        counters = np.asarray(sub["regs"][j, lc0:lc1]).copy()
        next_pc = await self._lanering.exec_parked(
            rt, state, pc, task, i, kind, counters, engine="turbo")
        try:
            self._write_row_delta(sub, j, before, before_output, state,
                                  next_pc, steps, i)
        except TurboEncodeError:
            # the state outgrew the slot model: on to the wider sibling
            self._queue_promotion(sub, j, i, state, next_pc, steps,
                                  counters, None,
                                  int(sub["regs"][j, C_PAREPOCH]))
            return True
        sub["regs"][j, lc0:lc1] = counters[:cols.n_loops]
        return True

    @staticmethod
    def _snapshot_inserts(inserts: dict) -> dict:
        """A value snapshot for the delta write-back (lists copied — host
        commands may rebind or mutate them)."""
        return {k: list(v) if isinstance(v, list) else v
                for k, v in inserts.items()}

    @staticmethod
    def _same_value(a, b) -> bool:
        """Type-exact equality: True == 1 must NOT count as unchanged."""
        if type(a) is not type(b):
            return False
        if isinstance(a, list):
            return len(a) == len(b) and all(
                type(x) is type(y) and x == y for x, y in zip(a, b))
        return a == b

    def _spill(self, i, output: str, epoch: int) -> str:
        """Keep an output longer than half the device buffer on the host,
        tagged with the row's clear-epoch; the device keeps an empty tail."""
        if i is not None and (len(output.encode("utf-8"))
                              > self.tcfg.out_width // 2):
            self._out_prefix[i] = (output, epoch)
            return ""
        return output

    def _write_row_delta(self, sub: dict, j: int, before: dict,
                         before_output: str, state: dict, pc: int,
                         steps: int, i: int = None):
        """Write back only what host servicing changed; atomic — a
        TurboEncodeError leaves the row as it was."""
        inserts = state["inserts"]
        if any(k not in inserts for k in before):
            # a host command deleted an insert: rare — full rewrite
            return self._write_row(sub, j, state, pc, steps, i)
        regs = sub["regs"][j]
        sbuf = sub["sbuf"][:, j]
        meta = sub["meta"][:, j]
        backup = regs.copy(), sbuf.copy(), meta.copy()
        try:
            for k, v in inserts.items():
                if k in before and self._same_value(before[k], v):
                    continue
                s = self.plan.slot_of.get(str(k))
                if s is not None:
                    self._zero_slot(regs, sbuf, meta, s)
                self._encode_slot(regs, sbuf, meta, k, v)
            if state["output"] != before_output:
                # the decoded output had any stored prefix folded in, so it
                # must not survive
                if i is not None:
                    self._out_prefix.pop(i, None)
                output = self._spill(i, state["output"],
                                     int(regs[C_CLREPOCH]))
                data = output.encode("utf-8")
                if len(data) > self.tcfg.out_width:
                    raise TurboEncodeError(
                        "output exceeds the device buffer")
                sub["out"][j, :] = 0
                sub["out"][j, :len(data)] = np.frombuffer(data, np.uint8)
                regs[C_OUTLEN] = len(data)
        except TurboEncodeError:
            regs[:], sbuf[:], meta[:] = backup
            raise
        regs[C_PC] = pc
        regs[C_STEPS] = steps
        regs[C_STATUS] = RUNNING

    def _write_row(self, sub: dict, j: int, state: dict, pc: int,
                   steps: int, i: int = None):
        if i is not None:
            # the stored prefix was folded into state["output"] by
            # _decode_row, so it must not survive this write
            self._out_prefix.pop(i, None)
        output = self._spill(i, state["output"],
                             int(sub["regs"][j, C_CLREPOCH]))
        row = self._encode_row(state["inserts"], output, pc, steps)
        # loop counters and parallel-lane bookkeeping live outside the
        # reference state dict — a park must not reset them
        cols = self.cols
        row["regs"][C_CURTID:cols._slots0] = \
            sub["regs"][j, C_CURTID:cols._slots0]
        lc0, lc1 = cols._loops0, cols._loops0 + cols.n_loops
        row["regs"][lc0:lc1] = sub["regs"][j, lc0:lc1]
        sub["regs"][j] = row["regs"]
        sub["sbuf"][:, j, :] = row["sbuf"]
        sub["out"][j] = row["out"]
        sub["meta"][:, j, :] = row["meta"]

    def _gather_sub(self, batch, rows: np.ndarray):
        """Host copies of the given global rows (sorted), and where each
        shard's part of them lies on its device."""
        parts, idx = [], []
        for shard, off, size in _shards(batch):
            lo, hi = np.searchsorted(rows, [off, off + size])
            if lo == hi:
                continue
            local = torch.from_numpy((rows[lo:hi] - off).astype(
                np.int64)).to(shard.regs.device)
            parts.append({
                "regs": shard.regs.index_select(0, local).cpu().numpy(),
                "sbuf": shard.sbuf.index_select(1, local).cpu().numpy(),
                "out": shard.out.index_select(0, local).cpu().numpy(),
                "meta": shard.meta.index_select(1, local).cpu().numpy()})
            idx.append((shard, local, lo, hi))
        sub = {f: np.concatenate([p[f] for p in parts], axis=ax)
               for f, ax in (("regs", 0), ("sbuf", 1), ("out", 0),
                             ("meta", 1))}
        return sub, idx

    @staticmethod
    def _scatter_sub(batch, sub: dict, idx) -> None:
        for shard, local, lo, hi in idx:
            dev = shard.regs.device

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            shard.regs.index_copy_(0, local, up(sub["regs"][lo:hi]))
            shard.sbuf.index_copy_(1, local, up(sub["sbuf"][:, lo:hi]))
            shard.out.index_copy_(0, local, up(sub["out"][lo:hi]))
            shard.meta.index_copy_(1, local, up(sub["meta"][:, lo:hi]))

    @staticmethod
    def _column(batch, col: int = C_STATUS) -> np.ndarray:
        """One register column of every row, on the host (it waits for the
        launches before it on each shard's stream)."""
        return np.concatenate([shard.regs[:, col].to("cpu", copy=True)
                               .numpy() for shard, _, _ in _shards(batch)])

    async def _sweep_pending(self, epochs: np.ndarray,
                             status: np.ndarray) -> None:
        """Cancel the host IO of finished parallel blocks: a race won on
        the device bumps the row's par_epoch, and the losers' pending IO
        must go (the reference cancels after FIRST_COMPLETED). A migrated
        row is DONE here, but its instance's IO belongs to the sibling
        now (the other lanes of a block promoted with its ``par`` record)."""
        for gid in list(self._lanering.pending):
            row = self._row_of(gid, len(status))
            pend = self._lanering.pending.get(gid)
            if row is None or pend is None or row in self._migrated:
                continue
            if int(epochs[row]) != pend["epoch"] or \
                    status[row] not in (RUNNING, PARKED):
                await self._lanering.cancel(gid)

    def _count_kinds(self, pcs) -> None:
        """parks_by_kind: one park of the kind of each pc (a parked row's
        pc, as the exact path counts it)."""
        by = self.ring_stats["parks_by_kind"]
        for pc, cnt in zip(*np.unique(np.asarray(pcs, np.int64),
                                      return_counts=True)):
            k = self.plan.park_kind_of.get(int(pc), 0)
            by[k] = by.get(k, 0) + int(cnt)

    async def run_async(self, batch, *, max_rounds: int = 10_000):
        """Step until no lane is RUNNING or PARKED (the JAX package's
        ``run_async``, ``vm/turbo.py:3701``). Each round
        launches the step and downloads the status and classification
        columns (``_meta_full``), cancels the IO of finished parallel
        blocks, and splits the parked rows (``_classify_parked``). The exact
        rows are gathered to the host and their service started; the fast
        rows are serviced and resumed on the device; then one more step runs
        the running lanes (parked lanes are frozen in the kernel, so it
        overlaps the host service), and the exact rows are scattered back.
        A round of fast parks only needs neither. Promotions queued in a
        round run in a sibling batch concurrently with this one, joined at
        the end; then the escapes run in one general-engine batch.

        Every device-to-host download runs on a worker thread: it blocks
        until the launches before it finish, and meanwhile the event loop
        serves a sibling engine's parked rows (``run_pipelined``) or the
        promotion sibling."""
        step = self.step_fn(_n_rows(batch))
        rts: dict = {}
        stalled = 0
        rs = self.ring_stats
        for round_no in range(max_rounds):
            batch = step(batch)
            meta = await asyncio.to_thread(self._meta_full, batch)
            status = meta[:, 0].astype(np.int32)
            if self._lanering.pending:
                epochs = await asyncio.to_thread(self._column, batch,
                                                 C_PAREPOCH)
                await self._sweep_pending(epochs, status)
            parked = np.nonzero(status == PARKED)[0]
            if len(parked) == 0:
                if not (status == RUNNING).any():
                    break
                continue
            events.EVENTS.emit(events.VM_ROUND, round=round_no,
                               engine="turbo",
                               running=int((status == RUNNING).sum()),
                               parked=len(parked))
            t_ring = events.now_us()
            n_queued = len(self._promote_states) + len(self._escape_states)
            groups, cancels, slow = self._classify_parked(batch, parked,
                                                          meta)
            service = None
            if len(slow):
                sub, idx = await asyncio.to_thread(self._gather_sub, batch,
                                                   slow)
                park_pcs = sub["regs"][:, C_PC].copy()
                service = asyncio.gather(*[
                    self._service(sub, j, int(i), rts)
                    for j, i in enumerate(slow)])
            n_fast = 0
            if len(cancels[0]):
                self._fast_cancel(batch, *cancels)
                n_fast += len(cancels[0])
            if groups:
                n_fast += await self._fast_service(batch, groups)
            if n_fast:
                fast_rows = np.concatenate([cancels[0], *groups.values()])
                self._count_kinds(meta[fast_rows, 1])
            if service is not None and ((status == RUNNING).any() or n_fast):
                batch = step(batch)
            resumed = n_fast
            if service is not None:
                changed = await service
                resumed += sum(bool(c) for c in changed)
                self._count_kinds([park_pcs[j] for j, c in enumerate(changed)
                                   if c])
                if any(changed):
                    self._scatter_sub(batch, sub, idx)
            rs["rounds"] = round_no + 1
            rs["parks"] += resumed
            rs["escapes"] += (len(self._promote_states)
                              + len(self._escape_states) - n_queued)
            rs["ring_ms"] += (events.now_us() - t_ring) / 1e3
            if self._promote_states and self.promote_factor:
                # the promoted instances resume in their sibling now, not
                # at the end of the run (an interactive program may never
                # end); the flush pops the queue before its first await
                self._promo_tasks.append(
                    asyncio.ensure_future(self._flush_promotions()))
            if service is None:
                # fast parks only: every serviced row is RUNNING, and the
                # next round's download reads the status
                stalled = 0
                continue
            status = await asyncio.to_thread(self._column, batch)
            if not ((status == RUNNING) | (status == PARKED)).any():
                break
            if not (status == RUNNING).any() and resumed == 0:
                stalled += 1
                if stalled > 50:
                    break
                await asyncio.sleep(0.05)
            else:
                stalled = 0
        tasks, self._promo_tasks = self._promo_tasks, []
        for res in await asyncio.gather(*tasks, return_exceptions=True):
            if isinstance(res, BaseException):
                raise res
        await self._flush_promotions()
        await self._flush_escapes()
        n_rows = _n_rows(batch)
        for gid in list(self._lanering.pending):
            if self._row_of(gid, n_rows) is not None:
                await self._lanering.cancel(gid)
        return batch

    def run(self, batch, **kw):
        return asyncio.run(self.run_async(batch, **kw))

    # ---- results ----------------------------------------------------------------

    def results(self, batch, n: int = None) -> list:
        host = {f: np.concatenate([shard[k].cpu().numpy()
                                   for shard, _, _ in _shards(batch)],
                                  axis=ax)
                for k, (f, ax) in enumerate((("regs", 0), ("sbuf", 1),
                                             ("out", 0), ("meta", 1)))}
        n = self._n_live if n is None else n
        out = []
        for i in range(n):
            if i in self._escape_results:     # migrated to the sibling
                out.append(self._escape_results[i])
                continue
            state = self._decode_row(host, i, i)
            out.append(InstanceResult(
                output=state["output"], inserts=state["inserts"],
                status=int(host["regs"][i, C_STATUS]),
                steps=int(host["regs"][i, C_STEPS])))
        return out


def _plan_tables(plan, cols, tcfg: TurboConfig):
    """The plan's host ``TurboTables`` at ``cols`` and ``tcfg``."""
    lits = _LitTable(tcfg.width)
    lits.collect(plan.instrs)
    return build_tables(plan, cols, lits)


def batch_shapes(cols: _Cols, tcfg: TurboConfig, n: int) -> tuple:
    """The shapes of a batch of n instances: regs, sbuf, out, meta."""
    return ((n, cols.regw), (cols.n_rows, n, tcfg.width),
            (n, tcfg.out_width), (len(cols.list_ord), n, 3 * cols.E))


def step_fits(device, cols: _Cols, tcfg: TurboConfig, host) -> bool:
    """Whether the step kernel takes a batch of ``tcfg`` on ``device``: on
    a card, one instance fits in a block's shared memory beside the step
    tables (``host``, the plan's TurboTables at ``cols`` and ``tcfg``); the
    plain version on the CPU has no limit."""
    if torch.device(device).type != "cuda":
        return True
    shape = TileShape.of(StepTables.on(host, "cpu"),
                         batch_shapes(cols, tcfg, 1))
    return fits_one_instance(shape, shared_memory(device))


def step_max_width(device) -> Optional[int]:
    """The widest slot the step takes on ``device``: the kernel's on a
    card; the plain version on the CPU has no limit."""
    return MAX_WIDTH if torch.device(device).type == "cuda" else None


def _as_sharded(batch) -> ShardedTurboBatch:
    if isinstance(batch, ShardedTurboBatch):
        return batch
    return ShardedTurboBatch((batch,), (0, int(batch.regs.shape[0])))


def _shards(batch) -> list:
    """(shard, global row of its first row, rows) of a TurboBatch (one
    shard) or a ShardedTurboBatch."""
    b = _as_sharded(batch)
    return [(shard, off, b.offsets[s + 1] - off)
            for s, (shard, off) in enumerate(b.parts())]


def _n_rows(batch) -> int:
    return _as_sharded(batch).n


def make_shard_engines(compiled, tcfg: TurboConfig, n_shards: int,
                       io_factory=None, **kw) -> list:
    """``n_shards`` sibling TurboEngines over one plan and one LaneRing,
    sharing the device tables (the JAX package's siblings share their
    compiled step functions instead); give them disjoint global instance
    ids with ``assign_shard_ids`` and drive them with ``run_pipelined``."""
    first = TurboEngine(compiled, tcfg, io_factory=io_factory, **kw)
    return [first] + [TurboEngine(
        compiled, tcfg, io_factory=io_factory, plan=first.plan,
        lanering=first._lanering, step_tables=first.step_tables, **kw)
        for _ in range(n_shards - 1)]


def assign_shard_ids(engines: list, shard_n: int) -> None:
    """Row r of sibling s is global instance s * shard_n + r, so per-
    instance IO and the shared LaneRing key correctly across siblings."""
    for s, e in enumerate(engines):
        e.instance_ids = range(s * shard_n, (s + 1) * shard_n)


async def run_pipelined(pairs, **kw) -> list:
    """Drive (engine, batch) pairs concurrently on one event loop: while
    one engine's coroutine services its parked rows on the host, another's
    launch runs on the device (their downloads wait on worker threads).
    Returns the final batches in pair order."""
    return list(await asyncio.gather(
        *[e.run_async(b, **kw) for e, b in pairs]))
