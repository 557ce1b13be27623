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
lists included. A value that outgrows its slot raises ``NotPorted``
(promotion to a wider sibling batch is not here yet). The ring is the JAX
package's exact slow path, with lane servicing for instances parked inside
a parallel block; its vectorized fast park path is not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._shared import (context, events, executor, io_manager, lanering,
                       planner, vm_config)
from ..ops.turbo_step import StepTables, turbo_step
from .state import T_INT, T_LIST, T_STR
from .turbo_tables import NotPorted, build_tables

NotTurbo = planner.NotTurbo
DONE, PARKED, RUNNING = vm_config.DONE, vm_config.PARKED, vm_config.RUNNING
PM_NONE, T_FREE = vm_config.PM_NONE, vm_config.T_FREE

# fixed control columns; everything after is computed by _Cols
C_PC, C_STATUS, C_STEPS, C_OUTLEN = 0, 1, 2, 3
C_CURTID, C_PARMODE, C_PARJOIN, C_PAREPOCH = 4, 5, 6, 7
# count of in-kernel `clear`s: the host-side output spill (_out_prefix) is
# tagged with the epoch it was drained at, so a later device-side clear
# erases it (decode ignores a stale-epoch prefix)
C_CLREPOCH = 8
C_BASE = 9


@dataclass(frozen=True)
class TurboConfig:
    tile: int = 128     # threads (instances) per CUDA block
    width: int = 128    # slot string bytes
    out_width: int = 256
    k_steps: int = 32   # VM steps per kernel launch
    list_cap: int = 12  # elements per list slot
    elem_width: int = 32  # bytes per list element


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
    list slot's meta row move into ``meta``; the row itself stays zero."""
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


class TurboEngine:
    """Run one turbo-planned program over a batch of instances on
    ``device``: CUDA tensors go through the hand-written step kernel, CPU
    tensors through its plain PyTorch version.

    The ring is the JAX package's exact slow path: one gather of all parked
    rows per round, exact host service per row (through the shared LaneRing
    for a row parked inside a parallel block), one scatter back.

    Known decode-order divergence (as in the JAX package): decoded insert
    dicts list keys in static slot order, not dynamic first-write order.
    """

    def __init__(self, compiled, tcfg: TurboConfig = None, io_factory=None,
                 *, device):
        if context.CTX.inserts_dir:
            raise NotTurbo("--inserts-dir fallback needs the general engine")
        self.compiled = compiled
        self.plan = planner.plan_turbo(compiled)
        self.tcfg = tcfg or TurboConfig()
        self.cols = _make_cols(self.plan, self.tcfg)
        lits = _LitTable(self.tcfg.width)
        lits.collect(self.plan.instrs)
        self.device = torch.device(device)
        self.tables = StepTables.on(
            build_tables(self.plan, self.cols, lits), self.device)
        self.io_factory = io_factory or (lambda i: io_manager.IOManager(
            io_manager.BufferBackend()))
        self._slot_keys = list(self.plan.slot_names)
        self._lanering = lanering.LaneRing(compiled)
        self._ios: dict = {}
        # output spill: instance → (drained_output, clear_epoch). When a
        # row's output outgrows the device buffer the ring drains it here;
        # a stale epoch (an in-kernel `clear` ran since) voids the prefix.
        self._out_prefix: dict = {}
        self.ring_stats = {"rounds": 0, "parks": 0, "parks_by_kind": {}}
        self._n_live = 0

    # ---- batch lifecycle ---------------------------------------------------

    def make_batch(self, n: int, args: list = ()) -> TurboBatch:
        """N fresh instances: one prototype row, encoded on the host and
        broadcast on the device. Nothing is padded: the kernel masks the
        ragged last block itself."""
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
        self._out_prefix.clear()
        return TurboBatch(
            regs=bcast(row["regs"][None], (n, self.cols.regw)),
            sbuf=bcast(row["sbuf"][:, None, :],
                       (self.cols.n_rows, n, self.tcfg.width)),
            out=bcast(row["out"][None], (n, self.tcfg.out_width)),
            meta=bcast(row["meta"][:, None, :],
                       (len(self.cols.list_ord), n, 3 * self.cols.E)))

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

    # ---- stepping -----------------------------------------------------------

    def step_fn(self, n: int):
        """``step(batch) -> batch``: k_steps VM steps on every RUNNING lane
        of an n-row batch, updating its tensors in place (the TPU's
        ``input_output_aliases``)."""
        tables, k, block = self.tables, self.tcfg.k_steps, self.tcfg.tile

        def step(batch: TurboBatch) -> TurboBatch:
            if batch.regs.shape[0] != n:
                raise ValueError(f"step built for {n} rows, got "
                                 f"{batch.regs.shape[0]}")
            return turbo_step(tables, batch, k, block)
        return step

    # ---- host ring -----------------------------------------------------------

    def _gid(self, row: int) -> int:
        """Global instance id of a batch row, the LaneRing's key. One engine
        owns the whole batch, so it is the row (the JAX package's sharded
        engines map it through their instance ids)."""
        return row

    def _row_of(self, gid: int, n: int):
        """Batch row of a global id, or None when the batch has no such
        row."""
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

    @staticmethod
    def _promotion(i: int, e: Exception) -> NotPorted:
        return NotPorted(f"promotion of instance {i} to a wider sibling "
                         f"batch (ROADMAP Queue 1, promotion): {e}")

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
        next_pc = view["par_join"] if res == "complete" else \
            int(view["tpc"][view["cur"]])
        try:
            self._write_row_delta(sub, j, before, before_output,
                                  view["state"], next_pc, steps, i)
        except TurboEncodeError as e:
            raise self._promotion(i, e) from e
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
            if not lanering.await_insert_ready(task, state["inserts"]):
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
        except TurboEncodeError as e:
            raise self._promotion(i, e) from e
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

    def _gather_sub(self, batch: TurboBatch, rows: np.ndarray):
        """Host copies of the given rows, and their index on the device."""
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        sub = {"regs": batch.regs.index_select(0, idx).cpu().numpy(),
               "sbuf": batch.sbuf.index_select(1, idx).cpu().numpy(),
               "out": batch.out.index_select(0, idx).cpu().numpy(),
               "meta": batch.meta.index_select(1, idx).cpu().numpy()}
        return sub, idx

    def _scatter_sub(self, batch: TurboBatch, sub: dict, idx) -> None:
        dev = self.device
        batch.regs.index_copy_(0, idx, torch.from_numpy(sub["regs"]).to(dev))
        batch.sbuf.index_copy_(1, idx, torch.from_numpy(sub["sbuf"]).to(dev))
        batch.out.index_copy_(0, idx, torch.from_numpy(sub["out"]).to(dev))
        batch.meta.index_copy_(1, idx, torch.from_numpy(sub["meta"]).to(dev))

    @staticmethod
    def _status(batch: TurboBatch) -> np.ndarray:
        return batch.regs[:, C_STATUS].to("cpu", copy=True).numpy()

    async def _sweep_pending(self, batch: TurboBatch,
                             status: np.ndarray) -> None:
        """Cancel the host IO of finished parallel blocks: a race won on
        the device bumps the row's par_epoch, and the losers' pending IO
        must go (the reference cancels after FIRST_COMPLETED)."""
        epochs = batch.regs[:, C_PAREPOCH].to("cpu", copy=True).numpy()
        for gid in list(self._lanering.pending):
            row = self._row_of(gid, len(status))
            pend = self._lanering.pending.get(gid)
            if row is None or pend is None:
                continue
            if int(epochs[row]) != pend["epoch"] or \
                    status[row] not in (RUNNING, PARKED):
                await self._lanering.cancel(gid)

    async def run_async(self, batch: TurboBatch, *, max_rounds: int = 10_000
                        ) -> TurboBatch:
        """Step until no lane is RUNNING or PARKED. Each round launches the
        step, cancels the IO of finished parallel blocks, gathers every
        parked row to the host, launches one more step for the running
        lanes (parked lanes are frozen in the kernel, so it overlaps the
        host service), services each parked row exactly and scatters the
        rows back."""
        import asyncio
        step = self.step_fn(batch.regs.shape[0])
        rts: dict = {}
        stalled = 0
        for round_no in range(max_rounds):
            batch = step(batch)
            status = self._status(batch)
            if self._lanering.pending:
                await self._sweep_pending(batch, status)
            parked = np.nonzero(status == PARKED)[0]
            if len(parked) == 0:
                if not (status == RUNNING).any():
                    break
                continue
            events.EVENTS.emit(events.VM_ROUND, round=round_no,
                               engine="turbo",
                               running=int((status == RUNNING).sum()),
                               parked=len(parked))
            sub, idx = self._gather_sub(batch, parked)
            park_pcs = sub["regs"][:, C_PC].copy()
            if (status == RUNNING).any():
                batch = step(batch)
            changed = await asyncio.gather(*[
                self._service(sub, j, int(i), rts)
                for j, i in enumerate(parked)])
            resumed = sum(bool(c) for c in changed)
            rs = self.ring_stats
            rs["rounds"] = round_no + 1
            rs["parks"] += resumed
            by = rs["parks_by_kind"]
            for j, c in enumerate(changed):
                if c:
                    k = self.plan.park_kind_of.get(int(park_pcs[j]), 0)
                    by[k] = by.get(k, 0) + 1
            if resumed:
                self._scatter_sub(batch, sub, idx)
            status = self._status(batch)
            if not ((status == RUNNING) | (status == PARKED)).any():
                break
            if not (status == RUNNING).any() and resumed == 0:
                stalled += 1
                if stalled > 50:
                    break
                await asyncio.sleep(0.05)
            else:
                stalled = 0
        n_rows = int(batch.regs.shape[0])
        for gid in list(self._lanering.pending):
            if self._row_of(gid, n_rows) is not None:
                await self._lanering.cancel(gid)
        return batch

    def run(self, batch: TurboBatch, **kw) -> TurboBatch:
        import asyncio
        return asyncio.run(self.run_async(batch, **kw))

    # ---- results ----------------------------------------------------------------

    def results(self, batch: TurboBatch, n: int = None) -> list:
        host = {k: v.cpu().numpy() for k, v in batch._asdict().items()}
        n = self._n_live if n is None else n
        out = []
        for i in range(n):
            state = self._decode_row(host, i, i)
            out.append(InstanceResult(
                output=state["output"], inserts=state["inserts"],
                status=int(host["regs"][i, C_STATUS]),
                steps=int(host["regs"][i, C_STEPS])))
        return out
