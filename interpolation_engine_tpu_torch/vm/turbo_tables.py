"""A turbo plan as int32 tables that one compiled step kernel reads.

On the TPU each program was baked into its own Mosaic kernel at trace time
(``interpolation_engine_tpu/vm/turbo.py`` ``_build_branch``). Here the plan
becomes data: the per-pc instruction rows and their side tables below,
uploaded once per engine. One CUDA kernel (``csrc/turbo_step.cu``) and its
plain PyTorch version (``ops/turbo_step.py``) interpret them, so no program
ever triggers an ``nvcc`` build.

Tables (all int32 unless noted):

  ins    (P, 8)   per pc: opcode, then operands a..g (see the OP_* notes)
  segs   (G, 2)   template segments: (SEG_LIT, literal row) | (SEG_HOLE, slot)
  ents   (E, 4)   goto_map entries: (pattern kind, row a, row b, target pc);
                  int-dispatch entries: (PAT_ANY | PAT_EXACT, int, 0, target)
  rpn    (Q, 2)   math ops: (RPN_*, argument)
  ints   (D,)     lists of ints: delete slots, concat sources, parallel
                  entry pcs, loop columns a parallel block resets
  pairs  (F, 2)   for-head pairs: (loop-var slot, first element row)
  elems  (X, 2)   for-head elements: (ELEM_INT, value) | (ELEM_STR, lit row)
  slots  (S, 8)   per slot: kind, stype col, sint col, slen col, string row,
                  list plane, first element row, element kind (-1: none)
  lit_len (L,)    literal lengths
  items  (I, 3)   item sources: (SRC_INT, value, 0) | (SRC_STR, lit row, 0)
                  | (SRC_COPY, slot, 0) | (SRC_TMPL, seg0, nseg)
  dpairs (Y, 2)   dynamic for-head pairs: (loop-var slot, list slot)
  lits   (L, W)   uint8 literal bytes, zero past each row's length

``flat`` packs every int32 table behind a HEADER-word header: the list
layout (E, elem width, elements per row, thread lanes, list planes) and the
offset of each table. The kernel takes that one buffer and the literals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._shared import planner

# opcodes; operand columns a..g are ins[:, 1:8]
OP_HALT = 0
OP_NOP = 1
OP_GOTO = 2          # a=target
OP_PARK = 3          # a=await slot (-1: plain park)
OP_CLEAR = 4
OP_DELETE = 5        # a=first ints row, b=count
OP_SET = 6           # a=out slot, b=SRC_*, c=int | lit row | slot | seg0, d=nseg
OP_MATH = 7          # a=out slot, b=first rpn row, c=count
OP_PRINT = 8         # a=seg0, b=nseg, c=single-hole slot (-1: none)
OP_GOTOMAP = 9       # a=seg0, b=nseg, c=first ents row, d=count, e=null pc|-1
OP_GOTOMAP_INT = 10  # a=slot, c=first ents row, d=count, e=null pc|-1
OP_FORHEAD = 11      # a=loop col, b=n, c=exit pc, d=first pairs row, e=count
OP_FORNEXT = 12      # a=loop col, b=head pc
OP_SETLIST = 13      # a=out slot, b=src list slot (whole-list copy)
OP_LISTNEW = 14      # a=out slot, b=first items row, c=count
OP_LISTAPPEND = 15   # a=out slot, b=src slot, c=items row
OP_LISTREMOVE = 16   # a=out slot, b=src slot, c=items row
OP_LISTINDEX = 17    # a=out slot, b=src slot, c=IDX_*, d=int | slot | seg0,
#                      e=nseg
OP_LISTSLICE = 18    # a=out slot, b=src slot, c,d=from rpn row, count;
#                      e,f=to rpn row, count
OP_LISTJOIN = 19     # a=out slot, b=src slot, c=seg0, d,e,f=nseg of before,
#                      between, after (consecutive in segs)
OP_LISTCONCAT = 20   # a=out slot, b=first ints row (source slots), c=count
OP_FORHEADDYN = 21   # a=loop col, b=exit pc, c=first dpairs row, d=count
OP_PARBEGIN = 22     # a=mode, b=k, c=join pc, d=first ints row (entry pcs),
#                      e=first ints row (loop cols), f=count
OP_THREADEND = 23    # a=k, b=join pc

SRC_INT, SRC_STR, SRC_COPY, SRC_TMPL = 0, 1, 2, 3
IDX_CONST, IDX_COPY, IDX_TMPL = 0, 1, 2
SEG_LIT, SEG_HOLE = 0, 1
PAT_ANY, PAT_EXACT, PAT_PREFIX, PAT_SUFFIX, PAT_AFFIX = 0, 1, 2, 3, 4
ELEM_INT, ELEM_STR = 0, 1
KIND_NONE, KIND_INT, KIND_STR, KIND_MIX, KIND_LIST = 0, 1, 2, 3, 4
(RPN_CONST, RPN_SLOT, RPN_LENGTH, RPN_NEG, RPN_SIGN, RPN_ADD, RPN_SUB,
 RPN_MUL, RPN_MIN2, RPN_MAX2, RPN_DIV, RPN_MOD) = range(12)

_KIND = {"none": KIND_NONE, "int": KIND_INT, "str": KIND_STR,
         "mix": KIND_MIX, "list": KIND_LIST}
_PAT = {"any": PAT_ANY, "exact": PAT_EXACT, "prefix": PAT_PREFIX,
        "suffix": PAT_SUFFIX, "affix": PAT_AFFIX}
_RPN = {"neg": RPN_NEG, "sign": RPN_SIGN, "add": RPN_ADD, "sub": RPN_SUB,
        "mul": RPN_MUL, "min2": RPN_MIN2, "max2": RPN_MAX2, "div": RPN_DIV,
        "mod": RPN_MOD}

RPN_MAX_STACK = 16   # the kernel's fixed per-thread math stack
HEADER = 32          # flat: [P, S, n_lits, E, ew, pack, nt, n_lists, offsets]
_FLAT_ORDER = ("ins", "segs", "ents", "rpn", "ints", "pairs", "elems",
               "slots", "lit_len", "items", "dpairs")
_OFF0 = 8


class NotPorted(Exception):
    """A path of the JAX package the port does not carry (the device chat
    filter). Not a NotTurbo: nothing treats it as a reason to pick another
    engine."""


@dataclass
class TurboTables:
    ins: np.ndarray
    segs: np.ndarray
    ents: np.ndarray
    rpn: np.ndarray
    ints: np.ndarray
    pairs: np.ndarray
    elems: np.ndarray
    slots: np.ndarray
    lits: np.ndarray       # (L, W) uint8
    lit_len: np.ndarray
    items: np.ndarray
    dpairs: np.ndarray
    rpn_depth: int
    width: int
    list_cap: int          # E
    elem_width: int
    pack: int              # elements per byte row
    n_threads: int
    n_lists: int           # list slots = planes of the batch's meta tensor
    scratch_bytes: int     # per instance, for a list literal (0: none)

    @property
    def n_instr(self) -> int:
        return self.ins.shape[0]

    def flat(self) -> np.ndarray:
        """Every int32 table in one buffer, behind the header."""
        parts = [getattr(self, name).reshape(-1) for name in _FLAT_ORDER]
        head = np.zeros((HEADER,), np.int32)
        head[:_OFF0] = (self.n_instr, self.slots.shape[0], self.lits.shape[0],
                        self.list_cap, self.elem_width, self.pack,
                        self.n_threads, self.n_lists)
        off = HEADER
        for k, p in enumerate(parts):
            head[_OFF0 + k] = off
            off += p.size
        return np.concatenate([head] + parts).astype(np.int32)


def _i32(v: int, what: str) -> int:
    if not -2**31 <= v < 2**31:
        raise planner.NotTurbo(f"{what} {v} exceeds int32")
    return v


def _int_exact(pat):
    """int v such that str(v) == the exact pattern's bytes, else None (the
    JAX package's int-dispatch rule, vm/turbo.py:1197)."""
    if pat[0] != "exact":
        return None
    try:
        v = int(pat[1].decode("ascii", "ignore"))
    except ValueError:
        return None
    return v if str(v).encode() == pat[1] else None


def rpn_depth(ops) -> int:
    depth = best = 0
    for op in ops:
        if op[0] in ("const", "slot", "length"):
            depth += 1
        elif op[0] not in ("neg", "sign"):
            depth -= 1
        best = max(best, depth)
    return best


def build_tables(plan, cols, lit_table) -> TurboTables:
    """Flatten ``plan`` (a ``compiler.turbo.TurboPlan``) into tables over
    the register layout ``cols`` and the registered ``lit_table``. Raises
    NotTurbo where the JAX package's branch builder does."""
    p = planner
    if cols.list_ord and cols.ew > cols.width:
        raise p.NotTurbo(f"elem_width {cols.ew} exceeds width {cols.width}")
    lit = lit_table.index
    ins = np.zeros((max(plan.n_instr, 1), 8), np.int32)
    segs, ents, rpn, ints, pairs, elems, items, dpairs = \
        [], [], [], [], [], [], [], []
    depth = 0
    list_new = False

    def tmpl(t) -> tuple:
        seg0 = len(segs)
        for seg in t:
            if isinstance(seg, p.Lit):
                segs.append((SEG_LIT, lit[seg.data]))
            else:
                segs.append((SEG_HOLE, seg.slot))
        return seg0, len(segs) - seg0

    def item(src) -> int:
        kind, v = src[0], src[1]
        if kind == "int":
            items.append((SRC_INT, _i32(v, "item"), 0))
        elif kind == "str":
            items.append((SRC_STR, lit[v], 0))
        elif kind == "copy":
            items.append((SRC_COPY, v, 0))
        else:
            # register the segments first: tmpl() appends to segs only
            items.append((SRC_TMPL, *tmpl(v)))
        return len(items) - 1

    def math(ops) -> tuple:
        nonlocal depth
        q0 = len(rpn)
        for op in ops:
            if op[0] == "const":
                rpn.append((RPN_CONST, _i32(op[1], "math constant")))
            elif op[0] in ("slot", "length"):
                rpn.append((RPN_SLOT if op[0] == "slot" else RPN_LENGTH,
                            op[1]))
            else:
                rpn.append((_RPN[op[0]], 0))
        depth = max(depth, rpn_depth(ops))
        return q0, len(ops)

    def bound(spec) -> tuple:
        # a constant slice bound is a one-op RPN program
        return math((("const", spec[1]),) if spec[0] == "const" else spec[1])

    def int_list(values) -> int:
        i0 = len(ints)
        ints.extend(values)
        return i0

    for pc, i in enumerate(plan.instrs):
        row = ins[pc]
        if isinstance(i, p.IHalt):
            row[0] = OP_HALT
        elif isinstance(i, p.INop):
            row[0] = OP_NOP
        elif isinstance(i, p.IGoto):
            row[:2] = (OP_GOTO, i.target)
        elif isinstance(i, p.IPark):
            row[:2] = (OP_PARK, i.await_slot)
        elif isinstance(i, p.IClear):
            row[0] = OP_CLEAR
        elif isinstance(i, p.IDelete):
            row[:3] = (OP_DELETE, int_list(i.slots), len(i.slots))
        elif isinstance(i, p.ISet):
            kind, v = i.src[0], i.src[1]
            if kind == "copy" and cols.kind(v) == "list":
                if i.out_slot != v and cols.kind(i.out_slot) != "list":
                    raise p.NotTurbo(f"pc {pc}: whole-list copy into the "
                                     f"scalar slot {i.out_slot}")
                row[:3] = (OP_SETLIST, i.out_slot, v)
            elif kind == "int":
                row[:4] = (OP_SET, i.out_slot, SRC_INT, _i32(v, "set"))
            elif kind == "str":
                row[:4] = (OP_SET, i.out_slot, SRC_STR, lit[v])
            elif kind == "copy":
                row[:4] = (OP_SET, i.out_slot, SRC_COPY, v)
            else:
                row[:5] = (OP_SET, i.out_slot, SRC_TMPL, *tmpl(v))
        elif isinstance(i, p.IMath):
            row[:4] = (OP_MATH, i.out_slot, *math(i.ops))
        elif isinstance(i, p.IPrint):
            single = (len(i.tmpl) == 1 and isinstance(i.tmpl[0], p.Hole))
            row[:4] = (OP_PRINT, *tmpl(i.tmpl),
                       i.tmpl[0].slot if single else -1)
        elif isinstance(i, p.IGotoMap):
            null_pc = -1 if i.null_pc is None else i.null_pc
            int_dispatch = (
                len(i.tmpl) == 1 and isinstance(i.tmpl[0], p.Hole)
                and cols.kind(i.tmpl[0].slot) == "int"
                and all(pat[0] in ("exact", "any") for pat, _t in i.entries))
            e0 = len(ents)
            if int_dispatch:
                for pat, tpc in i.entries:
                    if pat[0] == "any":
                        ents.append((PAT_ANY, 0, 0, tpc))
                    elif (v := _int_exact(pat)) is not None:
                        ents.append((PAT_EXACT, _i32(v, "goto_map key"),
                                     0, tpc))
                    # a non-canonical int key never matches: dropped
                row[:6] = (OP_GOTOMAP_INT, i.tmpl[0].slot, 0, e0,
                           len(ents) - e0, null_pc)
            else:
                for pat, tpc in i.entries:
                    rows = [lit[b] for b in pat[1:]] + [0, 0]
                    ents.append((_PAT[pat[0]], rows[0], rows[1], tpc))
                row[:6] = (OP_GOTOMAP, *tmpl(i.tmpl), e0, len(ents) - e0,
                           null_pc)
        elif isinstance(i, p.IForHead):
            row[:6] = (OP_FORHEAD, cols.loop(i.loop_id), i.n, i.exit_pc,
                       len(pairs), len(i.pairs))
            for slot, els in i.pairs:
                pairs.append((slot, len(elems)))
                for kind, v in els:
                    elems.append((ELEM_INT, _i32(v, "for element"))
                                 if kind == "int" else (ELEM_STR, lit[v]))
        elif isinstance(i, p.IForNext):
            row[:3] = (OP_FORNEXT, cols.loop(i.loop_id), i.head_pc)
        elif isinstance(i, p.IListNew):
            if len(i.elems) > cols.E:
                raise p.NotTurbo(f"literal list of {len(i.elems)} elements "
                                 f"exceeds list_cap={cols.E}")
            rows = [item(e) for e in i.elems]
            row[:4] = (OP_LISTNEW, i.out_slot, rows[0] if rows else 0,
                       len(rows))
            list_new = True
        elif isinstance(i, (p.IListAppend, p.IListRemove)):
            op = OP_LISTAPPEND if isinstance(i, p.IListAppend) \
                else OP_LISTREMOVE
            row[:4] = (op, i.out_slot, i.src_slot, item(i.item))
        elif isinstance(i, p.IListIndex):
            kind, v = i.index
            if kind == "const":
                row[:5] = (OP_LISTINDEX, i.out_slot, i.src_slot, IDX_CONST,
                           _i32(v, "list index"))
            elif kind == "copy":
                row[:5] = (OP_LISTINDEX, i.out_slot, i.src_slot, IDX_COPY, v)
            else:
                row[:6] = (OP_LISTINDEX, i.out_slot, i.src_slot, IDX_TMPL,
                           *tmpl(v))
        elif isinstance(i, p.IListSlice):
            row[:7] = (OP_LISTSLICE, i.out_slot, i.src_slot, *bound(i.frm),
                       *bound(i.to))
        elif isinstance(i, p.IListJoin):
            seg0, nb = tmpl(i.before)
            _s, nm = tmpl(i.between)
            _s, na = tmpl(i.after)
            row[:7] = (OP_LISTJOIN, i.out_slot, i.src_slot, seg0, nb, nm, na)
        elif isinstance(i, p.IListConcat):
            row[:4] = (OP_LISTCONCAT, i.out_slot, int_list(i.src_slots),
                       len(i.src_slots))
        elif isinstance(i, p.IForHeadDyn):
            row[:5] = (OP_FORHEADDYN, cols.loop(i.loop_id), i.exit_pc,
                       len(dpairs), len(i.pairs))
            dpairs.extend(i.pairs)
        elif isinstance(i, p.IParBegin):
            # a reset of a column past the register row is a no-op
            loops = sorted({cols.loop(li) for li in range(i.loop_lo,
                                                          i.loop_hi)}
                           & set(range(cols.regw)))
            row[:7] = (OP_PARBEGIN, i.mode, i.k, i.join_pc,
                       int_list(i.entries), int_list(loops), len(loops))
        elif isinstance(i, p.IThreadEnd):
            row[:3] = (OP_THREADEND, i.k, i.join_pc)
        else:
            raise p.NotTurbo(f"no branch for {type(i).__name__}")
    if depth > RPN_MAX_STACK:
        # compiler/math_rpn.py bounds the depth at 8
        raise p.NotTurbo(f"math needs a stack of {depth} > {RPN_MAX_STACK}")

    def ekind(s) -> int:
        return _KIND[cols.ekind(s)] if s in cols.list_ord else -1

    slots = np.array(
        [(_KIND[cols.kind(s)], cols.stype(s), cols.sint(s), cols.slen(s),
          cols.str_row.get(s, -1), cols.list_ord.get(s, -1),
          cols.list_row0.get(s, -1), ekind(s)) for s in range(cols.S)],
        np.int32)

    def table(rows, width):
        return np.array(rows, np.int32).reshape(-1, width) if rows else \
            np.zeros((0, width), np.int32)

    E, ew = cols.E, cols.ew
    return TurboTables(
        ins=ins, segs=table(segs, 2), ents=table(ents, 4),
        rpn=table(rpn, 2), ints=np.array(ints, np.int32),
        pairs=table(pairs, 2), elems=table(elems, 2), slots=slots,
        lits=lit_table.array(), lit_len=lit_table.lengths(),
        items=table(items, 3), dpairs=table(dpairs, 2),
        rpn_depth=depth, width=lit_table.w, list_cap=E, elem_width=ew,
        pack=cols.pack, n_threads=cols.nt, n_lists=len(cols.list_ord),
        scratch_bytes=(-(-(12 * E + E * ew) // 16) * 16) if list_new else 0)
