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
  dels   (D,)     slots a delete clears
  pairs  (F, 2)   for-head pairs: (loop-var slot, first element row)
  elems  (X, 2)   for-head elements: (ELEM_INT, value) | (ELEM_STR, lit row)
  slots  (S, 5)   per slot: kind, stype col, sint col, slen col, string row
  lits   (L, W)   uint8 literal bytes, zero past each row's length
  lit_len (L,)    literal lengths

``flat`` packs every int32 table behind a HEADER-word index of offsets, the
single buffer the kernel takes.
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
OP_DELETE = 5        # a=first dels row, b=count
OP_SET = 6           # a=out slot, b=SRC_*, c=int | lit row | slot | seg0, d=nseg
OP_MATH = 7          # a=out slot, b=first rpn row, c=count
OP_PRINT = 8         # a=seg0, b=nseg, c=single-hole slot (-1: none)
OP_GOTOMAP = 9       # a=seg0, b=nseg, c=first ents row, d=count, e=null pc|-1
OP_GOTOMAP_INT = 10  # a=slot, c=first ents row, d=count, e=null pc|-1
OP_FORHEAD = 11      # a=loop col, b=n, c=exit pc, d=first pairs row, e=count
OP_FORNEXT = 12      # a=loop col, b=head pc

SRC_INT, SRC_STR, SRC_COPY, SRC_TMPL = 0, 1, 2, 3
SEG_LIT, SEG_HOLE = 0, 1
PAT_ANY, PAT_EXACT, PAT_PREFIX, PAT_SUFFIX, PAT_AFFIX = 0, 1, 2, 3, 4
ELEM_INT, ELEM_STR = 0, 1
KIND_NONE, KIND_INT, KIND_STR, KIND_MIX = 0, 1, 2, 3
(RPN_CONST, RPN_SLOT, RPN_LENGTH, RPN_NEG, RPN_SIGN, RPN_ADD, RPN_SUB,
 RPN_MUL, RPN_MIN2, RPN_MAX2, RPN_DIV, RPN_MOD) = range(12)

_KIND = {"none": KIND_NONE, "int": KIND_INT, "str": KIND_STR,
         "mix": KIND_MIX}
_PAT = {"any": PAT_ANY, "exact": PAT_EXACT, "prefix": PAT_PREFIX,
        "suffix": PAT_SUFFIX, "affix": PAT_AFFIX}
_RPN = {"neg": RPN_NEG, "sign": RPN_SIGN, "add": RPN_ADD, "sub": RPN_SUB,
        "mul": RPN_MUL, "min2": RPN_MIN2, "max2": RPN_MAX2, "div": RPN_DIV,
        "mod": RPN_MOD}

RPN_MAX_STACK = 16   # the kernel's fixed per-thread math stack
HEADER = 16          # flat: [P, S, n_lits, then the offsets of _FLAT_ORDER]
_FLAT_ORDER = ("ins", "segs", "ents", "rpn", "dels", "pairs", "elems",
               "slots", "lit_len")

_NOT_PORTED = (
    "ROADMAP Queue 1, next item: the list and thread-lane branches of the "
    "step kernel")


class NotPorted(Exception):
    """A turbo plan the port cannot run yet. Not a NotTurbo: nothing treats
    it as a reason to pick another engine."""


@dataclass
class TurboTables:
    ins: np.ndarray
    segs: np.ndarray
    ents: np.ndarray
    rpn: np.ndarray
    dels: np.ndarray
    pairs: np.ndarray
    elems: np.ndarray
    slots: np.ndarray
    lits: np.ndarray       # (L, W) uint8
    lit_len: np.ndarray
    rpn_depth: int
    width: int

    @property
    def n_instr(self) -> int:
        return self.ins.shape[0]

    def flat(self) -> np.ndarray:
        """Every int32 table in one buffer, behind the offset header."""
        parts = [getattr(self, name).reshape(-1) for name in _FLAT_ORDER]
        head = np.zeros((HEADER,), np.int32)
        head[0] = self.n_instr
        head[1] = self.slots.shape[0]
        head[2] = self.lits.shape[0]
        off = HEADER
        for k, p in enumerate(parts):
            head[3 + k] = off
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
    ``NotPorted`` for list and thread-lane instructions and list slots."""
    p = planner
    for s, k in enumerate(cols.kinds[:cols.S]):
        if k not in _KIND:
            raise NotPorted(f"slot {plan.slot_names[s]!r} is a {k} slot; "
                            f"{_NOT_PORTED}")
    lit = lit_table.index
    ins = np.zeros((max(plan.n_instr, 1), 8), np.int32)
    segs, ents, rpn, dels, pairs, elems = [], [], [], [], [], []
    depth = 0

    def tmpl(t) -> tuple:
        seg0 = len(segs)
        for seg in t:
            if isinstance(seg, p.Lit):
                segs.append((SEG_LIT, lit[seg.data]))
            else:
                segs.append((SEG_HOLE, seg.slot))
        return seg0, len(segs) - seg0

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
            row[:3] = (OP_DELETE, len(dels), len(i.slots))
            dels.extend(i.slots)
        elif isinstance(i, p.ISet):
            kind, v = i.src[0], i.src[1]
            if kind == "int":
                row[:4] = (OP_SET, i.out_slot, SRC_INT, _i32(v, "set"))
            elif kind == "str":
                row[:4] = (OP_SET, i.out_slot, SRC_STR, lit[v])
            elif kind == "copy":
                row[:4] = (OP_SET, i.out_slot, SRC_COPY, v)
            else:
                row[:5] = (OP_SET, i.out_slot, SRC_TMPL, *tmpl(v))
        elif isinstance(i, p.IMath):
            row[:4] = (OP_MATH, i.out_slot, len(rpn), len(i.ops))
            for op in i.ops:
                if op[0] == "const":
                    rpn.append((RPN_CONST, _i32(op[1], "math constant")))
                elif op[0] in ("slot", "length"):
                    rpn.append((RPN_SLOT if op[0] == "slot" else RPN_LENGTH,
                                op[1]))
                else:
                    rpn.append((_RPN[op[0]], 0))
            depth = max(depth, rpn_depth(i.ops))
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
        else:
            raise NotPorted(f"pc {pc}: {type(i).__name__}; {_NOT_PORTED}")
    if depth > RPN_MAX_STACK:
        raise NotPorted(f"math needs a stack of {depth} > {RPN_MAX_STACK}")

    slots = np.array(
        [(_KIND[cols.kind(s)], cols.stype(s), cols.sint(s), cols.slen(s),
          cols.str_row.get(s, -1)) for s in range(cols.S)], np.int32)

    def table(rows, width):
        return np.array(rows, np.int32).reshape(-1, width) if rows else \
            np.zeros((0, width), np.int32)

    return TurboTables(
        ins=ins, segs=table(segs, 2), ents=table(ents, 4),
        rpn=table(rpn, 2), dels=np.array(dels, np.int32),
        pairs=table(pairs, 2), elems=table(elems, 2), slots=slots,
        lits=lit_table.array(), lit_len=lit_table.lengths(),
        rpn_depth=depth, width=lit_table.w)
