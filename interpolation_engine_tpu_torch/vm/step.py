"""The general VM step: every RUNNING row executes the instruction at its pc.

The counterpart of ``interpolation_engine_tpu/vm/step.py``. The JAX step is
one instance's instruction under ``vmap``, dispatched by ``lax.switch``.
Here one step reads the distinct pcs of the RUNNING rows (one host sync)
and runs each pc's handler on that pc's rows, with the instruction's
operands and its aux record as Python ints read from the numpy tables, so
loop bounds are Python ints and a handler is plain batched tensor code. A
batch in lockstep (the usual case) is one group over the whole batch, with
no gather. Rows never interact, so the state after a step is the JAX step's,
field for field.

Error policy as in the JAX package: a handler that meets anything it does
not do exactly parks the row (PARK_HOST_OP) and the host ring re-executes
the original task.

Every one of the 30 opcodes has its handler. The JAX handlers' loops become
Python loops: a ``fori_loop`` over a static bound loops to that bound (or to
the largest count among the rows), masked per row; a ``while_loop`` loops
to ``max_fix`` with a per-row ``done`` mask. Work whose result a row never
reads (a capture staging for an entry that did not match, a math
evaluation behind an earlier error) runs on the rows that read it only.
``math`` and a ``list_slice`` bound that is a string at run time are
evaluated by the byte math evaluator (``ops/math_kernel.py``), as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .._shared import isa, vm_config
from ..core.events import EVENTS
from ..ops import interp_kernel as ik
from ..ops import match_kernel as mk
from ..ops import math_kernel as mak
from ..ops.interp_kernel import (ERR_ASSERT, ERR_CAPACITY, ERR_HOST,
                                 ERR_MISSING, ERR_OK)
from . import bytestr as bs
from .state import (T_INT, T_LIST, T_STR, VMBatch, arena_write, find_slot,
                    fnv1a, gather_slot, masked_slot_update, store_set)
from .syncs import host_sync

RUNNING, DONE, PARKED = vm_config.RUNNING, vm_config.DONE, vm_config.PARKED
T_FREE, T_NEW, T_READY, T_WAIT, T_DONE = (
    vm_config.T_FREE, vm_config.T_NEW, vm_config.T_READY, vm_config.T_WAIT,
    vm_config.T_DONE)

RPN_LEAF_KEYS = (isa.RPN_HOLE, isa.RPN_LENGTH, isa.RPN_MINLIST,
                 isa.RPN_MAXLIST)
STACK = 8
BIG = 2 ** 31 - 1
MAX_CONCAT = 8        # list_concat's lists
MAX_REPLACE = 16      # replace_map's entries
MAX_WILDCARDS = 12    # delete's and delete_except's wildcards
LCG_MUL, LCG_ADD = 1664525, 1013904223   # random_choice's uint32 LCG


# a resolved operand: the interpolation kernel's tagged union
Value = ik.InterpResult


def _pad_pow2(arr: np.ndarray, min_size: int = 64) -> np.ndarray:
    n = arr.shape[0]
    target = max(min_size, 1 << (max(n, 1) - 1).bit_length())
    if target == n:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))


def pack_tables(compiled) -> dict:
    """The program tables padded to power-of-two sizes, as the JAX package
    pads them (the padding rows are OP_HALT and zeros, which are inert, but
    clamped reads see the padded sizes)."""
    labels = np.asarray(compiled.labels, np.int32).reshape(-1, 5)
    if labels.shape[0] == 0:
        labels = np.full((1, 5), -1, np.int32)
    return {
        "code": _pad_pow2(np.asarray(compiled.code, np.int32)),
        "aux": _pad_pow2(np.asarray(compiled.aux, np.int32)),
        "strtab": _pad_pow2(np.asarray(compiled.strtab, np.uint8)),
        "labels": _pad_pow2(labels, min_size=8),
    }


def used_opcodes(compiled) -> frozenset:
    return frozenset(int(op) for op in np.unique(
        np.asarray(compiled.code, np.int32).reshape(-1, 4)[:, 0]))


def _w(c, a, b) -> torch.Tensor:
    return torch.where(c, a, b).to(torch.int32)


def _pick(mask: torch.Tensor, a: Value, b: Value) -> Value:
    """Per row, the value ``a`` where mask else ``b``."""
    return Value(*(torch.where(mask[:, None] if x.dim() == 2 else mask, x,
                               y.to(x.dtype)) for x, y in zip(a, b)))


def _hard(err, verr) -> torch.Tensor:
    """An interpolation's error other than a missing key, then its
    ``value_to_bytes`` error where no key was missing."""
    missing = err == ERR_MISSING
    return _w((err != ERR_OK) & ~missing, err,
              _w(~missing & (verr != ERR_OK), verr, ERR_OK))


def select(mask: torch.Tensor, new: VMBatch, old: VMBatch) -> VMBatch:
    """Per row, ``new`` where mask else ``old`` (fields shared by both are
    kept as they are)."""
    out = []
    for a, b in zip(new, old):
        if a is b:
            out.append(a)
        else:
            m = mask.view((-1,) + (1,) * (a.dim() - 1))
            out.append(torch.where(m, a, b))
    return VMBatch(*out)


class GeneralStep:
    """The general step for one compiled program and one ``VMConfig``, on
    one device. ``step(batch)`` runs one instruction on every RUNNING row;
    ``run(batch, n)`` runs n steps. Neither changes its input."""

    def __init__(self, compiled, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        t = pack_tables(compiled)
        self.code, self.aux = t["code"], t["aux"]
        self.strtab_np, self.labels_np = t["strtab"], t["labels"]
        dev = self.device
        self.strtab = torch.from_numpy(self.strtab_np).to(dev)
        ms = cfg.max_str
        self._zero = torch.zeros((1, ms), dtype=torch.uint8, device=dev)
        self._tmpl_cache: dict = {}
        lab = self.labels_np
        self.lab_scope = torch.from_numpy(lab[:, 0].astype(np.int64)).to(dev)
        self.lab_hash = torch.from_numpy(
            lab[:, 1].astype(np.uint32).astype(np.int64)).to(dev)
        self.lab_target = torch.from_numpy(lab[:, 2].copy()).to(dev)
        rows = [self._tmpl_np(int(o), int(n)) for o, n in lab[:, 3:5]]
        self.lab_buf = torch.from_numpy(np.stack([r[0] for r in rows])).to(
            dev)
        self.lab_len = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                                    device=dev)
        cont = np.zeros((ms,), np.uint8)
        cont[:8] = np.frombuffer(b"CONTINUE", np.uint8)[:ms]
        self._cont = torch.from_numpy(cont).to(dev)
        null = np.zeros((ms,), np.uint8)
        null[:4] = np.frombuffer(b"NULL", np.uint8)[:ms]
        self._null = null
        self._null_t = torch.from_numpy(null).to(dev)
        ops = used_opcodes(compiled)
        # the lane yield only exists in programs that can enter a
        # parallel block (the JAX jit step's specialisation)
        self.has_threads = isa.OP_PAR_BEGIN in ops
        # the recorder's span of each handler, by opcode
        self.op_spans = {op: f"general.op.{name}"
                         for op, name in isa.OP_NAMES.items()}
        self.handlers = {
            isa.OP_HALT: self.h_halt, isa.OP_NOP: self.h_nop,
            isa.OP_SLEEP: self.h_nop, isa.OP_GOTO: self.h_goto,
            isa.OP_CLEAR: self.h_clear, isa.OP_PRINT_LIT: self.h_print_lit,
            isa.OP_PRINT: self.h_print,
            isa.OP_SET: lambda st, a, b, c: self.h_set(st, a, False),
            isa.OP_SET_LN: lambda st, a, b, c: self.h_set(st, a, True),
            isa.OP_UNESCAPE: self.h_unescape, isa.OP_MATH: self.h_math,
            isa.OP_MATH_RPN:
                lambda st, a, b, c: self.h_math_rpn(st, a, False),
            isa.OP_MATH_RPN_LN:
                lambda st, a, b, c: self.h_math_rpn(st, a, True),
            isa.OP_GOTO_MAP: self.h_goto_map,
            isa.OP_GOTO_MAP_LIT: self.h_goto_map_lit, isa.OP_PARK: self.h_park,
            isa.OP_LIST_APPEND: self.h_list_append,
            isa.OP_LIST_SLICE: self.h_list_slice,
            isa.OP_LIST_JOIN: self.h_list_join,
            isa.OP_LIST_CONCAT: self.h_list_concat,
            isa.OP_LIST_REMOVE: self.h_list_remove,
            isa.OP_LIST_INDEX: self.h_list_index,
            isa.OP_REPLACE_MAP: self.h_replace_map,
            isa.OP_DELETE:
                lambda st, a, b, c: self.h_delete(st, a, b, False),
            isa.OP_DELETE_EXCEPT:
                lambda st, a, b, c: self.h_delete(st, a, b, True),
            isa.OP_RANDOM_CHOICE: self.h_random_choice,
            isa.OP_FOR_HEAD: self.h_for_head, isa.OP_FOR_NEXT: self.h_for_next,
            isa.OP_PAR_BEGIN: self.h_par_begin,
            isa.OP_THREAD_END: self.h_thread_end,
        }

    # ---- tables ---------------------------------------------------------

    def axu(self, i: int) -> int:
        return int(self.aux[min(max(i, 0), self.aux.shape[0] - 1)])

    def _tmpl_np(self, off: int, ln: int):
        """``bytestr.from_table`` on the string table for constant operands:
        (max_str bytes, length)."""
        ms = self.cfg.max_str
        table = self.strtab_np
        off = min(max(off, 0), table.shape[0])
        chunk = np.pad(table, (0, ms))[off:off + ms].copy()
        chunk[max(ln, 0):] = 0
        return chunk, ln

    def tmpl(self, off: int, ln: int, n: int):
        """A constant template as (n, max_str) rows and lengths."""
        key = (off, ln)
        row = self._tmpl_cache.get(key)
        if row is None:
            buf, _ = self._tmpl_np(off, ln)
            row = self._tmpl_cache[key] = host_sync(
                torch.Tensor.to, torch.from_numpy(buf), self.device)[None, :]
        return row.expand(n, -1), bs.col(ln, n, self.device)

    def _is_null(self, off: int, ln: int) -> bool:
        """The constant template at (off, ln) is the ``NULL`` key."""
        buf, _ = self._tmpl_np(off, ln)
        return ln == 4 and bool((buf == self._null).all())

    def zeros(self, n: int) -> torch.Tensor:
        return self._zero.expand(n, -1)

    def i32(self, v, n: int) -> torch.Tensor:
        return bs.col(v, n, self.device)

    # ---- operand resolution ----------------------------------------------

    def interp_tmpl(self, st: VMBatch, off: int, ln: int) -> ik.InterpResult:
        buf, length = self.tmpl(off, ln, st.n)
        return ik.interpolate(st, buf, length, self.cfg)

    def value(self, n, err=ERR_OK, vtype=T_STR, vint=0, buf=None, length=0,
              pool_off=0, pool_len=0) -> Value:
        c = self.i32
        return Value(c(err, n), c(vtype, n), c(vint, n),
                     self.zeros(n) if buf is None else buf, c(length, n),
                     c(pool_off, n), c(pool_len, n))

    def resolve_vspec(self, st: VMBatch, base: int):
        """The value spec at aux[base:base+3], without changing st; a list
        literal is only reported (see materialize_list). Returns (value,
        raw kind)."""
        kind, x, y = self.axu(base), self.axu(base + 1), self.axu(base + 2)
        k = min(max(kind, 0), 3)
        n = st.n
        if k == isa.VK_STR:
            return self.interp_tmpl(st, x, y), kind
        if k == isa.VK_INT:
            return self.value(n, vtype=T_INT, vint=x), kind
        if k == isa.VK_LIST:
            return self.value(n, vtype=T_LIST, pool_off=x, pool_len=y), kind
        return self.value(n, err=ERR_HOST), kind

    def materialize_list(self, st: VMBatch, base: int, count: int):
        """Write a list literal's elements (nested value specs) into the
        pool; returns (st', pool_base, count, err)."""
        cfg = self.cfg
        n = st.n
        pool_base = st.pool_top
        err = self.i32(ERR_OK, n)
        for i in range(min(max(count, 0), cfg.max_list)):
            val, _ = self.resolve_vspec(st, base + 3 * i)
            # element templates resolving to lists defer to the host
            elem_err = _w(val.vtype == T_LIST, ERR_HOST, val.err)
            st2, eoff, ov = arena_write(st, val.buf, val.length, cfg)
            use_str = val.vtype == T_STR
            st2 = st2._replace(
                arena=torch.where(use_str[:, None], st2.arena, st.arena),
                arena_top=torch.where(use_str, st2.arena_top, st.arena_top))
            idx = (pool_base + i).clamp(0, cfg.pool_size - 1)
            pool_ov = (pool_base + i) >= cfg.pool_size
            msu = masked_slot_update
            st2 = st2._replace(
                pool_type=msu(st2.pool_type, idx, val.vtype),
                pool_int=msu(st2.pool_int, idx, val.vint),
                pool_off=msu(st2.pool_off, idx, _w(use_str, eoff, 0)),
                pool_len=msu(st2.pool_len, idx, val.length))
            step_err = torch.where(
                elem_err != ERR_OK, elem_err,
                torch.where((use_str & ov) | pool_ov, ERR_CAPACITY, ERR_OK))
            commit = err == ERR_OK
            st = select(commit, st2, st)
            err = _w(commit & (step_err != ERR_OK), step_err, err)
        if count > cfg.max_list:
            err = self.i32(ERR_HOST, n)
        st = st._replace(pool_top=_w(err == ERR_OK, pool_base + count,
                                     st.pool_top))
        return st, pool_base, self.i32(count, n), err

    def resolve_list_operand(self, st: VMBatch, base: int):
        """A value spec that must give a list: (st', pool_off, count,
        err)."""
        val, kind = self.resolve_vspec(st, base)
        if kind == isa.VK_LIST:
            return self.materialize_list(st, self.axu(base + 1),
                                         self.axu(base + 2))
        err = torch.where(val.err != ERR_OK, val.err,
                          torch.where(val.vtype != T_LIST, ERR_ASSERT,
                                      ERR_OK))
        return st, val.pool_off, val.pool_len, err.to(torch.int32)

    def interp_name(self, st: VMBatch, off: int, ln: int,
                    literal: bool = False):
        """An output_name template as key bytes (it must give a string);
        a literal name (brace-free by the compiler's proof) is not
        interpolated."""
        if literal:
            buf, length = self.tmpl(off, ln, st.n)
            return buf, length, self.i32(ERR_OK, st.n)
        r = self.interp_tmpl(st, off, ln)
        buf, length, verr = ik.value_to_bytes(r, self.cfg.max_str)
        return buf, length, _w(r.err != ERR_OK, r.err, verr)

    def set_value(self, st: VMBatch, name_buf, name_len, val: Value):
        """Store a resolved value under a key; returns (st', err)."""
        cfg = self.cfg
        st2, soff, sov = arena_write(st, val.buf, val.length, cfg)
        use_str = val.vtype == T_STR
        is_list = val.vtype == T_LIST
        st2 = st2._replace(
            arena=torch.where(use_str[:, None], st2.arena, st.arena),
            arena_top=torch.where(use_str, st2.arena_top, st.arena_top))
        voff = _w(use_str, soff, _w(is_list, val.pool_off, 0))
        vlen = _w(use_str, val.length, _w(is_list, val.pool_len, 0))
        st3, set_ov = store_set(st2, name_buf, name_len, val.vtype,
                                val.vint, voff, vlen, cfg)
        err = torch.where(val.err != ERR_OK, val.err,
                          torch.where((use_str & sov) | set_ov,
                                      ERR_CAPACITY, ERR_OK))
        return st3, err.to(torch.int32)

    def advance(self, st: VMBatch, err, new_st: VMBatch, jump_pc=None):
        """Commit new_st and move on where err is OK; elsewhere keep st and
        park for the host. Either way the step counts and last_err is
        set."""
        ok = err == ERR_OK
        committed = select(ok, new_st, st)
        next_pc = st.pc + 1 if jump_pc is None else jump_pc
        return committed._replace(
            pc=_w(ok, next_pc, st.pc),
            status=_w(ok, committed.status, PARKED),
            park_kind=_w(ok, committed.park_kind, vm_config.PARK_HOST_OP),
            park_arg=_w(ok, committed.park_arg, st.pc),
            steps=st.steps + 1,
            last_err=err.to(torch.int32))

    def _arena(self, st: VMBatch, off, ln):
        ms = self.cfg.max_str
        return bs.normalize(bs.window(st.arena, off, ms), ln), \
            bs.col(ln, st.n, st.arena.device)

    def pool_elem_value(self, st: VMBatch, idx) -> Value:
        idx = idx.clamp(0, self.cfg.pool_size - 1)
        et = gather_slot(st.pool_type, idx)
        buf, ln = self._arena(st, gather_slot(st.pool_off, idx),
                              gather_slot(st.pool_len, idx))
        is_str = et == T_STR
        n = st.n
        return Value(self.i32(ERR_OK, n), et, gather_slot(st.pool_int, idx),
                     torch.where(is_str[:, None], buf, 0).to(torch.uint8),
                     _w(is_str, ln, 0), self.i32(0, n), self.i32(0, n))

    def value_as_str(self, val: Value):
        buf, ln, verr = ik.value_to_bytes(val, self.cfg.max_str)
        return buf, ln, _w(val.err != ERR_OK, val.err, verr)

    def _append_out(self, st: VMBatch, buf, ln):
        O = self.cfg.out_size
        merged = bs.write_span(st.out, st.out_len.clamp(0, O),
                               bs.fit(buf, O), ln)
        total = st.out_len + ln
        # a length beyond the payload would append nulls: overflow
        over = (total > O) | (ln > buf.shape[1])
        return merged, total.clamp(max=O), over

    # ---- handlers: (st, a, b, c) -> st ----------------------------------

    def h_halt(self, st, a, b, c):
        return st._replace(status=_w(st.status == RUNNING, DONE, st.status))

    def h_nop(self, st, a, b, c):
        # also sleep: the batched VM runs it as a zero-time tick
        return st._replace(pc=st.pc + 1, steps=st.steps + 1)

    def h_goto(self, st, a, b, c):
        return self.advance(st, self.i32(ERR_OK, st.n), st, jump_pc=a)

    def h_clear(self, st, a, b, c):
        return self.advance(st, self.i32(ERR_OK, st.n), st._replace(
            out=torch.zeros_like(st.out), out_len=self.i32(0, st.n)))

    def h_print(self, st, a, b, c):
        val, _ = self.resolve_vspec(st, a)
        sbuf, slen, verr = self.value_as_str(val)
        # an int or a list through print crashes or defers in the
        # reference: the host does it
        verr = _w((val.err == ERR_OK) & (val.vtype != T_STR), ERR_HOST, verr)
        ubuf, ulen = bs.unescape_braces(sbuf, slen)
        new_out, new_len, ov = self._append_out(st, ubuf, ulen)
        err = torch.where(verr != ERR_OK, verr,
                          torch.where(ov, ERR_CAPACITY, ERR_OK))
        return self.advance(st, err, st._replace(out=new_out,
                                                 out_len=new_len))

    def h_print_lit(self, st, a, b, c):
        """print of a brace-free literal: no interpolation at all."""
        sbuf, slen = self.tmpl(self.axu(a), self.axu(a + 1), 1)
        ubuf, ulen = bs.unescape_braces(sbuf, slen)
        n = st.n
        new_out, new_len, ov = self._append_out(
            st, ubuf.expand(n, -1), ulen.expand(n))
        return self.advance(st, _w(ov, ERR_CAPACITY, ERR_OK),
                            st._replace(out=new_out, out_len=new_len))

    def h_set(self, st, a, literal_name: bool):
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a),
                                            self.axu(a + 1), literal_name)
        val, kind = self.resolve_vspec(st, a + 2)
        st_use = st
        if kind == isa.VK_LIST:
            st_use, lit_off, lit_cnt, lit_err = self.materialize_list(
                st, self.axu(a + 3), self.axu(a + 4))
            val = val._replace(err=lit_err, vtype=self.i32(T_LIST, st.n),
                               pool_off=lit_off, pool_len=lit_cnt)
        st3, serr = self.set_value(st_use, nbuf, nlen, val)
        err = torch.where(nerr != ERR_OK, nerr,
                          torch.where(val.err != ERR_OK, val.err, serr))
        return self.advance(st, err, st3)

    def h_unescape(self, st, a, b, c):
        """A string template interpolates (task level), unescapes its
        braces and interpolates again; a first result that is no string
        passes through untouched. An int literal stores directly; any other
        kind defers to the host."""
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a), self.axu(a + 1))
        kind, x, y = self.axu(a + 2), self.axu(a + 3), self.axu(a + 4)
        if kind == isa.VK_STR:
            first = self.interp_tmpl(st, x, y)
            ubuf, ulen = bs.unescape_braces(first.buf, first.length)
            second = ik.interpolate(st, ubuf, ulen, self.cfg)
            second = second._replace(err=_w(first.err != ERR_OK, first.err,
                                            second.err))
            val = _pick(first.vtype == T_STR, second, first)
        elif kind == isa.VK_INT:
            val = self.value(st.n, vtype=T_INT, vint=x)
        else:
            return self.advance(st, _w(nerr != ERR_OK, nerr, ERR_HOST), st)
        st3, serr = self.set_value(st, nbuf, nlen, val)
        return self.advance(st, self._first_err(nerr, val.err, serr), st3)

    def _resolve_label(self, scope_id: int, name_buf, name_len, own_pc):
        """Dynamic label lookup; CONTINUE goes to own_pc + 1. The hash hit
        is byte-checked against the label's own name."""
        h = fnv1a(name_buf, name_len)
        is_continue = bs.equal(name_buf, name_len, self._cont, 8)
        hit = (self.lab_scope == scope_id)[None, :] \
            & (self.lab_hash[None, :] == h[:, None])
        nl = hit.shape[1]
        row = torch.where(hit, torch.arange(nl, device=hit.device)[None, :],
                          nl).amin(dim=1)
        row = torch.where(hit.any(dim=1), row, 0)
        # name_len > 0 also rejects the zero pad rows of the label table
        found = hit.any(dim=1) & (name_len > 0) & bs.equal(
            name_buf, name_len, self.lab_buf[row], self.lab_len[row])
        pc = torch.where(is_continue, own_pc + 1,
                         torch.where(found, self.lab_target[row], -1))
        return pc.to(torch.int32), is_continue

    def h_goto_map_lit(self, st, a, b, c):
        """goto_map whose keys and targets are all literal: the text
        interpolates; each entry is one wildcard match on raw bytes."""
        cfg, n = self.cfg, st.n
        text_r = self.interp_tmpl(st, self.axu(a), self.axu(a + 1))
        scope_id = self.axu(a + 2)
        tbuf, tlen, tverr = ik.value_to_bytes(text_r, cfg.max_str)
        interp_error = text_r.err == ERR_MISSING
        hard_err = _hard(text_r.err, tverr)
        matched = torch.zeros(n, dtype=torch.bool, device=self.device)
        tgt_off = tgt_len = self.i32(0, n)
        null_off = null_len = 0
        has_null = False
        loop_err = self.i32(ERR_OK, n)
        for e in range(min(b, 32)):
            base = a + 3 + 5 * e
            koff, kln = self.axu(base), self.axu(base + 1)
            is_null = self._is_null(koff, kln)
            kbuf, klen = self.tmpl(koff, kln, 1)
            m = mk.wildcard_match(kbuf, klen, tbuf, tlen, cfg.max_stars)
            hit = m.ok & ~matched & ~interp_error
            loop_err = _w((loop_err == ERR_OK) & ~m.supported, ERR_HOST,
                          loop_err)
            tgt_off = _w(hit, self.axu(base + 2), tgt_off)
            tgt_len = _w(hit, self.axu(base + 3), tgt_len)
            matched = matched | hit
            if is_null and not has_null:
                null_off, null_len = self.axu(base + 2), self.axu(base + 3)
            has_null = has_null or is_null
        if b > 32:
            loop_err = self.i32(ERR_HOST, n)
        use_null = interp_error
        gbuf, glen = bs.from_table(self.strtab,
                                   _w(use_null, null_off, tgt_off),
                                   _w(use_null, null_len, tgt_len),
                                   cfg.max_str)
        jump, _ = self._resolve_label(scope_id, gbuf, glen, st.pc)
        err = torch.where(
            hard_err != ERR_OK, hard_err,
            torch.where(loop_err != ERR_OK, loop_err,
                        torch.where(
                            (use_null & (not has_null))
                            | (~use_null & ~matched) | (jump < 0),
                            ERR_ASSERT, ERR_OK)))
        return self.advance(st, err, st, jump_pc=jump)

    def h_goto_map(self, st, a, b, c):
        """goto_map with template keys or targets: every key and every
        target interpolates, matched or not (an error in an entry never
        chosen still decides the result); the first wildcard match wins,
        and the first NULL entry where the text has a missing key."""
        cfg, n = self.cfg, st.n
        text_r = self.interp_tmpl(st, self.axu(a), self.axu(a + 1))
        scope_id = self.axu(a + 2)
        tbuf, tlen, tverr = ik.value_to_bytes(text_r, cfg.max_str)
        interp_error = text_r.err == ERR_MISSING
        hard_err = _hard(text_r.err, tverr)
        matched = torch.zeros(n, dtype=torch.bool, device=self.device)
        has_null = torch.zeros_like(matched)
        tgt_buf = null_buf = self.zeros(n)
        tgt_len = null_len = self.i32(0, n)
        loop_err = self.i32(ERR_OK, n)
        for e in range(min(b, 32)):
            base = a + 3 + 5 * e
            kbuf, klen, kerr = self.value_as_str(
                self.interp_tmpl(st, self.axu(base), self.axu(base + 1)))
            vbuf, vlen, verr = self.value_as_str(
                self.interp_tmpl(st, self.axu(base + 2), self.axu(base + 3)))
            is_null = bs.equal(kbuf, klen, self._null_t, 4)
            m = mk.wildcard_match(kbuf, klen, tbuf, tlen, cfg.max_stars)
            hit = m.ok & ~matched & ~interp_error
            loop_err = _w(loop_err == ERR_OK,
                          self._first_err(kerr, verr, _w(~m.supported,
                                                         ERR_HOST, ERR_OK)),
                          loop_err)
            tgt_buf = torch.where(hit[:, None], vbuf, tgt_buf)
            tgt_len = _w(hit, vlen, tgt_len)
            matched = matched | hit
            first_null = is_null & ~has_null
            null_buf = torch.where(first_null[:, None], vbuf, null_buf)
            null_len = _w(first_null, vlen, null_len)
            has_null = has_null | is_null
        if b > 32:
            loop_err = self.i32(ERR_HOST, n)
        use_null = interp_error
        jump, _ = self._resolve_label(
            scope_id, torch.where(use_null[:, None], null_buf, tgt_buf),
            _w(use_null, null_len, tgt_len), st.pc)
        err = self._first_err(
            hard_err, loop_err,
            _w((use_null & ~has_null) | (~use_null & ~matched) | (jump < 0),
               ERR_ASSERT, ERR_OK))
        return self.advance(st, err, st, jump_pc=jump)

    def _list_reduce(self, st, looked, want_max: bool):
        base, cnt = looked.pool_off, looked.pool_len
        pos = bs.positions(self.cfg.pool_size, self.device)[None, :]
        in_span = (pos >= base[:, None]) & (pos < (base + cnt)[:, None])
        is_int = st.pool_type == T_INT
        use = in_span & is_int
        value = torch.where(use, st.pool_int, -BIG).amax(dim=1) if want_max \
            else torch.where(use, st.pool_int, BIG).amin(dim=1)
        all_int = (~in_span | is_int).all(dim=1)
        err = torch.where(
            looked.err != ERR_OK, looked.err,
            torch.where(looked.vtype != T_LIST, ERR_ASSERT,
                        torch.where(cnt == 0, ERR_ASSERT,
                                    torch.where(~all_int, ERR_HOST,
                                                ERR_OK))))
        return value.to(torch.int32), err.to(torch.int32)

    def _rpn_leaf(self, st, kind: int, x: int, y: int):
        """(value, err) of an RPN leaf."""
        n = st.n
        if kind == isa.RPN_CONST:
            return self.i32(x, n), self.i32(ERR_OK, n)
        kbuf, klen = self.tmpl(x, y, n)
        looked = ik.lookup(st, kbuf, klen, self.cfg)
        if kind == isa.RPN_HOLE:
            # digit-string values count as ints too (the reference
            # re-parses the text after interpolation)
            parsed, parse_ok = bs.bytes_to_int(looked.buf, looked.length)
            is_int = looked.vtype == T_INT
            val = _w(is_int, looked.vint, parsed)
            err = torch.where(
                looked.err != ERR_OK, looked.err,
                torch.where(is_int, ERR_OK,
                            torch.where((looked.vtype == T_STR) & parse_ok,
                                        ERR_OK, ERR_HOST)))
            return val, err.to(torch.int32)
        if kind == isa.RPN_LENGTH:
            err = torch.where(looked.err != ERR_OK, looked.err,
                              torch.where(looked.vtype != T_LIST,
                                          ERR_ASSERT, ERR_OK))
            return looked.pool_len, err.to(torch.int32)
        return self._list_reduce(st, looked, kind != isa.RPN_MINLIST)

    def h_math_rpn(self, st, a, literal_name: bool):
        """Statically compiled math: a short RPN program over int32 whose
        leaves are store lookups. The stack depth depends only on the entry
        kinds, so it is a Python int; the values are per row. Arithmetic
        runs in int64 and wraps to int32; // and % take the divisor's
        sign."""
        n = st.n
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a), self.axu(a + 1),
                                            literal_name)
        n_entries = self.axu(a + 2)
        stack = [self.i32(0, n)] * STACK
        sp = 0
        err = self.i32(ERR_OK, n)
        for i in range(min(max(n_entries, 0), 24)):
            base = a + 3 + 3 * i
            kind, x, y = (self.axu(base), self.axu(base + 1),
                          self.axu(base + 2))
            top = stack[min(max(sp - 1, 0), STACK - 1)].to(torch.int64)
            snd = stack[min(max(sp - 2, 0), STACK - 1)].to(torch.int64)
            if kind == isa.RPN_CONST or kind in RPN_LEAF_KEYS:
                new_val, step_err = self._rpn_leaf(st, kind, x, y)
                new_sp = sp + 1
            elif kind in (isa.RPN_NEG, isa.RPN_SIGN):
                new_val = bs.to_i32(-top) if kind == isa.RPN_NEG \
                    else torch.sign(top).to(torch.int32)
                step_err = self.i32(ERR_OK, n)
                new_sp = sp
            else:
                safe_top = torch.where(top == 0, 1, top)
                if kind == isa.RPN_ADD:
                    v = snd + top
                elif kind == isa.RPN_SUB:
                    v = snd - top
                elif kind == isa.RPN_MUL:
                    v = snd * top
                elif kind == isa.RPN_DIV:
                    v = torch.div(snd, safe_top, rounding_mode="floor")
                elif kind == isa.RPN_MOD:
                    v = torch.remainder(snd, safe_top)
                elif kind == isa.RPN_MIN2:
                    v = torch.minimum(snd, top)
                else:
                    v = torch.maximum(snd, top)
                new_val = bs.to_i32(v)
                step_err = self.i32(ERR_OK, n)
                if kind == isa.RPN_DIV:
                    exact = torch.remainder(snd, safe_top) == 0
                    # an inexact division parks for the host
                    step_err = _w(~exact, ERR_HOST,
                                  _w(top == 0, ERR_ASSERT, ERR_OK))
                elif kind == isa.RPN_MOD:
                    step_err = _w(top == 0, ERR_ASSERT, ERR_OK)
                new_sp = sp - 1
            stack[min(max(new_sp - 1, 0), STACK - 1)] = new_val
            err = _w((err == ERR_OK) & (step_err != ERR_OK), step_err, err)
            sp = new_sp
        if sp != 1:
            err = _w(err == ERR_OK, ERR_ASSERT, err)
        val = self.value(n, vtype=T_INT, vint=stack[0])
        st2, seterr = self.set_value(st, nbuf, nlen, val)
        err = torch.where(nerr != ERR_OK, nerr,
                          torch.where(err != ERR_OK, err, seterr))
        return self.advance(st, err, st2)

    def h_math(self, st, a, b, c):
        """Math the compiler could not lower to RPN: the task-level
        interpolation, the evaluator's own second interpolation, then the
        byte math evaluator (``ops/math_kernel.py``, with Python's floor
        ``//`` and ``%`` and the int32 wrap), on the rows without an error
        so far; the int result is stored."""
        cfg = self.cfg
        first = self.interp_tmpl(st, self.axu(a), self.axu(a + 1))
        fbuf, flen, ferr = self.value_as_str(first)
        sbuf, slen, serr = self.value_as_str(
            ik.interpolate(st, fbuf, flen, cfg))
        res = mak.on_rows((ferr == ERR_OK) & (serr == ERR_OK),
                      lambda s, bf, ln: mak.eval_math_bytes(s, bf, ln, cfg),
                      st, sbuf, slen)
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a + 2),
                                            self.axu(a + 3))
        st2, seterr = self.set_value(st, nbuf, nlen, self.value(
            st.n, vtype=T_INT, vint=res.value))
        return self.advance(st, self._first_err(ferr, serr, res.err, nerr,
                                                seterr), st2)

    def _copy_list_span(self, st: VMBatch, src_base, count, skip_idx=None):
        """Copy pool descriptors [src_base, src_base + count) to the pool
        top, leaving out index ``skip_idx`` of the span where it lies in
        it; returns (st', new_base, new_count, err)."""
        cfg = self.cfg
        L = cfg.pool_size
        dst_base = st.pool_top
        count = bs.col(count, st.n, self.device)
        j = bs.positions(L, self.device)[None, :] - dst_base[:, None]
        out_count, shift = count, 0
        if skip_idx is not None:
            has_skip = (skip_idx >= 0) & (skip_idx < count)
            shift = (has_skip[:, None] & (j >= skip_idx[:, None])).to(
                torch.int32)
            out_count = count - has_skip.to(torch.int32)
        src = (src_base[:, None] + j + shift).clamp(0, L - 1).long()
        valid = (j >= 0) & (j < out_count[:, None])
        st = st._replace(**{
            f: torch.where(valid, torch.gather(getattr(st, f), 1, src),
                           getattr(st, f))
            for f in ("pool_type", "pool_int", "pool_off", "pool_len")})
        overflow = dst_base + out_count > L
        err = _w(count > cfg.max_list, ERR_HOST,
                 _w(overflow, ERR_CAPACITY, ERR_OK))
        n_written = _w(overflow, 0, out_count)
        st = st._replace(pool_top=_w(err == ERR_OK, dst_base + n_written,
                                     st.pool_top))
        return st, dst_base, n_written, err

    def h_list_append(self, st, a, b, c):
        cfg = self.cfg
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        item, _ = self.resolve_vspec(st1, a + 3)
        item_err = _w(item.vtype == T_LIST, ERR_HOST, item.err)
        st2, new_base, new_cnt, cerr = self._copy_list_span(st1, lbase, lcnt)
        st3, ioff, iov = arena_write(st2, item.buf, item.length, cfg)
        use_str = item.vtype == T_STR
        st3 = st3._replace(
            arena=torch.where(use_str[:, None], st3.arena, st2.arena),
            arena_top=torch.where(use_str, st3.arena_top, st2.arena_top))
        dst = (new_base + new_cnt).clamp(0, cfg.pool_size - 1)
        pool_ov = (new_base + new_cnt) >= cfg.pool_size
        msu = masked_slot_update
        st3 = st3._replace(
            pool_type=msu(st3.pool_type, dst, item.vtype),
            pool_int=msu(st3.pool_int, dst, item.vint),
            pool_off=msu(st3.pool_off, dst, _w(use_str, ioff, 0)),
            pool_len=msu(st3.pool_len, dst, item.length),
            pool_top=(new_base + new_cnt + 1).to(torch.int32))
        nbuf, nlen, nerr = self.interp_name(st3, self.axu(a + 6),
                                            self.axu(a + 7))
        val = self.value(st.n, vtype=T_LIST, pool_off=new_base,
                         pool_len=new_cnt + 1)
        st4, seterr = self.set_value(st3, nbuf, nlen, val)
        err = self._first_err(lerr, item_err, cerr,
                              _w((use_str & iov) | pool_ov, ERR_CAPACITY,
                                 ERR_OK), nerr, seterr)
        return self.advance(st, err, st4)

    @staticmethod
    def _first_err(*errs) -> torch.Tensor:
        """The first error that is not OK, per row."""
        out = errs[-1]
        for e in reversed(errs[:-1]):
            out = _w(e != ERR_OK, e, out)
        return out

    @staticmethod
    def _slice_index(index, lcnt, right: bool):
        """The reference's 1-based slice bound (quirks kept)."""
        return _w(index > 0, index - 1,
                  _w(index < 0, lcnt + index, 0 if right else -10 ** 6))

    def _math_operand(self, st: VMBatch, val: Value):
        """A from_index/to_index value (the JAX step's ``_math_operand``):
        an int passes through; a string is interpolated again and evaluated
        by the byte math evaluator (the reference re-interpolates in
        ``eval_math``). Only the rows holding a string without an error
        are evaluated: elsewhere the result is never read."""
        cfg = self.cfg
        is_str = val.vtype == T_STR
        value = val.vint
        str_err = torch.zeros_like(val.err)
        rows = host_sync(torch.nonzero, is_str & (val.err == ERR_OK))[:, 0]
        if rows.numel():
            sub = st.take(rows)
            second = ik.interpolate(sub, val.buf.index_select(0, rows),
                                    val.length.index_select(0, rows), cfg)
            sbuf, slen, serr = ik.value_to_bytes(second, cfg.max_str)
            res = mak.eval_math_bytes(sub, sbuf, slen, cfg)
            err = self._first_err(second.err, serr, res.err)
            value = value.index_copy(0, rows, res.value)
            str_err = str_err.index_copy(0, rows, err)
        err = torch.where(val.err != ERR_OK, val.err,
                          torch.where(val.vtype == T_LIST, ERR_HOST,
                                      str_err))
        return value, err.to(torch.int32)

    def h_list_slice(self, st, a, b, c):
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        from_val, _ = self.resolve_vspec(st1, a + 3)
        to_val, _ = self.resolve_vspec(st1, a + 6)
        from_i, ferr = self._math_operand(st1, from_val)
        to_i, terr = self._math_operand(st1, to_val)
        start = self._slice_index(from_i, lcnt, right=False)
        end = self._slice_index(to_i, lcnt, right=True) + 1
        # Python slice clamping
        start_c = torch.minimum(start.clamp(min=0), lcnt)
        end_c = torch.minimum(end.clamp(min=0), lcnt)
        zero_err = _w(from_i == 0, ERR_ASSERT, ERR_OK)
        count = (end_c - start_c).clamp(min=0)
        st2, new_base, new_cnt, cerr = self._copy_list_span(
            st1, lbase + start_c, count)
        nbuf, nlen, nerr = self.interp_name(st2, self.axu(a + 9),
                                            self.axu(a + 10))
        val = self.value(st.n, vtype=T_LIST, pool_off=new_base,
                         pool_len=new_cnt)
        st3, seterr = self.set_value(st2, nbuf, nlen, val)
        err = self._first_err(lerr, ferr, terr, zero_err, cerr, nerr, seterr)
        return self.advance(st, err, st3)

    def _span_bound(self, count: torch.Tensor) -> int:
        """The static loop bound ``max_list`` cut to the largest count among
        the rows (the iterations past it are masked off in every row)."""
        if count.numel() == 0:
            return 0
        return min(self.cfg.max_list, max(0, host_sync(int, count.max())))

    def h_list_join(self, st, a, b, c):
        """before + the string elements joined by between + after; an int
        element or more than max_list elements defers to the host."""
        cfg, n = self.cfg, st.n
        ms = cfg.max_str
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        parts = [self.interp_tmpl(st1, self.axu(a + k), self.axu(a + k + 1))
                 for k in (3, 5, 7)]
        (bbuf, blen, berr), (tbuf, tlen, terr), (abuf, alen, aerr) = [
            ik.value_to_bytes(r, ms) for r in parts]
        strerr = self._first_err(*(r.err for r in parts), berr, terr, aerr)
        buf, ln, join_err = self.zeros(n), self.i32(0, n), self.i32(ERR_OK, n)
        for i in range(self._span_bound(lcnt)):
            ev = self.pool_elem_value(st1, lbase + i)
            buf2, ln2, ov1 = bs.concat(buf, ln, tbuf, tlen if i else 0, ms)
            buf3, ln3, ov2 = bs.concat(buf2, ln2, ev.buf, ev.length, ms)
            step_err = _w(ev.vtype != T_STR, ERR_HOST,
                          _w(ov1 | ov2, ERR_CAPACITY, ERR_OK))
            do = (i < lcnt) & (join_err == ERR_OK)
            buf = torch.where(do[:, None], buf3, buf)
            ln = _w(do, ln3, ln)
            join_err = _w(do & (step_err != ERR_OK), step_err, join_err)
        join_err = _w(lcnt > cfg.max_list, ERR_HOST, join_err)
        out1, l1, ov1 = bs.concat(bbuf, blen, buf, ln, ms)
        out2, l2, ov2 = bs.concat(out1, l1, abuf, alen, ms)
        nbuf, nlen, nerr = self.interp_name(st1, self.axu(a + 9),
                                            self.axu(a + 10))
        st2, seterr = self.set_value(st1, nbuf, nlen,
                                     self.value(n, buf=out2, length=l2))
        err = self._first_err(lerr, strerr, join_err,
                              _w(ov1 | ov2, ERR_CAPACITY, ERR_OK), nerr,
                              seterr)
        return self.advance(st, err, st2)

    @staticmethod
    def _values_equal(ev: Value, item: Value) -> torch.Tensor:
        both_int = (ev.vtype == T_INT) & (item.vtype == T_INT)
        both_str = (ev.vtype == T_STR) & (item.vtype == T_STR)
        return (both_int & (ev.vint == item.vint)) | (both_str & bs.equal(
            ev.buf, ev.length, item.buf, item.length))

    def h_list_remove(self, st, a, b, c):
        """A copy of the list without its first element equal to the item
        (type-exact); an absent item leaves a plain copy."""
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        item, _ = self.resolve_vspec(st1, a + 3)
        item_err = _w(item.vtype == T_LIST, ERR_HOST, item.err)
        found = self.i32(-1, st.n)
        for i in range(self._span_bound(lcnt)):
            eq = (i < lcnt) & self._values_equal(
                self.pool_elem_value(st1, lbase + i), item) & (found < 0)
            found = _w(eq, i, found)
        st2, new_base, new_cnt, cerr = self._copy_list_span(
            st1, lbase, lcnt, skip_idx=_w(found < 0, -999, found))
        nbuf, nlen, nerr = self.interp_name(st2, self.axu(a + 6),
                                            self.axu(a + 7))
        st3, seterr = self.set_value(st2, nbuf, nlen, self.value(
            st.n, vtype=T_LIST, pool_off=new_base, pool_len=new_cnt))
        return self.advance(st, self._first_err(lerr, item_err, cerr, nerr,
                                                seterr), st3)

    def h_list_concat(self, st, a, b, c):
        """The lists copied one after another to the pool top (at most
        MAX_CONCAT). As in JAX, the state of a list that fails is kept with
        the lists before it (the handler's error then discards it all)."""
        n = st.n
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a), self.axu(a + 1))
        dst_base = st.pool_top
        st_c, total, err = st, self.i32(0, n), self.i32(ERR_OK, n)
        for li in range(min(b, MAX_CONCAT)):
            st1, lb, lc, lerr = self.resolve_list_operand(st_c, a + 2 + 3 * li)
            st2, _, copied, cerr = self._copy_list_span(st1, lb, lc)
            step_err = _w(lerr != ERR_OK, lerr, cerr)
            do = err == ERR_OK
            st_c = select(do, st2, st_c)
            total = _w(do & (step_err == ERR_OK), total + copied, total)
            err = _w(do & (step_err != ERR_OK), step_err, err)
        if b > MAX_CONCAT:
            err = self.i32(ERR_HOST, n)
        st2, seterr = self.set_value(st_c, nbuf, nlen, self.value(
            n, vtype=T_LIST, pool_off=dst_base, pool_len=total))
        return self.advance(st, self._first_err(nerr, err, seterr), st2)

    def h_list_index(self, st, a, b, c):
        """The 1-based element (negative from the end); index 0 or past
        either end is ERR_ASSERT; a string index parses as a decimal int."""
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        idx_val, _ = self.resolve_vspec(st1, a + 3)
        parsed, parse_ok = bs.bytes_to_int(idx_val.buf, idx_val.length)
        index = _w(idx_val.vtype == T_INT, idx_val.vint, parsed)
        idx_err = _w(idx_val.err != ERR_OK, idx_val.err,
                     _w(((idx_val.vtype == T_STR) & ~parse_ok)
                        | (idx_val.vtype == T_LIST), ERR_HOST, ERR_OK))
        py_idx = _w(index > 0, index - 1, _w(index < 0, lcnt + index, -1))
        bounds_err = _w((index == 0) | (py_idx < 0) | (py_idx >= lcnt),
                        ERR_ASSERT, ERR_OK)
        ev = self.pool_elem_value(st1, lbase + py_idx)
        nbuf, nlen, nerr = self.interp_name(st1, self.axu(a + 6),
                                            self.axu(a + 7))
        st2, seterr = self.set_value(st1, nbuf, nlen, ev)
        return self.advance(st, self._first_err(lerr, idx_err, bounds_err,
                                                nerr, seterr), st2)

    def h_random_choice(self, st, a, b, c):
        """An element chosen by the JAX package's uint32 LCG (not Python's
        generator): rng' = rng * 1664525 + 1013904223 mod 2^32, index
        (rng' >> 8) % count; the new rng commits with the store."""
        st1, lbase, lcnt, lerr = self.resolve_list_operand(st, a)
        rng = (st.rng * LCG_MUL + LCG_ADD) & bs.M32
        idx = torch.where(lcnt > 0, (rng >> 8) % lcnt.clamp(min=1).long(), 0)
        ev = self.pool_elem_value(st1, lbase + idx.to(torch.int32))
        nbuf, nlen, nerr = self.interp_name(st1, self.axu(a + 3),
                                            self.axu(a + 4))
        st2, seterr = self.set_value(st1, nbuf, nlen, ev)
        err = self._first_err(lerr, _w(lcnt == 0, ERR_ASSERT, ERR_OK), nerr,
                              seterr)
        return self.advance(st, err, st2._replace(rng=rng))

    # ---- replace_map ------------------------------------------------------

    def _stage_captures(self, st: VMBatch, subj, m) -> VMBatch:
        """A temporary store holding a match's captures under the keys
        '1'..'9'. The arena and slot overflow flags of the staging are
        ignored, as the JAX step ignores them."""
        cfg = self.cfg
        for ci in range(cfg.max_stars):
            clen = m.cap_len[:, ci]
            cbuf, _ = bs.substring(subj, m.cap_off[:, ci], clen, cfg.max_str)
            st2, coff, _ = arena_write(st, cbuf, clen, cfg)
            digit = torch.zeros((st.n, cfg.max_key), dtype=torch.uint8,
                                device=self.device)
            digit[:, 0] = 49 + ci
            st3, _ = store_set(st2, digit, 1, T_STR, 0, coff, clen, cfg)
            st = select(ci < m.n_caps, st3, st)
        return st

    def _replace_round(self, st: VMBatch, cur_buf, cur_len, a: int, b: int):
        """One round of replace_map on the rows of st: the current string
        interpolated again, then the first entry whose interpolated key
        matches it gives the new string, its value interpolated against the
        match's captures. Returns (buf, len, missing, hard error)."""
        cfg, n = self.cfg, st.n
        ms = cfg.max_str
        r = ik.interpolate(st, cur_buf, cur_len, cfg)
        rbuf, rlen, rverr = ik.value_to_bytes(r, ms)
        missing = r.err == ERR_MISSING
        hard = _hard(r.err, rverr)
        matched = torch.zeros_like(missing)
        out_buf, out_len = rbuf, rlen
        e_missing = torch.zeros_like(missing)
        e_hard = self.i32(ERR_OK, n)
        for e in range(min(b, MAX_REPLACE)):
            base = a + 6 + 4 * e
            key_r = self.interp_tmpl(st, self.axu(base), self.axu(base + 1))
            kbuf, klen, kverr = ik.value_to_bytes(key_r, ms)
            k_missing = key_r.err == ERR_MISSING
            k_hard = _hard(key_r.err, kverr)
            m = mk.wildcard_match(kbuf, klen, rbuf, rlen, cfg.max_stars)
            hit = ~matched & m.ok & ~k_missing & (k_hard == ERR_OK)
            # the value only matters where the entry matched
            vbuf, vlen = self.zeros(n), self.i32(0, n)
            v_missing, v_hard = torch.zeros_like(hit), self.i32(ERR_OK, n)
            rows = host_sync(torch.nonzero, hit)[:, 0]
            if rows.numel():
                sub_m = mk.MatchResult(*(t.index_select(0, rows) for t in m))
                caps = self._stage_captures(st.take(rows),
                                            rbuf.index_select(0, rows), sub_m)
                val_r = self.interp_tmpl(caps, self.axu(base + 2),
                                         self.axu(base + 3))
                vb, vl, vv = ik.value_to_bytes(val_r, ms)
                vbuf = vbuf.index_copy(0, rows, vb)
                vlen = vlen.index_copy(0, rows, vl)
                v_missing = v_missing.index_copy(0, rows,
                                                 val_r.err == ERR_MISSING)
                v_hard = v_hard.index_copy(0, rows, _hard(val_r.err, vv))
            use = hit & ~v_missing & (v_hard == ERR_OK)
            out_buf = torch.where(use[:, None], vbuf, out_buf)
            out_len = _w(use, vlen, out_len)
            e_missing = e_missing | (~matched & k_missing) | (hit & v_missing)
            e_hard = _w((e_hard == ERR_OK) & ~matched,
                        self._first_err(k_hard, _w(~m.supported, ERR_HOST,
                                                   ERR_OK),
                                        _w(hit, v_hard, ERR_OK)), e_hard)
            matched = matched | hit
        over = ERR_HOST if b > MAX_REPLACE else ERR_OK
        return (out_buf, out_len, missing | e_missing,
                self._first_err(hard, e_hard, self.i32(over, n)))

    def h_replace_map(self, st, a, b, c):
        """Wildcard replacement, in rounds: each round re-interpolates the
        current string and applies the first matching entry (at most
        MAX_REPLACE). It stops on a stable string, after one round unless
        ``repeat``, on a missing key or an error, or at ``max_fix`` rounds
        (not converged: the host). A missing key takes the raw value of the
        first NULL entry (none: ERR_ASSERT); an int item passes through."""
        cfg, n = self.cfg, st.n
        nbuf, nlen, nerr = self.interp_name(st, self.axu(a + 3),
                                            self.axu(a + 4))
        repeat = self.axu(a + 5) == 1
        item, ikind = self.resolve_vspec(st, a)
        item_hard = _w((item.err == ERR_OK) & (item.vtype == T_LIST),
                       ERR_HOST, ERR_HOST if ikind == isa.VK_LIST else ERR_OK)
        cur_buf, cur_len, iverr = ik.value_to_bytes(item, cfg.max_str)
        missing = item.err == ERR_MISSING
        hard = _w((item.err != ERR_OK) & ~missing, item.err,
                  _w(item_hard != ERR_OK, item_hard,
                     _w(~missing & (iverr != ERR_OK), iverr, ERR_OK)))
        done = missing | (hard != ERR_OK)
        iters = self.i32(0, n)
        for _ in range(cfg.max_fix):
            rows = host_sync(torch.nonzero, ~done)[:, 0]
            if rows.numel() == 0:
                break
            whole = rows.numel() == n
            sub = st if whole else st.take(rows)
            cb = cur_buf if whole else cur_buf.index_select(0, rows)
            cl = cur_len if whole else cur_len.index_select(0, rows)
            ob, ol, r_missing, r_hard = self._replace_round(sub, cb, cl, a, b)
            r_missing = r_missing | missing.index_select(0, rows)
            r_hard = self._first_err(hard.index_select(0, rows), r_hard)
            stable = bs.equal(ob, ol, cb, cl)
            fin = stable | (not repeat) | r_missing | (r_hard != ERR_OK)
            cur_buf = cur_buf.index_copy(0, rows, ob)
            cur_len = cur_len.index_copy(0, rows, ol)
            missing = missing.index_copy(0, rows, r_missing)
            hard = hard.index_copy(0, rows, r_hard)
            iters = iters.index_copy(0, rows, iters.index_select(0, rows) + 1)
            done = done.index_copy(0, rows, fin)
        hard = _w((hard == ERR_OK) & ~done & (iters >= cfg.max_fix),
                  ERR_HOST, hard)
        # a missing key: the raw (uninterpolated) value of the NULL entry
        null_off = null_len = 0
        for e in range(min(b, MAX_REPLACE)):
            base = a + 6 + 4 * e
            if self._is_null(self.axu(base), self.axu(base + 1)):
                null_off, null_len = self.axu(base + 2), self.axu(base + 3)
                break
        else:
            hard = _w(missing, ERR_ASSERT, hard)
        null_buf, null_ln = self.tmpl(null_off, null_len, n)
        use_buf = torch.where(missing[:, None], null_buf, cur_buf)
        use_len = _w(missing, null_ln, cur_len)
        is_int = (item.err == ERR_OK) & (item.vtype == T_INT)
        val = self.value(n, vtype=_w(is_int, T_INT, T_STR), vint=item.vint,
                         buf=torch.where(is_int[:, None], 0, use_buf).to(
                             torch.uint8),
                         length=_w(is_int, 0, use_len))
        hard = _w(is_int, ERR_OK, hard)
        st2, seterr = self.set_value(st, nbuf, nlen, val)
        return self.advance(st, self._first_err(nerr, hard, seterr), st2)

    # ---- delete -------------------------------------------------------------

    def h_delete(self, st, a, b, keep_matching: bool):
        """delete (keep_matching False) and delete_except: slot by slot, in
        order, each occupied key is matched against every wildcard (at most
        MAX_WILDCARDS), each interpolated against the store as deleted so
        far, so a wildcard naming a key deleted at an earlier slot finds it
        missing. A wildcard's interpolation changes only in the rows where
        a slot was deleted, so only those rows interpolate it again."""
        cfg, n = self.cfg, st.n
        n_wc = min(b, MAX_WILDCARDS)
        st_c, err = st, self.i32(ERR_OK, n)
        wilds = [None] * n_wc
        stale = None     # rows deleted from since the wildcards' results
        for s in range(cfg.n_slots):
            occ = st_c.occ[:, s]
            if not host_sync(bool, occ.any()):
                continue
            rows = (None if stale is None
                    else host_sync(torch.nonzero, stale)[:, 0])
            for w in range(n_wc):
                if stale is None:
                    wilds[w] = self._wildcard(st_c, a + 2 * w)
                elif rows.numel():
                    part = self._wildcard(st_c.take(rows), a + 2 * w)
                    wilds[w] = tuple(t.index_copy(0, rows, p)
                                     for t, p in zip(wilds[w], part))
            stale = torch.zeros_like(occ)
            kbuf, klen = self._arena(st_c, st_c.key_off[:, s],
                                     st_c.key_len[:, s])
            any_match, werr = torch.zeros_like(occ), self.i32(ERR_OK, n)
            for wbuf, wlen, werr2 in wilds:
                m = mk.wildcard_match(wbuf, wlen, kbuf, klen, cfg.max_stars)
                werr = _w(werr == ERR_OK, _w(werr2 != ERR_OK, werr2, _w(
                    ~m.supported, ERR_HOST, ERR_OK)), werr)
                any_match = any_match | m.ok
            if b > MAX_WILDCARDS:
                werr = self.i32(ERR_HOST, n)
            gone = occ & (~any_match if keep_matching else any_match)
            st_c = st_c._replace(occ=masked_slot_update(
                st_c.occ, _w(gone, s, -1), False))
            stale = gone
            err = _w(occ & (werr != ERR_OK) & (err == ERR_OK), werr, err)
        return self.advance(st, err, st_c)

    def _wildcard(self, st: VMBatch, base: int):
        """A delete wildcard interpolated: (buf, len, err)."""
        return self.value_as_str(self.interp_tmpl(st, self.axu(base),
                                                  self.axu(base + 1)))

    def h_for_head(self, st, a, b, c):
        cfg = self.cfg
        n = st.n
        loop_id = min(max(self.axu(a), 0), cfg.max_loops - 1)
        exit_pc = self.axu(a + 1)
        counter = st.counters[:, loop_id]
        entering = counter == 0
        # every pair list must be a list, all of one length
        n_pairs = min(b, 4)
        st1, length, err0 = st, self.i32(0, n), self.i32(ERR_OK, n)
        for i in range(n_pairs):
            st1, _, lc, lerr = self.resolve_list_operand(
                st1, a + 2 + 5 * i + 2)
            if i == 0:
                length = lc
            neq = (lc != length) if i > 0 else torch.zeros_like(entering)
            err0 = _w(err0 == ERR_OK,
                      _w(lerr != ERR_OK, lerr, _w(neq, ERR_ASSERT, ERR_OK)),
                      err0)
        if b > 4:
            err0 = self.i32(ERR_HOST, n)
        cur = _w(entering, 1, counter)
        exiting = cur > length
        # the loop variables of this iteration
        st_c, err1 = st1, self.i32(ERR_OK, n)
        for i in range(n_pairs):
            name_base = a + 2 + 5 * i
            nbuf, nlen, nerr = self.interp_name(
                st_c, self.axu(name_base), self.axu(name_base + 1))
            st2, lb, _, lerr = self.resolve_list_operand(st_c, name_base + 2)
            ev = self.pool_elem_value(st2, lb + cur - 1)
            st3, serr = self.set_value(st2, nbuf, nlen, ev)
            step_err = _w(nerr != ERR_OK, nerr, _w(lerr != ERR_OK, lerr,
                                                   serr))
            commit = ~exiting & (err1 == ERR_OK)
            st_c = select(commit, st3, st_c)
            err1 = _w(commit & (step_err != ERR_OK), step_err, err1)
        counters = st_c.counters.clone()
        counters[:, loop_id] = _w(exiting, 0, cur)
        err = _w(err0 != ERR_OK, err0, err1)
        jump = _w(exiting, exit_pc, st.pc + 1)
        return self.advance(st, err, st_c._replace(counters=counters),
                            jump_pc=jump)

    def h_for_next(self, st, a, b, c):
        loop_id = min(max(b, 0), self.cfg.max_loops - 1)
        counters = st.counters.clone()
        counters[:, loop_id] += 1
        return self.advance(st, self.i32(ERR_OK, st.n),
                            st._replace(counters=counters), jump_pc=a)

    def h_park(self, st, a, b, c):
        """A literal-name await_insert (b, c: the key's bytes) whose key is
        present continues in-step (the host twin's poll does not yield);
        every other park kind, an absent key or an ambiguous hash parks."""
        n = st.n
        if a == vm_config.PARK_AWAIT_INSERT and c > 0:
            kbuf, klen = self.tmpl(b, c, n)
            found, _, collide = find_slot(st, kbuf, klen)
            ready = found & ~collide
        else:
            ready = torch.zeros(n, dtype=torch.bool, device=self.device)
        return st._replace(
            pc=_w(ready, st.pc + 1, st.pc),
            steps=_w(ready, st.steps + 1, st.steps),
            status=_w(ready, st.status, PARKED),
            park_kind=_w(ready, st.park_kind, a),
            park_arg=_w(ready, st.park_arg, st.pc))

    # ---- parallel_wait / parallel_race thread lanes -----------------------

    def _lanes(self, n: int) -> torch.Tensor:
        return bs.positions(self.cfg.max_threads, self.device)[None, :] \
            .expand(n, -1)

    def _pick(self, st: VMBatch, mask):
        """The first lane in mask, cyclic from cur_tid + 1."""
        nt = self.cfg.max_threads
        lane = self._lanes(st.n)
        start = _w(st.cur_tid < 0, 0, st.cur_tid + 1)
        rot = (start[:, None] + lane) % nt
        hit = torch.gather(mask, 1, rot.long())
        first = torch.where(hit, lane, nt).amin(dim=1)
        first = torch.where(hit.any(dim=1), first, 0)
        return hit.any(dim=1), gather_slot(rot, first)

    def h_par_begin(self, st, a, b, c):
        nt, n = self.cfg.max_threads, st.n
        K = self.axu(a + 1)
        loop_lo, loop_hi = self.axu(a + 3), self.axu(a + 4)
        entries = [self.axu(a + 5 + l) for l in range(nt)]
        tpc = [entries[l] if l < K else 0 for l in range(nt)]
        tstate = [T_NEW if l < K else T_FREE for l in range(nt)]
        # reset the loop counters of the block: a raced (cancelled) lane may
        # have left one mid-loop, and a re-entered block restarts its loops
        li = torch.arange(self.cfg.max_loops, device=self.device)[None, :]
        counters = torch.where((li >= loop_lo) & (li < loop_hi), 0,
                               st.counters).to(torch.int32)
        row = lambda v: host_sync(  # noqa: E731
            torch.tensor, v, dtype=torch.int32,
            device=self.device)[None, :].expand(n, -1).contiguous()
        zeros = torch.zeros((n, nt), dtype=torch.int32, device=self.device)
        return st._replace(
            tpc=row(tpc), tstate=row(tstate), tpark_kind=zeros,
            tpark_arg=zeros.clone(), cur_tid=self.i32(0, n),
            par_mode=self.i32(self.axu(a), n),
            par_join=self.i32(self.axu(a + 2), n), counters=counters,
            pc=self.i32(entries[0], n), steps=st.steps + 1)

    def h_thread_end(self, st, a, b, c):
        nt, n = self.cfg.max_threads, st.n
        K = self.axu(a + 1)
        lane = self._lanes(n)
        cur = st.cur_tid.clamp(0, nt - 1)
        tstate = _w(lane == cur[:, None], T_DONE, st.tstate)
        st = st._replace(tstate=tstate, steps=st.steps + 1)
        started = lane < K
        new_left = (started & (tstate == T_NEW)).any(dim=1)
        wait_left = (started & (tstate == T_WAIT)).any(dim=1)
        ready_left = (started & (tstate == T_READY)).any(dim=1)
        all_done = (~started | (tstate == T_DONE)).all(dim=1)
        wait_mode = st.par_mode == vm_config.PM_WAIT
        # wait: done when every lane is; race/drain: done when no lane has
        # a slice coming (NEW: its first, READY: its continuation, WAIT:
        # its cancel)
        complete = torch.where(wait_mode, all_done,
                               ~new_left & ~wait_left & ~ready_left)
        drain = ~wait_mode & ~complete
        any_run, nxt = self._pick(st, (tstate == T_NEW) | (tstate == T_READY))
        par_mode = _w(drain, vm_config.PM_DRAIN, st.par_mode)
        pick_pc = _w(any_run, gather_slot(st.tpc, nxt), st.pc)
        go = complete | any_run
        return st._replace(
            pc=_w(complete, st.par_join, pick_pc),
            status=_w(go, RUNNING, PARKED),
            park_kind=_w(go, st.park_kind, vm_config.PARK_THREADS),
            park_arg=_w(go, st.park_arg, st.pc),
            cur_tid=_w(complete, -1, _w(any_run, nxt, -1)),
            par_mode=_w(complete, 0, par_mode),
            par_join=_w(complete, 0, st.par_join),
            tstate=_w(complete[:, None], 0, tstate),
            par_epoch=st.par_epoch + complete.to(torch.int32))

    def thread_yield(self, st_new: VMBatch) -> VMBatch:
        """After the step: a park inside a parallel block suspends the
        current lane (WAIT, with its park kind and pc) and parks the row
        for the ring, which decides which lane runs next."""
        nt = self.cfg.max_threads
        parked = (st_new.status == PARKED) & (st_new.par_mode > 0) \
            & (st_new.cur_tid >= 0) \
            & (st_new.park_kind != vm_config.PARK_THREADS)
        cur = st_new.cur_tid.clamp(0, nt - 1)
        sel = parked[:, None] & (self._lanes(st_new.n) == cur[:, None])
        return st_new._replace(
            tstate=_w(sel, T_WAIT, st_new.tstate),
            tpark_kind=_w(sel, st_new.park_kind[:, None], st_new.tpark_kind),
            tpark_arg=_w(sel, st_new.park_arg[:, None], st_new.tpark_arg),
            tpc=_w(sel, st_new.park_arg[:, None], st_new.tpc),
            park_kind=_w(parked, vm_config.PARK_THREADS, st_new.park_kind))

    # ---- dispatch ---------------------------------------------------------

    def _run_group(self, st: VMBatch, pc: int) -> VMBatch:
        op, a, b, c = (int(v) for v in self.code[pc])
        op = min(max(op, 0), isa.N_OPS - 1)
        with EVENTS.span(self.op_spans[op]):
            new = self.handlers[op](st, a, b, c)
            return self.thread_yield(new) if self.has_threads else new

    def step(self, batch: VMBatch) -> VMBatch:
        """One instruction on every RUNNING row, grouped by pc; recorded
        as a ``general.step`` span, its groups as ``general.gather``, a
        ``general.op.<opcode>`` span a handler and ``general.scatter``."""
        with EVENTS.span("general.step"):
            return self._step(batch)

    def _step(self, batch: VMBatch) -> VMBatch:
        n_code = self.code.shape[0]
        running = batch.status == RUNNING
        key = torch.where(running, batch.pc.clamp(0, n_code - 1), -1)
        uniq, counts = host_sync(torch.unique, key, return_counts=True)
        pairs = host_sync(torch.Tensor.tolist,
                          torch.stack([uniq.to(torch.int64), counts]))
        groups = [(p, k) for p, k in zip(*pairs) if p >= 0]
        EVENTS.count("general.groups", len(groups))
        if not groups:
            return batch
        if len(groups) == 1 and groups[0][1] == batch.n:
            return self._run_group(batch, groups[0][0])
        with EVENTS.span("general.gather"):
            order = torch.sort(key, stable=True).indices
            out = [t.clone() for t in batch]
        start = batch.n - sum(k for _, k in groups)   # non-running first
        for pc, k in groups:
            idx = order[start:start + k]
            start += k
            with EVENTS.span("general.gather"):
                sub = batch.take(idx)
            new = self._run_group(sub, pc)
            with EVENTS.span("general.scatter"):
                for o, t in zip(out, new):
                    o.index_copy_(0, idx, t)
        return VMBatch(*out)

    def run(self, batch: VMBatch, n_steps: int) -> VMBatch:
        for _ in range(n_steps):
            batch = self.step(batch)
        return batch
