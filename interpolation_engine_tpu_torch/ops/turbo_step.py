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

Each function counts its launches in ``.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..vm import turbo_tables as tt
from ..vm.state import T_EMPTY, T_INT, T_LIST, T_STR

RUNNING, DONE, PARKED = 0, 1, 2
C_PC, C_STATUS, C_STEPS, C_OUTLEN, C_CLREPOCH = 0, 1, 2, 3, 8
MAX_WIDTH = 512          # csrc/turbo_step.cu MAX_W
_POW10 = [10 ** k for k in range(10)]


@dataclass
class StepTables:
    """A plan's tables on one device: ``flat`` and ``lits`` for the kernel
    and the plain version's data, ``host`` (numpy) for the plain version's
    control flow."""
    host: tt.TurboTables
    flat: torch.Tensor   # int32
    lits: torch.Tensor   # (L, W) uint8

    @classmethod
    def on(cls, host: tt.TurboTables, device) -> "StepTables":
        return cls(host=host,
                   flat=torch.from_numpy(host.flat()).to(device),
                   lits=torch.from_numpy(host.lits).to(device))


def _check(tables: StepTables, batch) -> None:
    regs, sbuf, out = batch
    dev = regs.device
    for name, t, dtype, dim in (("regs", regs, torch.int32, 2),
                                ("sbuf", sbuf, torch.uint8, 3),
                                ("out", out, torch.uint8, 2)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"{name}: want {dtype} {dim}-d on {dev}, got "
                             f"{t.dtype} {t.dim()}-d on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n = regs.shape[0]
    if sbuf.shape[1] != n or out.shape[0] != n:
        raise ValueError(f"row counts differ: regs {n}, sbuf "
                         f"{sbuf.shape[1]}, out {out.shape[0]}")
    host = tables.host
    if sbuf.shape[2] != host.width:
        raise ValueError(f"sbuf width {sbuf.shape[2]} != tables' "
                         f"{host.width}")
    if host.slots.size:
        if int(host.slots[:, 1:4].max()) >= regs.shape[1]:
            raise ValueError("register row narrower than the slot columns")
        if int(host.slots[:, 4].max()) >= sbuf.shape[0]:
            raise ValueError("fewer string rows than the plan's slots")
    if tables.flat.device != dev or tables.lits.device != dev:
        raise ValueError(f"tables on {tables.flat.device}, batch on {dev}")


def turbo_step(tables: StepTables, batch, k_steps: int, block: int = 128):
    """``k_steps`` VM steps on every RUNNING lane of ``batch`` (a
    ``TurboBatch`` of regs (N, REGW) int32, sbuf (R, N, W) uint8, out
    (N, OW) uint8), in place; returns ``batch``."""
    _check(tables, batch)
    regs, sbuf, out = batch
    if regs.device.type == "cpu":
        return turbo_step_reference(tables, batch, k_steps)
    if regs.device.type != "cuda":
        raise ValueError(f"no turbo step for device {regs.device}")
    if sbuf.shape[2] > MAX_WIDTH:
        raise ValueError(f"width {sbuf.shape[2]} > kernel maximum "
                         f"{MAX_WIDTH}")
    from .build import load
    lib = load()
    with torch.cuda.device(regs.device):
        rc = lib.turbo_step_launch(
            tables.flat.data_ptr(), tables.lits.data_ptr(), regs.data_ptr(),
            sbuf.data_ptr(), out.data_ptr(), regs.shape[0], regs.shape[1],
            sbuf.shape[2], out.shape[1], int(k_steps), int(block),
            torch.cuda.current_stream(regs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"turbo_step_kernel launch failed: CUDA error "
                           f"{rc} ({lib.turbo_error_string(rc).decode()})")
    turbo_step.launches += 1
    return batch


turbo_step.launches = 0


def turbo_step_reference(tables: StepTables, batch, k_steps: int):
    """The plain PyTorch version of ``turbo_step_kernel``: the same steps
    on the same tensors, on any device."""
    turbo_step_reference.launches += 1
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
                lanes.commit()
    return batch


turbo_step_reference.launches = 0


class _Lanes:
    """The lanes at one pc: copies of their register rows and of the
    string/output rows an instruction touches, written back by commit."""

    def __init__(self, tables: StepTables, batch, idx):
        self.t = tables
        self.batch = batch
        self.idx = idx
        self.m = idx.numel()
        self.dev = idx.device
        self.W = tables.host.width
        self.regs = batch.regs.index_select(0, idx)
        self.rows: dict = {}
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

    def out_rows(self) -> torch.Tensor:
        if self.out is None:
            self.out = self.batch.out.index_select(0, self.idx)
        return self.out

    def full(self, v) -> torch.Tensor:
        return torch.full((self.m,), v, dtype=torch.int64, device=self.dev)

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


def _render(L: _Lanes, host, seg0: int, nseg: int):
    """Template → (buf (m, W) zero past the length, min(length, W),
    missing, park); the TPU kernel's _render (vm/turbo.py:744)."""
    W = L.W
    buf = torch.zeros((L.m, W), dtype=torch.uint8, device=L.dev)
    ln = L.full(0)
    missing = torch.zeros(L.m, dtype=torch.bool, device=L.dev)
    park = missing.clone()
    for kind, v in host.segs[seg0:seg0 + nseg].tolist():
        if kind == tt.SEG_LIT:
            n = int(host.lit_len[v])
            buf = _place(buf, ln, L.t.lits[v][None, :], L.full(n))
            ln = ln + n
            continue
        k, cst, cint, clen, srow = host.slots[v].tolist()
        st = L.reg(cst)
        missing |= st == T_EMPTY
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
    pos = torch.arange(W, device=L.dev)[None, :]
    buf = torch.where(pos < ln[:, None], buf, 0)
    return buf, ln.clamp(max=W), missing, park


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
    park = torch.zeros(L.m, dtype=torch.bool, device=L.dev)
    for op, arg in host.rpn[q0:q0 + nq].tolist():
        if op == tt.RPN_CONST:
            stack.append(L.full(arg))
        elif op == tt.RPN_SLOT:
            _k, cst, cint, clen, srow = host.slots[arg].tolist()
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
            _k, cst, _ci, clen, _r = host.slots[arg].tolist()
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


# ---- one function per opcode: (lanes, tables, pc, ins row) -------------------

def _halt(L, host, pc, ins):
    L.set(C_STATUS, DONE)


def _nop(L, host, pc, ins):
    L.advance(L.full(0).bool(), pc + 1)


def _goto(L, host, pc, ins):
    L.advance(L.full(0).bool(), int(ins[1]))


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
    L.advance(L.full(0).bool(), pc + 1)


def _delete(L, host, pc, ins):
    a, b = int(ins[1]), int(ins[2])
    for s in host.dels[a:a + b].tolist():
        L.set(int(host.slots[s, 1]), T_EMPTY)
    L.advance(L.full(0).bool(), pc + 1)


def _set(L, host, pc, ins):
    out_slot, src, c, d = (int(x) for x in ins[1:5])
    vbuf = None
    park = L.full(0).bool()
    if src == tt.SRC_INT:
        vt, vi, vln = L.full(T_INT), L.full(c), L.full(0)
    elif src == tt.SRC_STR:
        vt, vi = L.full(T_STR), L.full(0)
        vln = L.full(int(host.lit_len[c]))
        vbuf = L.t.lits[c][None, :].expand(L.m, -1)
    elif src == tt.SRC_COPY:
        _k, cst, cint, clen, srow = host.slots[c].tolist()
        vt, vi = L.reg(cst), L.reg(cint)
        park = vt == T_EMPTY
        if srow >= 0:
            vbuf, vln = L.row(srow), L.reg(clen)
        else:
            vln = L.full(0)
    else:
        vbuf, vln, missing, park = _render(L, host, c, d)
        park = park | missing
        vt, vi = L.full(T_STR), L.full(0)
    ok = ~park
    _k, ost, oint, olen, orow = host.slots[out_slot].tolist()
    if vbuf is not None and orow >= 0:
        L.set_row(orow, vbuf, ok)
    L.set(ost, vt, ok)
    L.set(oint, vi, ok)
    L.set(olen, vln, ok)
    L.advance(park, pc + 1)


def _math(L, host, pc, ins):
    out_slot, q0, nq = (int(x) for x in ins[1:4])
    val, park = _eval_rpn(L, host, q0, nq)
    ok = ~park
    _k, ost, oint, olen, _r = host.slots[out_slot].tolist()
    L.set(ost, T_INT, ok)
    L.set(oint, val, ok)
    L.set(olen, 0, ok)
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
    decided = L.full(0).bool()
    tgt = L.full(0)
    if op == tt.OP_GOTOMAP:
        buf, ln, missing, park = _render(L, host, a, b)
        for ent in host.ents[c:c + d].tolist():
            hit = _match(L, host, ent, buf, ln) & ~decided
            tgt = torch.where(hit, ent[3], tgt)
            decided |= hit
    else:
        missing = L.reg(int(host.slots[a, 1])) == T_EMPTY
        park = L.full(0).bool()
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
        _k, cst, cint, clen, srow = host.slots[slot].tolist()
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
    L.advance(L.full(0).bool(), torch.where(exiting, exit_pc, pc + 1))


def _for_next(L, host, pc, ins):
    lc, head_pc = int(ins[1]), int(ins[2])
    L.set(lc, L.reg(lc) + 1)
    L.advance(L.full(0).bool(), head_pc)


_EXEC = {
    tt.OP_HALT: _halt, tt.OP_NOP: _nop, tt.OP_GOTO: _goto,
    tt.OP_PARK: _park, tt.OP_CLEAR: _clear, tt.OP_DELETE: _delete,
    tt.OP_SET: _set, tt.OP_MATH: _math, tt.OP_PRINT: _print,
    tt.OP_GOTOMAP: _goto_map, tt.OP_GOTOMAP_INT: _goto_map,
    tt.OP_FORHEAD: _for_head, tt.OP_FORNEXT: _for_next,
}
