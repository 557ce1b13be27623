"""The byte math evaluator: an interpolated expression evaluated in int32,
batched over rows.

The counterpart of ``interpolation_engine_tpu/ops/math_kernel.py`` (jnp
under ``vmap``, no Pallas): the same results, ``(err, value)`` per row,
errors and values on error included. The expression is reduced innermost
paren first, up to ``MAX_PARENS`` groups, dispatching ``length``, ``min``,
``max``, ``round`` and ``sign`` where a function name precedes the group;
the paren-free rest is evaluated with Python's operator semantics.

A row is ``(MS,)`` uint8 bytes with an int32 length. The paren passes are
batched torch. The paren-free evaluation (``eval_flat``) and the min/max
over a comma list (``_eval_enum_minmax``) launch ``csrc/math_eval.cu`` on
CUDA tensors (a block of 128 rows staged in shared memory, one thread a
row, one walk over its bytes: ``math_eval_kernel``)
or raise; on CPU tensors, and only there, they run their plain versions,
``eval_flat_reference`` and ``eval_enum_minmax_reference``, which work on
any device so that they can be held against the kernel on the card. The
plain flat evaluator is one state machine per row over ``(N, STACK)``
operand and operator stacks: each pass of its loop moves every live row by
one event (a byte scanned, a digit consumed, an operator reduced), so rows
of different shapes advance side by side, each in its own order, as the JAX
``while_loop`` runs them one by one. Values are int64 tensors holding
int32s, wrapped after every operation.

Device restrictions, as in the JAX package (ERR_HOST defers to the host):
true division only when exact, no '.' literals, no '**' with a negative
exponent, no min/max over string lists. '%' and '//' floor as Python's do
(``torch.remainder``, ``rounding_mode="floor"``, never ``fmod``); unary
minus binds tighter than '*', '/', '%' and looser than '**', which is
right-associative.

A kernel launch counts as ``kernel.math_eval``, and a call of a plain
version as ``plain.eval_flat`` or ``plain.eval_enum_minmax``, in
``EVENTS`` (``core/events.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.events import EVENTS
from ..vm import bytestr as bs
from ..vm.state import T_INT, T_LIST
from ..vm.syncs import host_sync
from .interp_kernel import ERR_ASSERT, ERR_CAPACITY, ERR_HOST, ERR_OK, lookup

LPAREN, RPAREN, COMMA, DOT = 40, 41, 44, 46
MAX_PARENS = 8
STACK = 16

OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD, OP_POW, OP_FLOORDIV, OP_NEG = \
    1, 2, 3, 4, 5, 6, 7, 8
#             0  +  -  *  /  %  ** //  neg
_PRECEDENCE = (0, 1, 1, 2, 2, 2, 4, 2, 3)
_RIGHT_ASSOC = (0, 0, 0, 0, 0, 0, 1, 0, 1)
# the bytes that end a word before '(' (the reference's word splitting)
_SPLIT = (32, 40, 41, 43, 45, 42, 47, 94, 37)
# bytes of an enumeration: ' .0123456789+-*/%,'
_ENUM = (32, 46, 43, 45, 42, 47, 37, 44) + tuple(range(48, 58))

_FN_NONE, _FN_LENGTH, _FN_MIN, _FN_MAX, _FN_ROUND, _FN_SIGN = range(6)
_FUNCTIONS = ((_FN_LENGTH, "length"), (_FN_MIN, "min"), (_FN_MAX, "max"),
              (_FN_ROUND, "round"), (_FN_SIGN, "sign"))


class EvalResult(NamedTuple):
    err: torch.Tensor    # int32, one of ERR_*
    value: torch.Tensor  # int32


def _is_digit(b: torch.Tensor) -> torch.Tensor:
    return (b >= 48) & (b <= 57)


def _is_any(b: torch.Tensor, codes) -> torch.Tensor:
    return torch.isin(b, host_sync(torch.tensor, codes, dtype=b.dtype,
                                   device=b.device))


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[r, idx[r]] with the index clamped to the row, as a JAX gather."""
    i = idx.clamp(0, t.shape[1] - 1).long()
    return torch.gather(t, 1, i[:, None])[:, 0]


def _put(t: torch.Tensor, idx: torch.Tensor, val, mask) -> torch.Tensor:
    """A copy of t with t[r, clip(idx[r])] = val[r] where mask[r]."""
    i = idx.clamp(0, t.shape[1] - 1).long()[:, None]
    val = torch.as_tensor(val, dtype=t.dtype, device=t.device).expand(
        t.shape[0])
    new = t.scatter(1, i, val[:, None])
    return torch.where(mask[:, None], new, t)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 wrapped to the int32 range, kept as int64."""
    return bs.to_i32(x).to(torch.int64)


def _pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ** b by repeated int32 multiplication, b clipped to [0, 31]."""
    times = b.clamp(0, 31)
    acc = torch.ones_like(a)
    for k in range(31):
        acc = torch.where(k < times, _wrap(acc * a), acc)
    return acc


def _reduce_once(nums, ns, ops, os):
    """Apply each row's top operator (the JAX ``_reduce_once``); returns
    (nums, ns, os, err)."""
    op = _at(ops, os - 1)
    is_unary = op == OP_NEG
    b = _at(nums, ns - 1)
    a = torch.where(is_unary, 0, _at(nums, ns - 2))
    safe_b = torch.where(b == 0, 1, b)
    mod_val = torch.remainder(a, safe_b)
    div_val = _wrap(torch.div(a, safe_b, rounding_mode="floor"))
    val = torch.where(op == OP_ADD, _wrap(a + b),
          torch.where(op == OP_SUB, _wrap(a - b),
          torch.where(op == OP_MUL, _wrap(a * b),
          torch.where((op == OP_DIV) | (op == OP_FLOORDIV), div_val,
          torch.where(op == OP_MOD, mod_val,
          torch.where(op == OP_POW, _pow(a, b),
          torch.where(is_unary, _wrap(-b), 0)))))))
    err = torch.where((op == OP_DIV) & (mod_val != 0), ERR_HOST,
          torch.where(((op == OP_DIV) | (op == OP_MOD) | (op == OP_FLOORDIV))
                      & (b == 0), ERR_ASSERT,
          torch.where((op == OP_POW) & (b < 0), ERR_HOST, ERR_OK)))
    new_ns = torch.where(is_unary, ns, ns - 1)
    nums = _put(nums, new_ns - 1, val, torch.ones_like(is_unary))
    return nums, new_ns, os - 1, err


def math_eval_kernel(buf: torch.Tensor, length,
                     want_max=None) -> EvalResult:
    """Launch ``csrc/math_eval.cu`` on CUDA rows: the flat evaluator, or
    with ``want_max`` (an (N,) bool tensor) min/max over each row's
    comma-separated expressions. Raises if it cannot launch."""
    if buf.dtype != torch.uint8 or buf.dim() != 2:
        raise ValueError(f"buf: want uint8 2-d, got {buf.dtype} "
                         f"{buf.dim()}-d")
    if buf.device.type != "cuda":
        raise ValueError(f"math_eval_kernel needs a CUDA tensor, got "
                         f"{buf.device}")
    rows, ms = buf.shape
    dev = buf.device
    buf = buf.contiguous()
    length = bs.col(length, rows, dev).contiguous()
    if length.shape != (rows,) or length.device != dev:
        raise ValueError(f"length: want ({rows},) on {dev}, got "
                         f"{tuple(length.shape)} on {length.device}")
    if want_max is not None:
        if (want_max.dtype != torch.bool or want_max.shape != (rows,)
                or want_max.device != dev):
            raise ValueError(f"want_max: want ({rows},) bool on {dev}, got "
                             f"{want_max.dtype} {tuple(want_max.shape)} on "
                             f"{want_max.device}")
        want_max = want_max.contiguous()
    err = torch.empty(rows, dtype=torch.int32, device=dev)
    value = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return EvalResult(err, value)
    from .build import launch
    with torch.cuda.device(dev):
        launch("math_eval", buf.data_ptr(), length.data_ptr(),
               None if want_max is None else want_max.data_ptr(), rows, ms,
               err.data_ptr(), value.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    return EvalResult(err, value)


def eval_flat(buf: torch.Tensor, length) -> EvalResult:
    """Evaluate each row's paren-free integer expression with Python's
    semantics: (N, n) uint8 bytes, (N,) lengths. The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if buf.device.type == "cpu":
        return eval_flat_reference(buf, length)
    return math_eval_kernel(buf, length)


def eval_flat_reference(buf: torch.Tensor, length) -> EvalResult:
    """The plain version of ``eval_flat``, batched torch on any device."""
    EVENTS.count("plain.eval_flat")
    rows, n = buf.shape
    dev = buf.device
    length = bs.col(length, rows, dev).to(torch.int64)
    byte = buf.to(torch.int64)
    prec_of = torch.tensor(_PRECEDENCE, dtype=torch.int64, device=dev)
    right_of = torch.tensor(_RIGHT_ASSOC, dtype=torch.int64, device=dev)

    def zeros():
        return torch.zeros(rows, dtype=torch.int64, device=dev)

    i, ns, os, err, v, pend, pend_w = (zeros() for _ in range(7))
    nums = torch.zeros((rows, STACK), dtype=torch.int64, device=dev)
    ops = torch.zeros_like(nums)
    eo = torch.ones(rows, dtype=torch.bool, device=dev)
    saw_dot = torch.zeros_like(eo)
    # 0: scanning; 1: in a run of digits (and dots); 2: reducing the stack
    # before pushing a binary operator
    mode = zeros()
    while True:
        scan = (mode == 0) & (i < length) & (err == ERR_OK)
        dig, red = mode == 1, mode == 2
        if not bool((scan | dig | red).any()):
            break
        b, nxt = _at(byte, i), _at(byte, i + 1)
        reduced = _reduce_once(nums, ns, ops, os)

        # scanning: classify the byte at i
        is_space, is_dig = b == 32, _is_digit(b)
        pair = i + 1 < length
        is_pow = (b == 42) & (nxt == 42) & pair
        is_floordiv = (b == 47) & (nxt == 47) & pair
        op_code = torch.where(is_pow, OP_POW,
                  torch.where(is_floordiv, OP_FLOORDIV,
                  torch.where(b == 43, OP_ADD,
                  torch.where(b == 45, OP_SUB,
                  torch.where(b == 42, OP_MUL,
                  torch.where(b == 47, OP_DIV,
                  torch.where(b == 37, OP_MOD, 0)))))))
        width = torch.where(is_pow | is_floordiv, 2, 1)
        s_space = scan & is_space
        s_dig = scan & ~is_space & is_dig
        s_op = scan & ~is_space & ~is_dig & (op_code != 0)
        s_bad = scan & ~is_space & ~is_dig & (op_code == 0)
        s_unary, s_binary = s_op & eo, s_op & ~eo
        # in a digit run: consume the byte at i, or end the run
        d_go = dig & (i < length) & (is_dig | (b == DOT))
        d_end = dig & ~d_go
        # reducing: one more reduction, or push the pending operator
        top = prec_of[_at(ops, os - 1)]
        prec = prec_of[pend]
        need = torch.where(right_of[pend] == 1, top > prec, top >= prec)
        r_go = red & (os > 0) & (err == ERR_OK) & need
        r_end = red & ~r_go

        # the masks are disjoint: each update below touches its own rows
        i = torch.where(s_space | s_bad, i + 1, i)
        err = torch.where(s_bad & (err == ERR_OK), ERR_ASSERT, err)
        mode = torch.where(s_dig, 1, torch.where(s_binary, 2, mode))
        v = torch.where(s_dig, 0, v)
        saw_dot = saw_dot & ~s_dig
        pend = torch.where(s_binary, op_code, pend)
        pend_w = torch.where(s_binary, width, pend_w)
        # unary: '+x' is the identity, '-x' pushes OP_NEG
        push = s_unary & (op_code == OP_SUB)
        bad = s_unary & (op_code != OP_ADD) & (op_code != OP_SUB)
        err = torch.where(bad, ERR_ASSERT,
                          torch.where(push & (os >= STACK), ERR_HOST, err))
        ops = _put(ops, os, OP_NEG, push)
        os = torch.where(push, os + 1, os)
        i = torch.where(s_unary, i + width, i)

        v = torch.where(d_go & is_dig, _wrap(v * 10 + (b - 48)), v)
        saw_dot = saw_dot | (d_go & (b == DOT))
        i = torch.where(d_go, i + 1, i)
        err = torch.where(d_end, torch.where(
            saw_dot, ERR_HOST, torch.where(
                ~eo, ERR_ASSERT, torch.where(ns >= STACK, ERR_HOST, err))),
            err)
        nums = _put(nums, ns, v, d_end)
        ns = torch.where(d_end, ns + 1, ns)
        eo = eo & ~d_end
        mode = torch.where(d_end, 0, mode)

        r_nums, r_ns, r_os, r_err = reduced
        nums = torch.where(r_go[:, None], r_nums, nums)
        ns = torch.where(r_go, r_ns, ns)
        os = torch.where(r_go, r_os, os)
        err = torch.where(r_go, r_err, err)
        err = torch.where(r_end & (os >= STACK), ERR_HOST, err)
        ops = _put(ops, os, pend, r_end)
        os = torch.where(r_end, os + 1, os)
        i = torch.where(r_end, i + pend_w, i)
        eo = eo | r_end
        mode = torch.where(r_end, 0, mode)

    # an empty expression or a trailing operator
    err = torch.where((err == ERR_OK) & eo, ERR_ASSERT, err)
    while True:
        go = (os > 0) & (err == ERR_OK)
        if not bool(go.any()):
            break
        r_nums, r_ns, r_os, r_err = _reduce_once(nums, ns, ops, os)
        nums = torch.where(go[:, None], r_nums, nums)
        ns = torch.where(go, r_ns, ns)
        os = torch.where(go, r_os, os)
        err = torch.where(go, r_err, err)
    err = torch.where((err == ERR_OK) & (ns != 1), ERR_ASSERT, err)
    return EvalResult(err.to(torch.int32), bs.to_i32(nums[:, 0]))


# ---------------------------------------------------------------------------
# paren reduction and function dispatch
# ---------------------------------------------------------------------------

def _match_name(buf: torch.Tensor, start: torch.Tensor, name: str):
    """The bytes at [start - len(name), start) are ``name``, after a
    word-splitting byte or at the start of the buffer."""
    data = name.encode()
    base = start - len(data)
    ok = base >= 0
    for q, ch in enumerate(data):
        ok = ok & (_at(buf, base + q) == ch)
    prev_split = (base == 0) | _is_any(_at(buf, base - 1), _SPLIT)
    return ok & prev_split


def _eval_list_minmax(st, key_buf, key_len, want_max, cfg) -> EvalResult:
    """min/max over the int list stored under each row's key (0 and an
    error where there is none)."""
    res = lookup(st, key_buf, key_len, cfg)
    base, cnt = res.pool_off.long(), res.pool_len.long()
    pool = st.pool_type.shape[1]
    q = torch.arange(pool, device=key_buf.device)[None, :]
    idx = (base[:, None] + q).clamp(0, pool - 1)
    et = torch.gather(st.pool_type, 1, idx)
    ev = torch.gather(st.pool_int, 1, idx).to(torch.int64)
    in_range = q < cnt[:, None]
    use = in_range & (et == T_INT)
    big = 2 ** 31
    best = torch.where(want_max, torch.where(use, ev, -big).amax(dim=1),
                       torch.where(use, ev, big).amin(dim=1))
    best = torch.where(use.any(dim=1), best, 0)
    all_int = (~in_range | (et == T_INT)).all(dim=1)
    err = torch.where(res.err != ERR_OK, res.err,
          torch.where(res.vtype != T_LIST, ERR_ASSERT,
          torch.where(~all_int, ERR_HOST,
          torch.where(cnt == 0, ERR_ASSERT, ERR_OK))))
    return EvalResult(err.to(torch.int32), best.to(torch.int32))


def _eval_enum_minmax(buf, length, want_max) -> EvalResult:
    """min/max over each row's comma-separated flat expressions, in turn
    up to the first that errs. The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if buf.device.type == "cpu":
        return eval_enum_minmax_reference(buf, length, want_max)
    return math_eval_kernel(buf, length, want_max)


def eval_enum_minmax_reference(buf, length, want_max) -> EvalResult:
    """The plain version of ``_eval_enum_minmax``, batched torch on any
    device (each segment through ``eval_flat_reference``)."""
    EVENTS.count("plain.eval_enum_minmax")
    rows, n = buf.shape
    dev = buf.device
    length = bs.col(length, rows, dev).to(torch.int64)
    start = torch.zeros(rows, dtype=torch.int64, device=dev)
    best = torch.zeros_like(start)
    err = torch.zeros_like(start)
    any_v = torch.zeros(rows, dtype=torch.bool, device=dev)
    done = torch.zeros_like(any_v)
    while True:
        go = ~done & (err == ERR_OK) & (start <= length)
        if not bool(go.any()):
            break
        nxt = bs.find(buf, length, COMMA, start).to(torch.int64)
        end = torch.where(nxt == -1, length, nxt)
        seg, seg_len = bs.substring(buf, start, end - start, n)
        r = eval_flat_reference(seg, seg_len)
        val = r.value.to(torch.int64)
        cand = torch.where(want_max, torch.maximum(best, val),
                           torch.minimum(best, val))
        err = torch.where(go & (err == ERR_OK), r.err, err)
        best = torch.where(go, torch.where(any_v, cand, val), best)
        any_v = any_v | go
        done = torch.where(go, nxt == -1, done)
        start = torch.where(go, end + 1, start)
    err = torch.where(~any_v, ERR_ASSERT, err)
    return EvalResult(err.to(torch.int32), best.to(torch.int32))


def _has_only_enum_chars(buf, length) -> torch.Tensor:
    """Each row's bytes are all of ' .0123456789+-*/%,' (an enumeration,
    not a key name)."""
    pos = bs.positions(buf.shape[1], buf.device)[None, :]
    return (_is_any(buf, _ENUM) | (pos >= length[:, None])).all(dim=1)


def on_rows(rows: torch.Tensor, fn, *args):
    """fn on the rows where ``rows`` holds, scattered back into zeros (the
    rows outside are never read)."""
    idx = host_sync(torch.nonzero, rows)[:, 0]
    n = rows.shape[0]
    dev = rows.device
    out = EvalResult(torch.zeros(n, dtype=torch.int32, device=dev),
                     torch.zeros(n, dtype=torch.int32, device=dev))
    if idx.numel() == 0:
        return out
    part = fn(*(a.index_select(0, idx) if isinstance(a, torch.Tensor)
                else a.take(idx) for a in args))
    return EvalResult(out.err.index_copy(0, idx, part.err),
                      out.value.index_copy(0, idx, part.value))


def _paren_step(st, buf, length, cfg):
    """Reduce each row's innermost paren group once (the JAX loop body);
    returns (buf', len', step error, proceeded)."""
    n = buf.shape[1]
    outer_from = bs.rfind(buf, length, LPAREN).to(torch.int64)
    inner_to = bs.find(buf, length, RPAREN, outer_from + 1).to(torch.int64)
    proceed = (outer_from != -1) & (inner_to != -1)
    inner_len = inner_to - outer_from - 1
    inner_buf, _ = bs.substring(buf, outer_from + 1, inner_len, n)

    # function-call classification by the byte before '(', with the
    # reference's negative-index quirk: at position 0 it is the last byte
    before = _at(buf, torch.where(outer_from == 0, length - 1, outer_from - 1))
    is_plain = _is_any(before, _SPLIT) | (length == 0)
    fn = torch.full_like(outer_from, _FN_NONE)
    fn_len = torch.zeros_like(outer_from)
    for code, name in _FUNCTIONS:
        ok = _match_name(buf, outer_from, name)
        fn = torch.where((fn == _FN_NONE) & ok, code, fn)
        fn_len = torch.where((fn == code) & ok & (fn_len == 0), len(name),
                             fn_len)

    plain = eval_flat(inner_buf, inner_len)
    is_enum = _has_only_enum_chars(inner_buf, inner_len)
    called = proceed & ~is_plain
    minmax = (fn == _FN_MIN) | (fn == _FN_MAX)
    want_max = fn == _FN_MAX
    enum = on_rows(called & minmax & is_enum, _eval_enum_minmax, inner_buf,
               inner_len, want_max)
    listed = on_rows(called & minmax & ~is_enum,
                 lambda s, b, ln, w: _eval_list_minmax(s, b, ln, w, cfg),
                 st, inner_buf, inner_len, want_max)

    def length_of(s, b, ln):
        res = lookup(s, b, ln, cfg)
        err = torch.where(res.err != ERR_OK, res.err,
                          torch.where(res.vtype != T_LIST, ERR_ASSERT,
                                      ERR_OK))
        return EvalResult(err.to(torch.int32), res.pool_len)

    size = on_rows(called & (fn == _FN_LENGTH), length_of, st, inner_buf,
               inner_len)

    fn_err = torch.where(fn == _FN_LENGTH, size.err,
             torch.where(minmax, torch.where(is_enum, enum.err, listed.err),
             torch.where((fn == _FN_ROUND) | (fn == _FN_SIGN), plain.err,
                         ERR_ASSERT)))
    fn_val = torch.where(fn == _FN_LENGTH, size.value,
             torch.where(minmax,
                         torch.where(is_enum, enum.value, listed.value),
             torch.where(fn == _FN_ROUND, plain.value,
             torch.where(fn == _FN_SIGN, torch.sign(plain.value), 0))))
    sub_err = torch.where(is_plain, plain.err, fn_err)
    sub_val = torch.where(is_plain, plain.value, fn_val).to(torch.int32)
    rep_from = torch.where(is_plain, outer_from, outer_from - fn_len)

    val_buf, val_len = bs.int_to_bytes(sub_val, n)
    new_buf, new_len, overflow = bs.splice(
        buf, length, rep_from, inner_to + 1, val_buf, val_len, n)
    step_err = torch.where(~proceed, ERR_OK,
               torch.where(sub_err != ERR_OK, sub_err,
               torch.where(overflow, ERR_CAPACITY, ERR_OK)))
    return new_buf, new_len.to(torch.int64), step_err, proceed


def eval_math_bytes(st, buf, length, cfg) -> EvalResult:
    """The host's ``eval_math`` on each row's already interpolated bytes:
    ``st`` is the rows' ``VMBatch`` (for ``length``, ``min`` and ``max``
    over stored lists), ``buf`` (N, MS) uint8, ``length`` (N,) int32."""
    rows = buf.shape[0]
    dev = buf.device
    length = bs.col(length, rows, dev).to(torch.int64)
    unbalanced = bs.count(buf, length, LPAREN) != bs.count(buf, length,
                                                           RPAREN)
    err = torch.where(unbalanced, ERR_ASSERT, ERR_OK).to(torch.int64)
    iters = torch.zeros_like(length)
    for _ in range(MAX_PARENS):
        has_paren = bs.find(buf, length, LPAREN, 0) != -1
        go = (err == ERR_OK) & has_paren & (iters < MAX_PARENS)
        idx = host_sync(torch.nonzero, go)[:, 0]
        if idx.numel() == 0:
            break
        new_buf, new_len, step_err, proceed = _paren_step(
            st.take(idx), buf.index_select(0, idx),
            length.index_select(0, idx), cfg)
        apply = proceed & (step_err == ERR_OK)
        buf = buf.index_copy(0, idx, torch.where(
            apply[:, None], new_buf, buf.index_select(0, idx)))
        length = length.index_copy(0, idx, torch.where(
            apply, new_len, length.index_select(0, idx)))
        err = err.index_copy(0, idx, torch.where(
            step_err != ERR_OK, step_err, err.index_select(0, idx)))
        iters = iters.index_copy(0, idx, torch.where(
            proceed, iters.index_select(0, idx) + 1, MAX_PARENS))
    capped = (err == ERR_OK) & (iters >= MAX_PARENS) & \
        (bs.find(buf, length, LPAREN, 0) != -1)
    err = torch.where(capped, ERR_HOST, err)
    final = eval_flat(buf, length)
    err = torch.where(err == ERR_OK, final.err, err)
    return EvalResult(err.to(torch.int32), final.value)
