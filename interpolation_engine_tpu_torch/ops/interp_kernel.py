"""The interpolation kernel: ``{key}`` resolution as batched byte scans.

The counterpart of ``interpolation_engine_tpu/ops/interp_kernel.py``, with
the same error codes and the same tagged result. Every row carries its own
string and its own store. The general loop substitutes innermost first (the
rightmost visible ``{`` and the next ``}``), one substitution per iteration,
and calls the brace scan (``ops/brace_scan.py``: the CUDA kernel on the
card) once per iteration over the rows still substituting. The JAX loop ran
the scan twice per iteration (condition and body) on the same bytes; one
call gives the same four numbers, and it also answers the cap check after
the last iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..vm import bytestr as bs
from ..vm.state import T_INT, T_LIST, T_STR, find_slot, gather_slot
from ..vm.syncs import host_sync
from . import brace_scan as scan_mod

ERR_OK = 0
ERR_MISSING = 1     # InterpolationException semantics
ERR_ASSERT = 2      # reference AssertionError semantics
ERR_CAPACITY = 3    # device buffer overflow: host rescue
ERR_HOST = 4        # behavior the device defers to the host


class InterpResult(NamedTuple):
    err: torch.Tensor       # int32, one of ERR_*
    vtype: torch.Tensor     # int32 (T_INT/T_STR/T_LIST)
    vint: torch.Tensor      # int32
    buf: torch.Tensor       # uint8 (N, max_str): string payload
    length: torch.Tensor    # int32
    pool_off: torch.Tensor  # int32: list span when vtype == T_LIST
    pool_len: torch.Tensor  # int32


def _where(c, a, b):
    return torch.where(c, a, b).to(torch.int32)


def simple_key_span(buf, length) -> torch.Tensor:
    """True where buf[:length] is exactly one balanced, escape-aware
    ``{...}`` group longer than ``{}``."""
    n = buf.shape[1]
    length = bs.col(length, buf.shape[0], buf.device)
    pos = bs.positions(n, buf.device)[None, :]
    hidden = bs.escape_hidden_mask(buf, length)
    live = pos < length[:, None]
    opens = ((buf == bs.BRACE_OPEN) & ~hidden & live).to(torch.int32)
    closes = ((buf == bs.BRACE_CLOSE) & ~hidden & live).to(torch.int32)
    # reference order per char: depth -= close; check; depth += open
    depth_before = torch.cumsum(opens, 1) - opens \
        - (torch.cumsum(closes, 1) - closes)
    depth_at_check = depth_before - closes
    is_end = (pos == 0) | (pos == length[:, None] - 1)
    ok_at = (depth_at_check == 0) == is_end
    return (ok_at | ~live).all(dim=1) & (length > 2)


def _const_eq(key_buf, key_len, s: str) -> torch.Tensor:
    data = s.encode()
    n = key_buf.shape[1]
    if len(data) > n:
        return torch.zeros(key_buf.shape[0], dtype=torch.bool,
                           device=key_buf.device)
    target = torch.zeros(n, dtype=torch.uint8, device=key_buf.device)
    target[:len(data)] = host_sync(torch.tensor, list(data),
                                   dtype=torch.uint8, device=target.device)
    return bs.equal(key_buf, key_len, target, len(data))


def lookup(st, key_buf, key_len, cfg) -> InterpResult:
    """get_interpdata on each row's store."""
    key_len = bs.col(key_len, st.n, key_buf.device)
    is_special_time = _const_eq(key_buf, key_len, "HH:MM") \
        | _const_eq(key_buf, key_len, "HH:MM:SS")
    is_empty = key_len == 0
    found, slot, collide = find_slot(st, key_buf, key_len)
    vtype = gather_slot(st.vtype, slot)
    vint = gather_slot(st.vint, slot)
    voff = gather_slot(st.voff, slot)
    vlen = gather_slot(st.vlen, slot)
    str_buf = bs.normalize(bs.window(st.arena, voff, cfg.max_str), vlen)
    # a stored string longer than the working buffer cannot be
    # materialized without truncation: capacity park
    str_over = found & (vtype == T_STR) & (vlen > cfg.max_str)
    err = torch.where(
        is_special_time, ERR_HOST,
        torch.where(collide, ERR_HOST,
                    torch.where(is_empty | ~found, ERR_MISSING,
                                torch.where(str_over, ERR_CAPACITY, ERR_OK))))
    is_str = vtype == T_STR
    is_list = vtype == T_LIST
    return InterpResult(
        err=err.to(torch.int32),
        vtype=_where(found, vtype, T_STR),
        vint=vint,
        buf=torch.where(is_str[:, None], str_buf, 0).to(torch.uint8),
        length=_where(is_str, vlen, 0),
        pool_off=_where(is_list, voff, 0),
        pool_len=_where(is_list, vlen, 0))


def value_to_bytes(res: InterpResult, max_str: int):
    """str(value) for int/str results; a list defers to the host (Python
    repr). Returns (buf, len, err)."""
    int_buf, int_len = bs.int_to_bytes(res.vint, max_str)
    is_int = res.vtype == T_INT
    buf = torch.where(is_int[:, None], int_buf, res.buf)
    length = _where(is_int, int_len, res.length)
    err = _where(res.vtype == T_LIST, ERR_HOST, res.err)
    return buf, length, err


def general_interpolate(st, buf, length, cfg):
    """The innermost-first substitution loop on working buffers; returns
    (buf', len', err). Input bytes are raw program text; escaped braces stay
    escaped in the output."""
    n = cfg.max_str
    rows = buf.shape[0]
    dev = buf.device
    buf = buf.contiguous().clone()
    length = bs.col(length, rows, dev).clone()
    err = torch.zeros(rows, dtype=torch.int32, device=dev)
    live = torch.arange(rows, device=dev)   # the rows still substituting
    for it in range(cfg.max_subst + 1):
        if live.numel() == 0:
            break
        b, ln = buf.index_select(0, live), length.index_select(0, live)
        n_open, n_close, outer, inner = scan_mod.brace_scan(b, ln).unbind(1)
        sel = host_sync(torch.nonzero, n_open > 0)[:, 0]
        rows_i = live.index_select(0, sel)
        if it == cfg.max_subst:
            # the iteration cap with braces left: defer to the host
            err.index_fill_(0, rows_i, ERR_HOST)
            break
        if rows_i.numel() == 0:
            break
        b, ln = b.index_select(0, sel), ln.index_select(0, sel)
        n_open, n_close, outer, inner = (
            t.index_select(0, sel) for t in (n_open, n_close, outer, inner))
        sub = st.take(rows_i)
        balanced = n_open == n_close
        # no '}' after the last '{' (with balanced counts): the reference
        # breaks out of its loop and returns the text as it stands
        break_out = balanced & ((outer == -1) | (inner == -1))
        key_len = inner - outer - 1
        key_buf, _ = bs.substring(b, outer + 1, key_len, n)
        res = lookup(sub, key_buf, key_len, cfg)
        val_buf, val_len, verr = value_to_bytes(res, n)
        new_buf, new_len, overflow = bs.splice(
            b, ln, outer, inner + 1, val_buf, val_len, n)
        step_err = torch.where(
            ~balanced, ERR_ASSERT,
            torch.where(break_out, ERR_OK,
                        torch.where(res.err != ERR_OK, res.err,
                                    torch.where(verr != ERR_OK, verr,
                                                torch.where(overflow,
                                                            ERR_CAPACITY,
                                                            ERR_OK)))))
        apply = (step_err == ERR_OK) & ~break_out
        new_b = torch.where(apply[:, None], new_buf, b)
        buf.index_copy_(0, rows_i, new_b)
        length.index_copy_(0, rows_i, _where(apply, new_len, ln))
        # a live row's err is still OK: a row leaves at its first error
        err.index_copy_(0, rows_i, step_err.to(torch.int32))
        live = rows_i.index_select(0, host_sync(torch.nonzero,
                                                apply)[:, 0])
    return buf, length, err


def _interpolate_impl(st, buf, length, cfg) -> InterpResult:
    """Full interpolate_inserts: the typed simple-key path and the general
    loop, with one level of ``{{k}}`` indirection."""
    n = cfg.max_str
    rows = buf.shape[0]
    length = bs.col(length, rows, buf.device)
    is_simple = simple_key_span(buf, length)
    inner_buf, inner_len = bs.substring(buf, 1, length - 2, n)
    inner_simple = simple_key_span(inner_buf, inner_len)
    inner2_buf, inner2_len = bs.substring(inner_buf, 1, inner_len - 2, n)
    inner2_simple = simple_key_span(inner2_buf, inner2_len)

    use_inner2 = is_simple & inner_simple
    use_inner = is_simple & ~inner_simple
    gen_buf = torch.where(use_inner2[:, None], inner2_buf,
                          torch.where(use_inner[:, None], inner_buf, buf))
    gen_len = _where(use_inner2, inner2_len,
                     _where(use_inner, inner_len, length))
    g_buf, g_len, g_err = general_interpolate(st, gen_buf, gen_len, cfg)

    # {{k}}: resolve k, then use its string value as the outer key; a
    # non-string intermediate raises in the reference (int: missing key,
    # list: TypeError); deeper nesting defers to the host
    indirect = lookup(st, g_buf, g_len, cfg)
    ind_err = torch.where(
        indirect.err != ERR_OK, indirect.err,
        torch.where(indirect.vtype == T_INT, ERR_MISSING,
                    torch.where(indirect.vtype == T_LIST, ERR_ASSERT,
                                ERR_OK)))
    ind_err = _where(inner2_simple, ERR_HOST, ind_err)
    key_buf = torch.where(use_inner2[:, None], indirect.buf, g_buf)
    key_len = _where(use_inner2, indirect.length, g_len)
    key_err = _where(use_inner2, ind_err, ERR_OK)
    key_err = _where(g_err != ERR_OK, g_err, key_err)

    simple_res = lookup(st, key_buf, key_len, cfg)
    simple_res = simple_res._replace(
        err=_where(key_err != ERR_OK, key_err, simple_res.err))
    zero = torch.zeros_like(g_len)
    general_res = InterpResult(g_err, torch.full_like(g_len, T_STR), zero,
                               g_buf, g_len, zero, zero)
    return InterpResult(*[
        torch.where(is_simple[:, None] if a.dim() == 2 else is_simple, a, b)
        for a, b in zip(simple_res, general_res)])


def interpolate(st, buf, length, cfg) -> InterpResult:
    """interpolate_inserts on each row. A logical length beyond the working
    buffer means the template was cut on load: a capacity park, never
    silent nulls."""
    length = bs.col(length, buf.shape[0], buf.device)
    res = _interpolate_impl(st, buf, length, cfg)
    return res._replace(err=_where(length > cfg.max_str, ERR_CAPACITY,
                                   res.err))
