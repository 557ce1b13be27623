"""Fixed-width byte strings, batched over rows.

The counterpart of the JAX package's ``vm/bytestr.py``. A string is a row
of a ``(N, n)`` uint8 tensor plus an ``(N,)`` int32 length; bytes past the
length are zero (normalized), so equality is one row compare. Offsets and
lengths are per row. Every helper reproduces the JAX one's result, clamps
included: ``lax.dynamic_slice`` clamps its start so the window fits, and a
JAX gather clamps its indices, where torch indexing raises or wraps, so each
such site clamps explicitly.
"""

from __future__ import annotations

import torch

from .syncs import host_sync

BRACE_OPEN = 123   # ord('{')
BRACE_CLOSE = 125  # ord('}')
BACKSLASH = 92     # ord('\\')

M32 = 0xFFFFFFFF


def positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def col(x, n: int, device) -> torch.Tensor:
    """A per-row int32 column from a tensor or a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full((n,), int(x), dtype=torch.int32, device=device)


def normalize(buf: torch.Tensor, length) -> torch.Tensor:
    """Zero bytes at and past ``length``."""
    n = buf.shape[1]
    length = col(length, buf.shape[0], buf.device)
    keep = positions(n, buf.device)[None, :] < length[:, None]
    return torch.where(keep, buf, torch.zeros((), dtype=torch.uint8,
                                              device=buf.device))


def fit(buf: torch.Tensor, n: int) -> torch.Tensor:
    m = buf.shape[1]
    if m == n:
        return buf
    if m > n:
        return buf[:, :n].contiguous()
    return torch.nn.functional.pad(buf, (0, n - m))


def _take(buf: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    """buf[r, idx[r, p]] where valid, else 0."""
    g = torch.gather(buf, 1, idx.clamp(0, buf.shape[1] - 1).long())
    return torch.where(valid, g, torch.zeros((), dtype=buf.dtype,
                                             device=buf.device))


def shift_right(buf: torch.Tensor, k) -> torch.Tensor:
    """Logical shift right by k (clamped to [0, n]); vacated bytes are 0."""
    n = buf.shape[1]
    k = col(k, buf.shape[0], buf.device).clamp(0, n)
    idx = positions(n, buf.device)[None, :] - k[:, None]
    return _take(buf, idx, idx >= 0)


def shift_left(buf: torch.Tensor, k) -> torch.Tensor:
    """Logical shift left by k (clamped to [0, n]); vacated bytes are 0."""
    n = buf.shape[1]
    k = col(k, buf.shape[0], buf.device).clamp(0, n)
    idx = positions(n, buf.device)[None, :] + k[:, None]
    return _take(buf, idx, idx < n)


def shift_any(buf: torch.Tensor, k) -> torch.Tensor:
    """Shift by k (clamped to [-n, n]; positive is right)."""
    n = buf.shape[1]
    k = col(k, buf.shape[0], buf.device).clamp(-n, n)
    idx = positions(n, buf.device)[None, :] - k[:, None]
    return _take(buf, idx, (idx >= 0) & (idx < n))


def from_table(table: torch.Tensor, off, length, size: int):
    """``size`` bytes at per-row ``off`` of a flat table, normalized to
    ``length``. The table is padded by ``size`` and the offset clamped so
    the window fits, as ``lax.dynamic_slice`` does."""
    n = off.shape[0] if isinstance(off, torch.Tensor) else length.shape[0]
    dev = table.device
    off = col(off, n, dev).clamp(0, table.shape[0])
    padded = torch.nn.functional.pad(table, (0, size))
    idx = off[:, None].long() + torch.arange(size, device=dev)[None, :]
    length = col(length, n, dev)
    return normalize(padded[idx], length), length


def window(buf: torch.Tensor, off, size: int) -> torch.Tensor:
    """``buf[r, off[r]:off[r]+size]`` with the start clamped to
    ``[0, width - size]``: the JAX package's clip before each
    ``lax.dynamic_slice`` (which would wrap a negative start)."""
    n, w = buf.shape
    off = col(off, n, buf.device).clamp(0, w - size)
    idx = off[:, None].long() + torch.arange(size, device=buf.device)[None, :]
    return torch.gather(buf, 1, idx)


def write_span(dst: torch.Tensor, off, src: torch.Tensor, length,
               enable=None) -> torch.Tensor:
    """A copy of ``dst`` with ``src[r, :length[r]]`` written at ``off[r]``
    where ``enable``; positions outside ``dst`` and source bytes past
    ``src``'s width are dropped (every caller discards such a write)."""
    n, w = dst.shape
    m = src.shape[1]
    dev = dst.device
    off = col(off, n, dev)
    length = col(length, n, dev)
    j = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    pos = off[:, None] + j
    mask = (j < length[:, None]) & (pos >= 0) & (pos < w)
    if enable is not None:
        mask &= enable[:, None]
    ext = torch.nn.functional.pad(dst, (0, 1))
    ext.scatter_(1, torch.where(mask, pos, w).long(), src)
    return ext[:, :w].contiguous()


def equal(a_buf, a_len, b_buf, b_len) -> torch.Tensor:
    """Rows equal as normalized strings; ``b_buf`` may be one ``(n,)`` row
    shared by all."""
    return (a_len == b_len) & (a_buf == b_buf).all(dim=1)


def concat(a_buf, a_len, b_buf, b_len, out_size: int):
    """a + b into out_size bytes; returns (buf, len, overflow)."""
    n = out_size
    dev = a_buf.device
    rows = a_buf.shape[0]
    a_len = col(a_len, rows, dev)
    b_len = col(b_len, rows, dev)
    pos = positions(n, dev)[None, :]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    a_part = torch.where(pos < a_len[:, None], fit(a_buf, n), zero)
    b_shift = shift_right(fit(b_buf, n), a_len)
    out = torch.where((pos >= a_len[:, None])
                      & (pos < (a_len + b_len)[:, None]), b_shift, a_part)
    total = a_len + b_len
    return out, total.clamp(max=n), total > n


def substring(buf, start, length, out_size: int):
    """buf[start:start+length] into a fresh out_size buffer."""
    shifted = shift_left(fit(buf, max(buf.shape[1], out_size)), start)
    length = col(length, buf.shape[0], buf.device)
    return normalize(fit(shifted, out_size), length), length


def splice(buf, length, start, end, rep_buf, rep_len, out_size: int):
    """buf[:start] + rep + buf[end:] -> (buf', len', overflow)."""
    n = out_size
    dev = buf.device
    rows = buf.shape[0]
    length, start, end, rep_len = (col(x, rows, dev) for x in
                                   (length, start, end, rep_len))
    pos = positions(n, dev)[None, :]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    head = torch.where(pos < start[:, None], fit(buf, n), zero)
    mid = shift_right(fit(rep_buf, n), start)
    mid = torch.where((pos >= start[:, None])
                      & (pos < (start + rep_len)[:, None]), mid, zero)
    tail_shift = start + rep_len - end
    tail = shift_any(fit(buf, n), tail_shift)
    tail_src = pos - tail_shift[:, None]
    tail_valid = (pos >= (start + rep_len)[:, None]) \
        & (tail_src < length[:, None]) & (tail_src >= 0)
    tail = torch.where(tail_valid, tail, zero)
    new_len = start + rep_len + (length - end)
    out = head | mid | tail
    clipped = new_len.clamp(max=n)
    return normalize(out, clipped), clipped, new_len > n


def escape_hidden_mask(buf, length) -> torch.Tensor:
    """True at braces hidden by a preceding backslash (the reference's
    sentinel swap of ``\\{``/``\\}``), within ``[0, length)``."""
    n = buf.shape[1]
    length = col(length, buf.shape[0], buf.device)
    prev = torch.nn.functional.pad(buf[:, :-1], (1, 0))
    is_brace = (buf == BRACE_OPEN) | (buf == BRACE_CLOSE)
    pos = positions(n, buf.device)[None, :]
    return is_brace & (prev == BACKSLASH) & (pos < length[:, None])


def _hits(buf, length, byte, hidden_mask):
    n = buf.shape[1]
    length = col(length, buf.shape[0], buf.device)
    pos = positions(n, buf.device)[None, :]
    hit = (buf == byte) & (pos < length[:, None])
    if hidden_mask is not None:
        hit &= ~hidden_mask
    return hit, pos


def find(buf, length, byte, start, hidden_mask=None) -> torch.Tensor:
    """Lowest index >= start of ``byte`` within [0, length), else -1."""
    hit, pos = _hits(buf, length, byte, hidden_mask)
    start = col(start, buf.shape[0], buf.device)
    hit &= pos >= start[:, None]
    first = torch.where(hit, pos, buf.shape[1]).amin(dim=1)
    return torch.where(hit.any(dim=1), first, -1).to(torch.int32)


def rfind(buf, length, byte, hidden_mask=None) -> torch.Tensor:
    """Highest index of ``byte`` within [0, length), else -1."""
    hit, pos = _hits(buf, length, byte, hidden_mask)
    return torch.where(hit, pos, -1).amax(dim=1).to(torch.int32)


def count(buf, length, byte, hidden_mask=None) -> torch.Tensor:
    hit, _ = _hits(buf, length, byte, hidden_mask)
    return hit.sum(dim=1, dtype=torch.int32)


_POW10_DESC = [10 ** (10 - k) for k in range(11)]


def int_to_bytes(value, out_size: int):
    """Decimal text of each int32 (Python ``str(int)``); returns (buf,
    len)."""
    dev = value.device
    v = value.to(torch.int64)
    neg = v < 0
    mag = v.abs()   # int64: INT32_MIN has a magnitude
    pw = host_sync(torch.tensor, _POW10_DESC, dtype=torch.int64, device=dev)
    digits = (mag[:, None] // pw[None, :]) % 10                  # (N, 11)
    nz = digits != 0
    leading = torch.where(nz, torch.arange(11, device=dev)[None, :],
                          11).amin(dim=1)
    n_digits = torch.where(nz.any(dim=1), 11 - leading, 1)
    sign = neg.to(torch.int64)
    start = 11 - n_digits
    q = torch.arange(out_size, device=dev)[None, :]
    src = (start - sign)[:, None] + q
    in_digits = (q >= sign[:, None]) & (q < (sign + n_digits)[:, None])
    d = torch.gather(digits, 1, src.clamp(0, 10)) + 48
    out = torch.where(in_digits, d, 0)
    out = torch.where((q == 0) & neg[:, None], 45, out)
    return out.to(torch.uint8), (n_digits + sign).to(torch.int32)


def _pow10_mod32(n: int, device) -> torch.Tensor:
    p, out = 1, []
    for _ in range(n):
        out.append(p)
        p = (p * 10) & M32
    return host_sync(torch.tensor, out, dtype=torch.int64, device=device)


def bytes_to_int(buf, length):
    """Parse an optionally signed decimal int; returns (int32 value, ok).
    The value is the JAX package's uint32 Horner sum, wrapped to int32."""
    n = buf.shape[1]
    dev = buf.device
    length = col(length, buf.shape[0], dev)
    pos = positions(n, dev)[None, :]
    b0 = buf[:, 0]
    has_sign = (length > 0) & ((b0 == 45) | (b0 == 43))
    neg = (b0 == 45) & has_sign
    start = has_sign.to(torch.int32)
    in_range = (pos >= start[:, None]) & (pos < length[:, None])
    is_digit = (buf >= 48) & (buf <= 57)
    ok = (length > start) & (~in_range | is_digit).all(dim=1)
    # acc = sum of d_i * 10^(L-1-i) over [start, L), L = min(length, n),
    # all mod 2^32; d_i is (byte - 48) as a uint32
    last = length.clamp(max=n).to(torch.int64) - 1
    expo = (last[:, None] - pos).clamp(0, n - 1)
    p10 = _pow10_mod32(n, dev)[expo]
    d = (buf.to(torch.int64) - 48) & M32
    term = (d * (p10 & 0xFFFF) + (((d * (p10 >> 16)) & 0xFFFF) << 16)) & M32
    value = torch.where(in_range, term, 0).sum(dim=1) & M32
    value = torch.where(neg, (-value) & M32, value)
    return to_i32(value), ok


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to int32 two's complement."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def unescape_braces(buf, length):
    """Drop each backslash directly followed by a brace (print-time
    unescaping, ``str.replace`` left to right); returns (buf, len)."""
    n = buf.shape[1]
    dev = buf.device
    length = col(length, buf.shape[0], dev)
    nxt = torch.nn.functional.pad(buf[:, 1:], (0, 1))
    pos = positions(n, dev)[None, :]
    in_len = pos < length[:, None]
    drop = (buf == BACKSLASH) & ((nxt == BRACE_OPEN)
                                 | (nxt == BRACE_CLOSE)) & in_len
    keep = ~drop & in_len
    kept_cum = torch.cumsum(keep.to(torch.int32), dim=1)
    new_len = kept_cum[:, -1].to(torch.int32)
    dst = torch.where(keep, kept_cum - 1, n).long()
    out = torch.zeros((buf.shape[0], n + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, dst, buf)
    return out[:, :n].contiguous(), new_len


def escape_braces(buf, length, out_size: int):
    """Insert a backslash before every brace (user_input storage); returns
    (buf, len, overflow)."""
    n = buf.shape[1]
    dev = buf.device
    length = col(length, buf.shape[0], dev)
    pos = positions(n, dev)[None, :]
    is_brace = ((buf == BRACE_OPEN) | (buf == BRACE_CLOSE)) \
        & (pos < length[:, None])
    ib = is_brace.to(torch.int32)
    f = pos + torch.cumsum(ib, dim=1)       # final position of each byte
    live = pos < length[:, None]
    out = torch.zeros((buf.shape[0], out_size + 1), dtype=torch.uint8,
                      device=dev)
    out.scatter_(1, torch.where(live & (f < out_size), f, out_size).long(),
                 buf)
    esc = is_brace & (f - 1 < out_size)
    out.scatter_(1, torch.where(esc, f - 1, out_size).long(),
                 torch.full_like(buf, BACKSLASH))
    new_len = length + ib.sum(dim=1, dtype=torch.int32)
    clipped = new_len.clamp(max=out_size)
    return normalize(out[:, :out_size].contiguous(), clipped), clipped, \
        new_len > out_size
