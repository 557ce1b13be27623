"""Wildcard matching with captures, batched over rows.

The counterpart of ``interpolation_engine_tpu/ops/match_kernel.py``: ``*``
is a greedy DOTALL capture group, the pattern is anchored at both ends,
every other byte is literal, and Python's end-anchor quirk holds (``$`` also
matches just before one trailing newline). The pattern splits at its stars
into literal segments; a segment's occurrences in the subject are a window
compare, feasibility runs right to left as suffix ORs, and each capture
takes the largest feasible position (regex greediness). More than
``max_stars`` stars, or a segment longer than ``MAX_LIT`` bytes, is not
supported: the caller defers to the host.

Each row has its own subject; the pattern is either per row or one row
shared by all.

``wildcard_match`` launches ``csrc/wildcard_match.cu`` on CUDA tensors (a
block of 128 rows staged in shared memory, one thread a row; the
right-to-left feasibility pass is one integer a star, the rightmost
feasible position: ``wildcard_match_kernel``) or raises; on CPU
tensors, and only there, it runs ``wildcard_match_reference``, the plain
version described above, which works on any device so that it can be held
against the kernel on the card. A kernel launch counts as
``kernel.wildcard_match`` and a call of the plain version as
``plain.wildcard_match`` in ``EVENTS`` (``core/events.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.events import EVENTS
from ..vm import bytestr as bs

STAR = 42  # ord('*')
MAX_LIT = 32


class MatchResult(NamedTuple):
    ok: torch.Tensor         # bool: the pattern matches the subject
    supported: torch.Tensor  # bool: False defers to the host
    n_caps: torch.Tensor     # int32: number of '*' groups
    cap_off: torch.Tensor    # int32 (N, max_stars): capture spans
    cap_len: torch.Tensor    # int32 (N, max_stars)


def _segment_spans(pat, plen, max_stars: int):
    """Split each pattern row at '*': (n_stars, seg_off, seg_len,
    supported), with max_stars + 1 segments per row."""
    rows, n = pat.shape
    dev = pat.device
    S = max_stars
    pos = bs.positions(n, dev)[None, :]
    is_star = (pat == STAR) & (pos < plen[:, None])
    n_stars = is_star.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(is_star.to(torch.int32), 1) - is_star.to(torch.int32)
    K = n_stars.clamp(max=S)
    seg_off, seg_len = [], []
    prev_end = torch.zeros(rows, dtype=torch.int32, device=dev)
    for j in range(S):
        hit = is_star & (rank == j)
        sp = torch.where(hit.any(dim=1),
                         torch.where(hit, pos, n).amin(dim=1), -1)
        is_real = j < K
        end = torch.where(is_real, sp, plen)
        seg_off.append(prev_end)
        seg_len.append((end - prev_end).clamp(min=0))
        prev_end = torch.where(is_real, sp + 1, prev_end)
    seg_off.append(prev_end)
    seg_len.append((plen - prev_end).clamp(min=0))
    seg_off = torch.stack(seg_off, 1).to(torch.int32)
    seg_len = torch.stack(seg_len, 1).to(torch.int32)
    # the final segment sits at K; the entries past K repeat it
    j = torch.arange(S + 1, device=dev)[None, :]
    last = j >= K[:, None]
    seg_off = torch.where(last, prev_end[:, None], seg_off)
    seg_len = torch.where(last, (plen - prev_end).clamp(min=0)[:, None],
                          seg_len)
    supported = (n_stars <= S) & (seg_len <= MAX_LIT).all(dim=1)
    return n_stars, seg_off, seg_len, supported


def _occurrences(subj, cut, pat, seg_off, seg_len, lq: int):
    """occ[r, p]: the literal segment matches subj[r] at p (window
    compare over the first lq bytes; a segment is never longer)."""
    rows, n = subj.shape
    padded = torch.nn.functional.pad(subj, (0, MAX_LIT))
    win = padded.unfold(1, lq, 1)[:, :n, :]                   # (N, n, lq)
    pat_padded = torch.nn.functional.pad(pat, (0, MAX_LIT))
    lit = bs.window(pat_padded, seg_off.clamp(0, pat.shape[1]),
                    MAX_LIT)[:, :lq]                          # (P, lq)
    q = torch.arange(lq, device=subj.device)
    active = q[None, :] < seg_len[:, None]                    # (P, lq)
    p = torch.arange(n, device=subj.device)
    in_range = (p[None, :, None] + q[None, None, :]) < cut[:, None, None]
    eq = ((win == lit[:, None, :]) & in_range) | ~active[:, None, :]
    return eq.all(dim=2)


def _match_at_cut(subj, cut, pat, n_stars, seg_off, seg_len,
                  max_stars: int, lq: int):
    """Anchored match of the segmented pattern against subj[:cut]."""
    rows, n = subj.shape
    dev = subj.device
    S = max_stars
    pos = torch.arange(n + 1, device=dev)[None, :]
    K = n_stars.clamp(max=S)
    m0 = seg_len[:, 0]
    occ = torch.stack([
        _occurrences(subj, cut, pat, seg_off[:, j], seg_len[:, j], lq)
        for j in range(S + 1)], dim=1)                        # (N, S+1, n)
    occ = torch.nn.functional.pad(occ, (0, 1))   # position n: False
    empty = (seg_len == 0)[:, :, None]
    occ = torch.where(empty, (pos <= cut[:, None])[:, None, :], occ)
    occ = occ & ((pos[:, None, :] + seg_len[:, :, None])
                 <= cut[:, None, None])
    H = torch.zeros((rows, max(S, 1), n + 1), dtype=torch.bool, device=dev)
    T = torch.zeros((rows, n + 1), dtype=torch.bool, device=dev)
    r = torch.arange(rows, device=dev)
    for t in range(S):
        j = K - t                      # the literal after star j
        active = t < K
        jc = j.clamp(0, S).long()
        m_j = seg_len[r, jc]
        occ_j = occ[r, jc]
        if t == 0:
            rhs = (pos + m_j[:, None]) == cut[:, None]
        else:
            rhs = bs.shift_left(T.to(torch.uint8), m_j) > 0
        h = occ_j & rhs
        t_new = torch.cumsum(h.flip(1).to(torch.int32), 1).flip(1) > 0
        slot = (j - 1).clamp(0, S - 1)
        put = active[:, None] & (torch.arange(S, device=dev)[None, :]
                                 == slot[:, None])
        H = torch.where(put[:, :, None], h[:, None, :], H)
        T = torch.where(active[:, None], t_new, T)
    prefix_ok = occ[:, 0, 0]
    no_star_ok = prefix_ok & (m0 == cut)
    star_ok = prefix_ok & T[r, m0.clamp(0, n).long()]
    ok = torch.where(K == 0, no_star_ok, star_ok)

    # greedy captures: for stars 1..K the largest feasible position
    cap_off, cap_len = [], []
    cursor = m0
    for t in range(S):
        active = (t + 1) <= K
        feas = H[:, t] & (pos >= cursor[:, None])
        p = torch.where(feas.any(dim=1),
                        torch.where(feas, pos, -1).amax(dim=1), cursor)
        cap_off.append(torch.where(active, cursor, 0))
        cap_len.append(torch.where(active, p - cursor, 0))
        cursor = torch.where(active, p + seg_len[:, t + 1], cursor)
    if S:
        cap_off = torch.stack(cap_off, 1).to(torch.int32)
        cap_len = torch.stack(cap_len, 1).to(torch.int32)
    else:
        cap_off = cap_len = torch.zeros((rows, 0), dtype=torch.int32,
                                        device=dev)
    return ok, cap_off, cap_len


# The largest max_stars the kernel takes: MAX_STARS in
# csrc/wildcard_match.cu (a block's shared scratch is 2 * max_stars words a
# thread).
KERNEL_MAX_STARS = 64


def wildcard_match(pat, plen, subj, slen, max_stars: int) -> MatchResult:
    """Match each subject row against its pattern row (or against one
    pattern row shared by all). The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if subj.device.type == "cpu":
        return wildcard_match_reference(pat, plen, subj, slen, max_stars)
    return wildcard_match_kernel(pat, plen, subj, slen, max_stars)


def wildcard_match_kernel(pat, plen, subj, slen,
                          max_stars: int) -> MatchResult:
    """Launch ``csrc/wildcard_match.cu`` on CUDA rows; raises if it cannot
    launch."""
    for name, t in (("pat", pat), ("subj", subj)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name}: want uint8 2-d, got {t.dtype} "
                             f"{t.dim()}-d")
    dev = subj.device
    if dev.type != "cuda" or pat.device != dev:
        raise ValueError(f"wildcard_match_kernel needs CUDA tensors on one "
                         f"device, got {pat.device} and {dev}")
    rows, ms = subj.shape
    n_pat, pms = pat.shape
    if n_pat not in (1, rows):
        raise ValueError(f"{n_pat} pattern rows for {rows} subject rows")
    if not 0 <= max_stars <= KERNEL_MAX_STARS:
        raise ValueError(f"max_stars {max_stars} outside the kernel's "
                         f"[0, {KERNEL_MAX_STARS}]")
    plen = bs.col(plen, n_pat, dev)
    slen = bs.col(slen, rows, dev)
    for name, t, want in (("plen", plen, n_pat), ("slen", slen, rows)):
        if t.shape not in ((), (want,)) or t.device != dev:
            raise ValueError(f"{name}: want ({want},) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    pat = pat.contiguous()
    subj = subj.contiguous()
    plen = plen.expand(n_pat).contiguous()
    slen = slen.expand(rows).contiguous()
    ok = torch.empty(rows, dtype=torch.bool, device=dev)
    supported = torch.empty_like(ok)
    n_caps = torch.empty(rows, dtype=torch.int32, device=dev)
    cap_off = torch.empty((rows, max_stars), dtype=torch.int32, device=dev)
    cap_len = torch.empty_like(cap_off)
    out = MatchResult(ok, supported, n_caps, cap_off, cap_len)
    if rows == 0:
        return out
    from .build import launch
    with torch.cuda.device(dev):
        launch("wildcard_match", pat.data_ptr(), plen.data_ptr(), pms,
               int(n_pat == 1), subj.data_ptr(), slen.data_ptr(), rows, ms,
               max_stars, ok.data_ptr(), supported.data_ptr(),
               n_caps.data_ptr(), cap_off.data_ptr(), cap_len.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def wildcard_match_reference(pat, plen, subj, slen,
                             max_stars: int) -> MatchResult:
    """The plain version of ``wildcard_match``, batched torch on any
    device."""
    EVENTS.count("plain.wildcard_match")
    rows = subj.shape[0]
    dev = subj.device
    plen = bs.col(plen, pat.shape[0], dev)
    slen = bs.col(slen, rows, dev)
    n_stars, seg_off, seg_len, supported = _segment_spans(
        pat, plen, max_stars)
    # literal bytes past every segment's length never count: compare only
    # as far as the longest segment
    lq = max(1, min(MAX_LIT, int(seg_len.max()))) if seg_len.numel() else 1
    if pat.shape[0] != rows:
        n_stars, supported = (t.expand(rows) for t in (n_stars, supported))
        seg_off, seg_len, pat = (t.expand(rows, -1)
                                 for t in (seg_off, seg_len, pat))
    ok_full, cof, clf = _match_at_cut(subj, slen, pat, n_stars, seg_off,
                                      seg_len, max_stars, lq)
    n = subj.shape[1]
    last = subj[torch.arange(rows, device=dev),
                (slen - 1).clamp(0, n - 1).long()]
    has_trailing_nl = (slen > 0) & (last == 10)
    ok_trim, cot, clt = _match_at_cut(subj, slen - 1, pat, n_stars, seg_off,
                                      seg_len, max_stars, lq)
    use_trim = ~ok_full & has_trailing_nl & ok_trim
    return MatchResult(
        ok=ok_full | use_trim, supported=supported,
        n_caps=n_stars.clamp(max=max_stars).to(torch.int32),
        cap_off=torch.where(use_trim[:, None], cot, cof),
        cap_len=torch.where(use_trim[:, None], clt, clf))
