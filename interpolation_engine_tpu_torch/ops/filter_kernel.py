"""The chat stream filter: the CUDA kernel's wrapper and its plain version.

The host filters (``core/filters.py``, the exact oracle) run a per-chunk
hold-back state machine so that delimiters split across SSE chunks are
recognized. Their final result at token granularity (one character a call)
is what this module computes for a whole stream at once: the outputs table
of ``OutputFilter`` and the visual text of ``hide(extract(delta))``, as
``chat/service.py`` composes them.

``filter_chat_text(bufs, lengths, ...)`` filters a batch of streams, rows of
``bufs`` (B, L) uint8 with ``lengths`` (B,) int32: on CUDA tensors it
launches ``csrc/chat_filter.cu`` (built by ``ops/build.py``; a block a
stream, in tiles) or raises; on CPU
tensors, and only there, it runs
``filter_chat_reference``, a loop over byte positions vectorized over the
batch, which works on any device so that it can be held against the kernel
on the card. The two agree byte for byte. They replace the JAX package's
``filter_chat_text`` (``interpolation_engine_tpu/ops/filter_kernel.py``,
XLA under ``vmap``) and give the same values: ``visual`` is ``W = L +
MAX_SPANS * _MARK`` bytes wide, which holds every stream (the JAX call
site passes ``out_size = 2 L + 256``; past the visual length both are 0).

``filter_chat_host`` is the chat service's call for one stream
(``IE_TPU_DEVICE_FILTERS=1``). A stream that opens more than ``MAX_SPANS``
spans returns the exact host oracle, as in the JAX package: the kernel ran
and reported ``raw_n_spans``, but its table holds 16 spans.

Counts, in ``EVENTS`` (``core/events.py``): ``kernel.chat_filter`` (kernel
launches), ``plain.chat_filter`` (plain version calls) and
``host.chat_filter`` (the host oracle's calls from ``filter_chat_host``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.events import EVENTS

MAX_SPANS = 16      # outputs per chat call (n_outputs is small in practice)
_MARK = 16          # max bytes of one enumeration marker ("\n\n12. ")
TABLE = 2 * MAX_SPANS + 3   # span_off, span_len, n_spans, raw_n_spans,
#                             visual_len: int32 a stream


def visual_width(L: int) -> int:
    """Bytes of ``visual`` for streams of L bytes: the extracted bytes and
    the markers of MAX_SPANS spans (85 bytes) fit."""
    return L + MAX_SPANS * _MARK


@functools.lru_cache(maxsize=None)
def _enum_markers():
    """marker bytes for span k (0-based): '1. ', '\\n\\n2. ', ... padded
    (core/filters.py:63 — no leading newlines on the first)."""
    out = np.zeros((MAX_SPANS, _MARK), np.uint8)
    lens = np.zeros((MAX_SPANS,), np.int32)
    for k in range(MAX_SPANS):
        s = ("" if k == 0 else "\n\n") + f"{k + 1}. "
        data = s.encode()
        out[k, :len(data)] = list(data)
        lens[k] = len(data)
    return out, lens


def _check(bufs: torch.Tensor, lengths: torch.Tensor) -> None:
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs: want uint8 2-d, got {bufs.dtype} "
                         f"{bufs.dim()}-d")
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise ValueError(f"lengths: want int32 1-d, got {lengths.dtype} "
                         f"{lengths.dim()}-d")
    if lengths.shape[0] != bufs.shape[0]:
        raise ValueError(f"{bufs.shape[0]} rows but {lengths.shape[0]} "
                         f"lengths")
    if lengths.device != bufs.device:
        raise ValueError(f"bufs on {bufs.device}, lengths on "
                         f"{lengths.device}")
    if not (bufs.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("bufs and lengths must be contiguous")


def _as_bytes(d) -> bytes:
    return d.encode() if isinstance(d, str) else bytes(d)


@functools.lru_cache(maxsize=64)
def _delim_blob(device: torch.device, delims: bytes) -> torch.Tensor:
    """The four delimiters back to back on ``device``, uploaded once per
    delimiter set (a pageable upload inside a queued run could stall the
    host)."""
    data = np.frombuffer(delims or b"\0", np.uint8).copy()
    return torch.from_numpy(data).to(device)


@functools.cache
def _library():
    """The built kernels, once their table layout is checked against
    MAX_SPANS and TABLE here."""
    import ctypes
    from .build import load
    lib = load()
    layout = (ctypes.c_int * 3)()   # MAX_SPANS, TABLE, the tile
    lib.chat_filter_layout(layout)
    if (layout[0], layout[1]) != (MAX_SPANS, TABLE):
        raise RuntimeError(f"chat_filter.cu has MAX_SPANS, TABLE = "
                           f"{layout[0], layout[1]}, the wrapper "
                           f"{MAX_SPANS, TABLE}")
    return lib


def kernel_attributes(device) -> dict:
    """The compiled filter kernel's attributes on CUDA ``device``
    (``cudaFuncGetAttributes``): registers and local (stack) bytes a
    thread, static shared bytes and threads a block, and the tile (bytes of
    a stream staged at a time)."""
    import ctypes
    from .build import call
    lib = _library()
    layout = (ctypes.c_int * 3)()
    lib.chat_filter_layout(layout)
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        call("chat_filter_attributes", vals)
    return dict(zip(("registers", "local_bytes", "static_shared_bytes",
                     "threads", "tile"), (*vals, layout[2])))


def filter_chat_text(bufs, lengths, *, start, stop, hide_start, hide_stop,
                     enumerate_outputs: bool) -> dict:
    """Whole-stream filter of every row; the JAX ``filter_chat_text`` under
    ``vmap``. Returns a dict of tensors on the rows' device:

    * ``extracted`` (B, L) / ``span_off``, ``span_len`` (B, MAX_SPANS) /
      ``n_spans``, ``raw_n_spans`` (B,): the outputs table (span bytes index
      into ``extracted``; ``raw_n_spans`` before the clip to MAX_SPANS);
    * ``visual`` (B, ``visual_width(L)``) / ``visual_len`` (B,): the screen
      text after the enumeration markers and the hide filter.

    The rows' device decides what runs. Delimiters are bytes or str of any
    length."""
    _check(bufs, lengths)
    kw = dict(start=_as_bytes(start), stop=_as_bytes(stop),
              hide_start=_as_bytes(hide_start),
              hide_stop=_as_bytes(hide_stop),
              enumerate_outputs=bool(enumerate_outputs))
    if bufs.device.type == "cpu":
        return filter_chat_reference(bufs, lengths, **kw)
    if bufs.device.type != "cuda":
        raise ValueError(f"no chat filter for device {bufs.device}")
    from .build import launch
    _library()
    B, L = bufs.shape
    W = visual_width(L)
    dev = bufs.device
    ext = torch.empty((B, L), dtype=torch.uint8, device=dev)
    vis = torch.empty((B, W), dtype=torch.uint8, device=dev)
    table = torch.empty((B, TABLE), dtype=torch.int32, device=dev)
    d = (kw["start"], kw["stop"], kw["hide_start"], kw["hide_stop"])
    blob = _delim_blob(dev, b"".join(d))
    with torch.cuda.device(dev):
        launch("chat_filter", bufs.data_ptr(), lengths.data_ptr(), B, L, W,
               blob.data_ptr(), *map(len, d), int(kw["enumerate_outputs"]),
               ext.data_ptr(), vis.data_ptr(), table.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    return _unpack(ext, vis, table)


def _unpack(ext, vis, table) -> dict:
    S = MAX_SPANS
    return {"visual": vis, "visual_len": table[:, 2 * S + 2],
            "extracted": ext, "span_off": table[:, :S],
            "span_len": table[:, S:2 * S], "n_spans": table[:, 2 * S],
            "raw_n_spans": table[:, 2 * S + 1]}


# ---- the plain version --------------------------------------------------------

def _match_mask(buf, length, pattern: bytes):
    """mask[b, i] = pattern occurs at byte i of row b, entirely within
    length[b]."""
    B, L = buf.shape
    P = len(pattern)
    if P == 0 or P > L:
        return torch.zeros((B, L), dtype=torch.bool, device=buf.device)
    m = torch.ones((B, L), dtype=torch.bool, device=buf.device)
    for j, b in enumerate(pattern):
        shifted = torch.nn.functional.pad(buf[:, j:], (0, j)) if j else buf
        m &= shifted == b
    pos = torch.arange(L, device=buf.device)
    return m & (pos[None, :] + P <= length[:, None])


def _scan(first_mask, second_mask, first_len: int, second_len: int,
          shown0: bool, steps: int, with_span: bool = False):
    """The alternating state machine over byte positions, a column of the
    batch at a time: ``first`` toggles from the initial state, ``second``
    back (extract: start, stop from hidden; hide: hide_start, hide_stop
    from shown). A matched delimiter consumes its own bytes (the skip
    countdown). Returns kept, consumed (and span_id) per byte, and the
    state and span count at the end."""
    B, L = first_mask.shape
    dev = first_mask.device
    kept = torch.zeros((B, L), dtype=torch.bool, device=dev)
    consumed = torch.zeros((B, L), dtype=torch.bool, device=dev)
    span_id = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    toggled = torch.zeros((B,), dtype=torch.bool, device=dev)  # != initial
    skip = torch.zeros((B,), dtype=torch.int32, device=dev)
    span = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(steps):
        free = skip == 0
        hit1 = ~toggled & first_mask[:, i] & free
        hit2 = toggled & second_mask[:, i] & free
        toggled = (toggled | hit1) & ~hit2
        skip = torch.where(hit1, first_len, torch.where(hit2, second_len,
                                                        skip))
        shown = toggled if not shown0 else ~toggled
        kept[:, i] = shown & (skip == 0)
        consumed[:, i] = skip > 0
        if with_span:
            span += hit1.to(torch.int32)
            span_id[:, i] = span - 1
        skip = (skip - 1).clamp_(min=0)
    shown_end = toggled if not shown0 else ~toggled
    return kept, consumed, span_id, shown_end, span


def _holdback_mask(buf, length, consumed, pending: bytes, active):
    """The trailing bytes the host still holds at the end: the longest
    suffix, with no consumed byte, that is a PROPER prefix of ``pending``;
    only where ``active`` (the filter shown at the end)."""
    B, L = buf.shape
    dev = buf.device
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(1, min(len(pending), L + 1)):
        ok = length >= s
        for j in range(s):
            idx = (length - s + j).clamp(0, L - 1).long()[:, None]
            ok = ok & (buf.gather(1, idx)[:, 0] == pending[j]) \
                & ~consumed.gather(1, idx)[:, 0]
        best = torch.where(ok, s, best)
    pos = torch.arange(L, device=dev)[None, :]
    return active[:, None] & (pos >= (length - best)[:, None]) \
        & (pos < length[:, None])


def _compact(buf, keep, out_size: int):
    """Stable-gather kept bytes to the front: (out (B, out_size), n).
    Dropped bytes go to a dump column past the output."""
    B = buf.shape[0]
    n = keep.sum(dim=1, dtype=torch.int32)
    dest = keep.to(torch.int64).cumsum(dim=1) - 1
    dest = torch.where(keep, dest.clamp(0, out_size - 1), out_size)
    out = torch.zeros((B, out_size + 1), dtype=buf.dtype, device=buf.device)
    out.scatter_(1, dest, buf)
    return out[:, :out_size].contiguous(), n.clamp(max=out_size)


def filter_chat_reference(bufs, lengths, *, start: bytes, stop: bytes,
                          hide_start: bytes, hide_stop: bytes,
                          enumerate_outputs: bool) -> dict:
    """The plain version of the kernel, batched torch on any device: JAX's
    two passes, each scan a loop over byte positions (to the longest row)
    vectorized over the rows."""
    EVENTS.count("plain.chat_filter")
    start, stop = _as_bytes(start), _as_bytes(stop)
    hide_start, hide_stop = _as_bytes(hide_start), _as_bytes(hide_stop)
    B, L = bufs.shape
    W = visual_width(L)
    dev = bufs.device
    length = lengths.clamp(0, L)
    pos = torch.arange(L, device=dev)[None, :]
    in_range = pos < length[:, None]
    passthrough = not start or not stop
    span_off = torch.zeros((B, MAX_SPANS), dtype=torch.int32, device=dev)
    span_len = torch.zeros((B, MAX_SPANS), dtype=torch.int32, device=dev)
    steps = int(length.max()) if B else 0

    if passthrough:
        ext = torch.where(in_range, bufs, 0)
        ext_len = length
        span_len[:, 0] = length
        n_spans = (length > 0).to(torch.int32)
        raw_n_spans = n_spans
    else:
        start_m = _match_mask(bufs, length, start) & in_range
        stop_m = _match_mask(bufs, length, stop) & in_range
        kept, consumed, span_id, shown_end, spans = _scan(
            start_m, stop_m, len(start), len(stop), False, steps, True)
        kept &= in_range & ~_holdback_mask(bufs, length, consumed, stop,
                                           shown_end)
        raw_n_spans = spans
        n_spans = spans.clamp(max=MAX_SPANS)
        ext, ext_len = _compact(bufs, kept, L)
        counted = torch.where(kept & (span_id < MAX_SPANS), span_id,
                              MAX_SPANS).long()
        per_span = torch.zeros((B, MAX_SPANS + 1), dtype=torch.int32,
                               device=dev)
        per_span.scatter_add_(1, counted, kept.to(torch.int32))
        span_len = per_span[:, :MAX_SPANS].contiguous()
        span_off = (span_len.cumsum(dim=1) - span_len).to(torch.int32)

    # ---- the intermediate stream: enumeration markers + span bytes -------
    opos = torch.arange(W, device=dev)[None, :]
    if enumerate_outputs and not passthrough:
        markers_np, marker_lens_np = _enum_markers()
        markers = torch.from_numpy(markers_np).to(dev)
        marker_lens = torch.from_numpy(marker_lens_np).to(dev)
        stream = torch.zeros((B, W), dtype=torch.uint8, device=dev)
        n = torch.zeros((B,), dtype=torch.int32, device=dev)
        for k in range(MAX_SPANS):
            live = k < n_spans
            mlen = torch.where(live, marker_lens[k], 0)
            wm = (opos >= n[:, None]) & (opos < (n + mlen)[:, None])
            midx = (opos - n[:, None]).clamp(0, _MARK - 1)
            stream = torch.where(wm, markers[k][midx], stream)
            n = n + mlen
            ln = torch.where(live, span_len[:, k], 0)
            ws = (opos >= n[:, None]) & (opos < (n + ln)[:, None])
            sidx = (opos - n[:, None] + span_off[:, k:k + 1]).clamp(0, L - 1)
            stream = torch.where(ws, ext.gather(1, sidx.expand(B, W)),
                                 stream)
            n = n + ln
        stream_len = n
    else:
        stream = torch.nn.functional.pad(ext, (0, W - L))
        stream = torch.where(opos < ext_len[:, None], stream, 0)
        stream_len = ext_len.to(torch.int32)

    # ---- the hide pass over the intermediate stream ----------------------
    if hide_start and hide_stop:
        in_r = opos < stream_len[:, None]
        hs = _match_mask(stream, stream_len, hide_start) & in_r
        he = _match_mask(stream, stream_len, hide_stop) & in_r
        keep_h, consumed_h, _, shown_end_h, _ = _scan(
            hs, he, len(hide_start), len(hide_stop), True,
            int(stream_len.max()) if B else 0)
        keep_h &= ~_holdback_mask(stream, stream_len, consumed_h, hide_start,
                                  shown_end_h)
        vis, vis_len = _compact(stream, keep_h & in_r, W)
    else:
        vis, vis_len = stream.contiguous(), stream_len
    return {"visual": vis, "visual_len": vis_len.to(torch.int32),
            "extracted": ext.contiguous(), "span_off": span_off,
            "span_len": span_len, "n_spans": n_spans.to(torch.int32),
            "raw_n_spans": raw_n_spans.to(torch.int32)}


# ---- one stream, the chat service's call --------------------------------------

def _char_oracle(raw: str, start: str, stop: str, hide_start: str,
                 hide_stop: str, enumerate_outputs: bool):
    """Exact chunk→0 oracle: the host state machines fed one character at
    a time (the limit the kernel implements). Used when the kernel's fixed
    span table can't hold the result."""
    from ..core.filters import InvertedFilter, OutputFilter
    extract = OutputFilter(start, stop, enumerate_outputs=enumerate_outputs)
    hide = InvertedFilter(hide_start, hide_stop)
    visual = ""
    for ch in raw:
        visual += hide(extract(ch))
    return list(extract.outputs), visual


def host_row(raw: str, device):
    """The row ``filter_chat_host`` filters for ``raw`` on ``device``: its
    UTF-8 bytes in a (1, L) uint8 tensor, L a power of two of at least 64
    above their count, and that count as a (1,) int32 tensor."""
    data = raw.encode("utf-8")
    L = max(64, 1 << max(len(data), 1).bit_length())
    buf = np.zeros((1, L), np.uint8)
    buf[0, :len(data)] = np.frombuffer(data, np.uint8)
    return (torch.from_numpy(buf).to(device),
            torch.tensor([len(data)], dtype=torch.int32).to(device))


def filter_chat_host(raw: str, start: str, stop: str, hide_start: str,
                     hide_stop: str, enumerate_outputs: bool, *,
                     device="cuda"):
    """Filter one host string on ``device`` (the first CUDA card unless the
    caller asks for the CPU); returns (outputs, visual_output) in the host
    filters' shapes. Streams opening more than MAX_SPANS outputs return the
    exact host oracle: truncating the span table would both drop outputs
    and starve the executor's ``len(outputs) < n_outputs`` retry loop."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("filter_chat_host: no CUDA device (pass "
                           "device='cpu' for the plain version)")
    out = filter_chat_text(
        *host_row(raw, device), start=start.encode(), stop=stop.encode(),
        hide_start=hide_start.encode(), hide_stop=hide_stop.encode(),
        enumerate_outputs=enumerate_outputs)
    if int(out["raw_n_spans"][0]) > MAX_SPANS:
        EVENTS.count("host.chat_filter")
        return _char_oracle(raw, start, stop, hide_start, hide_stop,
                            enumerate_outputs)
    return decode_row(out, 0)


def decode_row(out: dict, r: int):
    """Stream r of a ``filter_chat_text`` result in the host filters'
    shapes: (outputs, visual_output), each decoded with "replace" as the
    JAX package decodes them; only the table and the bytes it names leave
    the device."""
    S = MAX_SPANS
    table = torch.cat([out["span_off"][r], out["span_len"][r],
                       torch.stack([out["n_spans"][r],
                                    out["visual_len"][r]])]).cpu().tolist()
    n, vis_len = table[2 * S], table[2 * S + 1]
    offs, lens = table[:n], table[S:S + n]
    ext = out["extracted"][r, :sum(lens)].cpu().numpy().tobytes()
    vis = out["visual"][r, :vis_len].cpu().numpy().tobytes()
    return ([ext[o:o + k].decode("utf-8", "replace")
             for o, k in zip(offs, lens)], vis.decode("utf-8", "replace"))
