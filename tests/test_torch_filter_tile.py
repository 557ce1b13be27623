"""A rehearsal of the chat-filter kernel (``csrc/chat_filter.cu``) on the CPU.

The kernel's block (``filter_block``: the extract pass and the hide pass,
each in tiles of ``TILE`` bytes, then the stored tail, the padding and the
table) compiles with g++ under a small header that defines the CUDA
qualifiers away and stands in for ``uint4``, ``make_uint4``, ``atomicOr``
and ``__ffs``. Its phases are per-thread functions with barriers only
between them; on the host ``EACH`` runs a phase for every thread of the
block in turn, as the barriers order them. The harness runs one block a
stream on shared memory filled with garbage, with a guard past its end.
The outputs start as garbage, as ``torch.empty`` leaves them, with a guard
past each end that must stay untouched, and every field must equal
``filter_chat_reference`` byte for byte: the JAX package's curated cases
and its fuzz (``tests/test_filter_kernel.py``), batches of mixed lengths,
non-ASCII text, long delimiters, more than 16 spans, clamped lengths and
unaligned rows. The tile cases (streams of several tiles, each of the four
delimiters and a hold-back across a tile boundary, dense candidates, widths
that are not a multiple of 16, ``host_row``'s width, 40 spans over several
tiles) must also equal the JAX package's ``filter_chat_text``, jitted on
the CPU, on every field of every row; all but a 300-byte delimiter, whose
JAX compile takes minutes (it grows with the delimiter's length).
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_chat import (CUT_TEXTS, FILTER_CASES as CASES, STREAM_DELIMS,
                        by_delimiters, chat_stream, cut_rows, fuzz_streams,
                        rows)

from interpolation_engine_tpu_torch.ops import filter_kernel as fk

CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
struct alignas(16) uint4 { unsigned x, y, z, w; };
static inline uint4 make_uint4(unsigned x, unsigned y, unsigned z,
                               unsigned w) {
  uint4 v = {x, y, z, w};
  return v;
}
static inline unsigned atomicOr(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p |= v;
  return old;
}
static inline int __ffs(int x) { return __builtin_ffs(x); }
#include "chat_filter.cu"

// The kernel's launch, a stream at a time on its own shared memory: the
// block runs each phase for every thread in turn (EACH), as the barriers
// order them, on shared memory filled with garbage, with a guard past its
// end.
static int run(const FilterArgs& a) {
  const size_t guard = 64, size = sizeof(Block) + guard;
  uint8_t* sm = (uint8_t*)aligned_alloc(16, (size + 15) / 16 * 16);
  int rc = 0;
  for (int r = 0; r < a.n && rc == 0; ++r) {
    memset(sm, 0xA5, size);
    filter_block(a, r, *reinterpret_cast<Block*>(sm));
    for (size_t j = sizeof(Block); j < size; ++j)
      if (sm[j] != 0xA5) rc = -2;
  }
  free(sm);
  return rc;
}

// 0: done; -1: arguments the launch refuses; -2: a block wrote past its
// shared memory.
extern "C" int rehearse(const uint8_t* bufs, const int* lengths, int n,
                        int L, int W, const uint8_t* delims, int start_len,
                        int stop_len, int hs_len, int he_len, int enumerate,
                        uint8_t* ext, uint8_t* vis, int* table) {
  if (L < 0 || W < L + 85) return -1;
  FilterArgs a;
  a.bufs = bufs;
  a.lengths = lengths;
  a.n = n;
  a.L = L;
  a.W = W;
  a.start = Delim{delims, start_len};
  a.stop = Delim{delims + start_len, stop_len};
  a.hide_start = Delim{delims + start_len + stop_len, hs_len};
  a.hide_stop = Delim{delims + start_len + stop_len + hs_len, he_len};
  a.enumerate = enumerate != 0;
  a.ext = ext;
  a.vis = vis;
  a.table = table;
  return run(a);
}
"""

GUARD = 64
GARBAGE = 0xA5


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("filter_rehearsal")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "librehearsal.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-fno-strict-aliasing", "-Wall", "-Werror",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(so),
                    str(tmp / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rehearse.argtypes = [p, p, i, i, i, p] + [i] * 5 + [p] * 3
    lib.rehearse.restype = i
    lib.chat_filter_layout.argtypes = [ctypes.POINTER(i)]
    lib.chat_filter_layout.restype = i
    return lib


def rehearse(lib, bufs, lengths, delims, enum, offset: int = 0) -> dict:
    """The kernel's outputs from outputs filled with garbage; the rows
    ``offset`` bytes past an aligned base, the outputs too."""
    n, L = bufs.shape
    W = fk.visual_width(L)
    src = np.full(n * L + offset + 16, GARBAGE, np.uint8)
    src[offset:offset + n * L] = bufs.numpy().reshape(-1)
    ext = np.full(n * L + offset + GUARD, GARBAGE, np.uint8)
    vis = np.full(n * W + offset + GUARD, GARBAGE, np.uint8)
    table = np.full(n * fk.TABLE + GUARD, -7, np.int32)
    lens = np.ascontiguousarray(lengths.numpy(), np.int32)
    d = [x.encode() if isinstance(x, str) else x for x in delims]
    blob = np.frombuffer(b"".join(d) or b"\0", np.uint8).copy()
    rc = lib.rehearse(src.ctypes.data + offset, lens.ctypes.data, n, L, W,
                      blob.ctypes.data, *map(len, d), int(enum),
                      ext.ctypes.data + offset, vis.ctypes.data + offset,
                      table.ctypes.data)
    assert rc == 0
    assert (ext[:offset] == GARBAGE).all() and (vis[:offset] == GARBAGE).all()
    assert (ext[offset + n * L:] == GARBAGE).all(), "ext written past its end"
    assert (vis[offset + n * W:] == GARBAGE).all(), "vis written past its end"
    assert (table[n * fk.TABLE:] == -7).all(), "table written past its end"
    return fk._unpack(
        torch.from_numpy(ext[offset:offset + n * L].reshape(n, L)),
        torch.from_numpy(vis[offset:offset + n * W].reshape(n, W)),
        torch.from_numpy(table[:n * fk.TABLE].reshape(n, fk.TABLE)))


def jax_rows(bufs, lengths, delims, enum) -> dict:
    """The JAX package's ``filter_chat_text`` (jitted on the CPU, one row a
    call, ``out_size = 2 L + 256``) on every row, as the port's fields:
    ``visual`` cut to ``visual_width(L)``, past which JAX's is 0."""
    import jax.numpy as jnp
    from interpolation_engine_tpu.ops import filter_kernel as jfk
    L = bufs.shape[1]
    W = fk.visual_width(L)
    start, stop, hs, he = (x.encode() if isinstance(x, str) else bytes(x)
                           for x in delims)
    outs = []
    for buf, n in zip(bufs.numpy(), lengths.tolist()):
        out = jfk.filter_chat_text(
            jnp.asarray(buf), jnp.int32(n), start=start, stop=stop,
            hide_start=hs, hide_stop=he, enumerate_outputs=enum,
            out_size=2 * L + 256)
        out = {k: np.asarray(v) for k, v in out.items()}
        assert not out["visual"][W:].any()
        out["visual"] = out["visual"][:W]
        outs.append(out)
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def held(lib, bufs, lengths, delims, enum, offset: int = 0,
         jax: bool = False) -> dict:
    """The kernel equal to the plain version on every field; with ``jax``
    also to the JAX package's ``filter_chat_text``."""
    start, stop, hs, he = delims
    want = fk.filter_chat_reference(bufs, lengths, start=start, stop=stop,
                                    hide_start=hs, hide_stop=he,
                                    enumerate_outputs=enum)
    got = rehearse(lib, bufs, lengths, delims, enum, offset)
    for key in want:
        if not torch.equal(got[key], want[key]):
            bad = torch.nonzero((got[key] != want[key]).reshape(
                got[key].shape[0], -1).any(dim=1))[:, 0].tolist()
            raise AssertionError(
                f"{key} differs in rows {bad}: kernel "
                f"{got[key][bad[0]].tolist()} plain "
                f"{want[key][bad[0]].tolist()}")
    if jax:
        for key, value in jax_rows(bufs, lengths, delims, enum).items():
            bad = [r for r in range(len(value))
                   if not np.array_equal(got[key][r].numpy(), value[r])]
            assert not bad, f"{key} differs from JAX's in rows {bad}"
    return got


def layout(lib) -> list:
    """MAX_SPANS, TABLE and the tile."""
    out = (ctypes.c_int * 3)()
    lib.chat_filter_layout(out)
    return list(out)


def test_layout_is_the_wrappers(rehearsal):
    out = layout(rehearsal)
    assert (out[0], out[1]) == (fk.MAX_SPANS, fk.TABLE) == (16, 35)
    assert out[2] == 16 * 128


@pytest.fixture(scope="module")
def tile(rehearsal):
    """The kernel's tile: bytes of a stream staged at a time."""
    return layout(rehearsal)[2]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rehearsed_curated_case(case, rehearsal):
    raw, start, stop, hs, he, enum = CASES[case]
    bufs, lengths = rows([raw])
    held(rehearsal, bufs, lengths, (start, stop, hs, he), enum)


@pytest.mark.parametrize("text", range(len(CUT_TEXTS)))
def test_rehearsed_cut_at_every_length(text, rehearsal):
    """A text cut at every length, the bytes after the cut still in the
    row: a delimiter that runs past the length does not match, and the
    hold-back skips bytes a match consumed."""
    raw, delims = CUT_TEXTS[text]
    bufs, lengths = cut_rows(raw)
    for enum in (False, True):
        held(rehearsal, bufs, lengths, delims, enum)


@pytest.mark.parametrize("seed", [991, 5, 6])
def test_rehearsed_fuzz_in_batches(seed, rehearsal):
    """The fuzz's streams, one mixed-length batch a delimiter set, at the
    width of the longest and at exactly its length."""
    for (start, stop, hs, he, enum), raws in by_delimiters(
            fuzz_streams(seed)).items():
        bufs, lengths = rows(raws)
        held(rehearsal, bufs, lengths, (start, stop, hs, he), enum)
        tight = max(int(lengths.max()), 1)
        bufs, lengths = rows(raws, tight)
        held(rehearsal, bufs, lengths, (start, stop, hs, he), enum)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_rehearsed_unaligned_rows(offset, rehearsal):
    """Rows and outputs off a 16-byte boundary: the zero fill takes bytes
    up to the boundary, then 16 at a time."""
    raws = [r for r, *_ in fuzz_streams(17, 40)]
    bufs, lengths = rows(raws, 100)
    for delims, enum in ((("<o>", "</o>", "<h>", "</h>"), True),
                         (("", "", "<h>", "</h>"), False)):
        held(rehearsal, bufs, lengths, delims, enum, offset)


def test_rehearsed_non_ascii(rehearsal):
    raws = ["héllo <o>wörld ✓</o> tail ☃", "<o>日本語</o><o>ü<h>秘密</h>x</o>",
            "<o>ÿĀ</o", "🎉<o>🎉🎉</o>🎉<o>", "<o>aé</o>\xe9"]
    bufs, lengths = rows(raws)
    for enum in (False, True):
        held(rehearsal, bufs, lengths, ("<o>", "</o>", "<h>", "</h>"), enum)
    # delimiters that are multi-byte characters, and a cut inside one
    held(rehearsal, bufs, lengths, ("🎉", "☃", "", ""), True)
    cut = lengths.clone()
    cut[0] -= 1
    held(rehearsal, bufs, cut, ("<o>", "</o>", "", ""), False)


def test_rehearsed_long_delimiters(rehearsal):
    """Delimiters of 40 and 300 bytes: no length cap in the kernel; the
    hold-back of a stop prefix up to 299 bytes long."""
    start, stop = "<" + "s" * 38 + ">", "[" + "e" * 298 + "]"
    raws = [start + "kept" + stop + "out" + start + "tail" + stop[:150],
            start + "x" + stop[:299], "no delimiter", start + stop,
            (start + "ab" + stop) * 3]
    bufs, lengths = rows(raws)
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths, (start, stop, "<h" * 20,
                                              "</h" * 30), enum)
    assert got["n_spans"].tolist() == [2, 1, 0, 1, 3]


def test_rehearsed_more_than_16_spans(rehearsal):
    """Past MAX_SPANS the table is clipped, raw_n_spans counts on, an
    enumerated stream leaves the later spans out and a plain one keeps
    them."""
    raws = ["".join(f"<o>s{k}</o>," for k in range(n)) for n in
            (15, 16, 17, 20, 40)]
    raws.append(raws[-1] + "<o>open </")
    bufs, lengths = rows(raws)
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths, ("<o>", "</o>", "s1", "9"),
                   enum)
        assert got["raw_n_spans"].tolist() == [15, 16, 17, 20, 40, 41]
        assert got["n_spans"].tolist() == [15, 16, 16, 16, 16, 16]


def test_rehearsed_lengths_clamped_and_empty(rehearsal):
    """A length below 0 counts as 0 and one above L as L; empty streams;
    a batch of one byte a row."""
    raws = ["<o>ab</o>", "<o>ab</o>", "", "<o>"]
    bufs, lengths = rows(raws, 9)
    lengths = torch.tensor([-3, 40, 0, 3], dtype=torch.int32)
    for delims in (("<o>", "</o>", "", ""), ("", "", "a", "b"),
                   ("", "", "", "")):
        held(rehearsal, bufs, lengths, delims, True)
    bufs, lengths = rows(["<", "x", ""], 1)
    held(rehearsal, bufs, lengths, ("<o>", "</o>", "<h>", "</h>"), False)


def test_rehearsed_chat_shaped_streams(rehearsal):
    """Streams shaped like chip_smoke.py's phase 19 (``chat_stream``), cut
    at drawn lengths; some open more than 16 spans."""
    rng = random.Random(3)
    raws = [chat_stream(i, rng.randint(0, 1024), rng,
                        None if i % 9 else 20) for i in range(48)]
    bufs, lengths = rows(raws, 1024)
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths, STREAM_DELIMS, enum)
    assert int(got["raw_n_spans"].max()) > 16


# ---- the tiles --------------------------------------------------------------

def prose(n: int, seed: int = 0) -> str:
    """n bytes of ASCII text with no delimiter byte in it."""
    unit = f"words {seed} and more words, "
    return (unit * (n // len(unit) + 1))[:n]


def test_rehearsed_streams_of_several_tiles(rehearsal, tile):
    """Chat streams of 4-6 tiles, one in three opening 20 spans, in rows
    whose width is no multiple of 16, aligned and not: every piece of
    state crosses tiles (shown, the consumed delimiter's end, the spans,
    the outputs' staged tails)."""
    rng = random.Random(11)
    raws = [chat_stream(i, rng.randint(4 * tile, 6 * tile), rng,
                        None if i % 3 else 20) for i in range(6)]
    bufs, lengths = rows(raws, 6 * tile + 5)
    for enum, offset in ((False, 0), (True, 0), (True, 3)):
        got = held(rehearsal, bufs, lengths, STREAM_DELIMS, enum, offset,
                   jax=True)
    assert int(got["raw_n_spans"].max()) == 20


@pytest.mark.parametrize("which", range(4),
                         ids=["start", "stop", "hide_start", "hide_stop"])
def test_rehearsed_delimiter_straddling_a_tile_boundary(which, rehearsal,
                                                        tile):
    """The delimiter begins k bytes before the first and the second tile
    boundary, for every k from 0 to its length: the match reads past the
    tile. The hide delimiters run over the intermediate stream, which in
    passthrough is the stream itself; with the extract delimiters on as
    well, over a stream shifted by the consumed start and the marker."""
    d = STREAM_DELIMS[which]
    raws = []
    for k in range(len(d) + 1):
        text = ""
        for boundary in (tile, 2 * tile):
            if which == 0:    # start: a span opens across the boundary
                text += prose(boundary - k - len(text)) + d + "kept</out>"
            elif which == 1:  # stop: a span closes across it
                text += "<out>"
                text += prose(boundary - k - len(text)) + d
            elif which == 2:  # hide_start: a hidden block opens across it
                text += prose(boundary - k - len(text)) + d + "x</think>"
            else:             # hide_stop: a hidden block closes across it
                text += "<think>"
                text += prose(boundary - k - len(text)) + d
        raws.append(text + prose(40, k))
    bufs, lengths = rows(raws, 3 * tile)
    passthrough = ("", "", "<think>", "</think>")
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths,
                   STREAM_DELIMS if which < 2 else passthrough, enum,
                   jax=True)
        if which < 2:
            assert got["n_spans"].tolist() == [2] * len(raws)
    if which >= 2:  # the same texts inside one span: shifted by 5 - 3
        wrapped = ["<out>" + r for r in raws]
        bufs, lengths = rows(wrapped, 3 * tile)
        held(rehearsal, bufs, lengths, STREAM_DELIMS, True, jax=True)
        # a short span, whose intermediate stream the kernel keeps whole in
        # shared memory: the delimiter k bytes before its tile boundary
        # there (after the 3-byte marker "1. ")
        short = []
        for k in range(len(d) + 1):
            lead = "" if which == 2 else "<think>"
            body = lead + prose(tile - k - 3 - len(lead)) + d
            short.append("<out>" + body + "x</think>" * (which == 2)
                         + prose(200, k))
        bufs, lengths = rows(short, 2 * tile)
        held(rehearsal, bufs, lengths, STREAM_DELIMS, True, jax=True)


def test_rehearsed_holdback_straddling_a_tile_boundary(rehearsal, tile):
    """A stream that ends, shown, in the first m bytes of the pending
    delimiter, begun k bytes before a tile boundary, for every m and k: the
    held bytes were staged, some in the tile before. Then a 300-byte stop
    whose 250-byte prefix ends a stream across the boundary, and a
    hide_start prefix at the end of the visual text."""
    stop = "</out>"
    raws = ["<out>" + prose(tile - 5 - k) + stop[:m]
            for m in range(1, len(stop)) for k in range(m + 1)]
    bufs, lengths = rows(raws, 2 * tile + 3)
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths, STREAM_DELIMS, enum,
                   jax=True)
    assert (got["span_len"][:, 0] == torch.tensor(
        [tile - 5 - k for m in range(1, len(stop))
         for k in range(m + 1)])).all()
    long_stop = "[" + "e" * 298 + "]"
    raws = ["<s>" + prose(tile - 3 - k) + long_stop[:250]
            for k in (0, 1, 100, 249, 250)]
    bufs, lengths = rows(raws, 2 * tile)
    # (not held to JAX: its compile grows with the delimiter's length)
    held(rehearsal, bufs, lengths, ("<s>", long_stop, "", ""), True)
    raws = [prose(tile - k) + "<think>"[:m] for m in range(1, 7)
            for k in range(m + 1)]
    bufs, lengths = rows(raws, 2 * tile)
    held(rehearsal, bufs, lengths, ("", "", "<think>", "</think>"), False,
         jax=True)


def test_rehearsed_dense_candidates(rehearsal, tile):
    """Candidates at every byte, over three tiles: one-byte delimiters that
    are the text's only byte (a span a byte pair), back-to-back delimiters
    (empty spans, far past 16), overlapping matches inside consumed bytes,
    text of the delimiters' first byte that never matches whole, and
    delimiters that begin with a zero byte."""
    n = 2 * tile + 37
    cases = [("<" * n, ("<", "<", "", "")),
             ("<" * n, ("<", "<<", "<", "<<")),
             ("<o></o>" * (n // 7), ("<o>", "</o>", "", "")),
             ("<o>x</o>" * (n // 8), ("<o>", "</o>", "x", "</")),
             ("a" * n, ("aa", "aaa", "a", "aa")),
             ("\0a" * (n // 2), ("\0", "a", "a\0", "\0\0")),
             ("<" * n, STREAM_DELIMS)]
    for text, delims in cases:
        bufs, lengths = rows([text, text[:tile + 1], text[:tile - 1]],
                             3 * tile)
        for enum in (False, True):
            held(rehearsal, bufs, lengths, delims, enum, jax=True)


@pytest.mark.parametrize("extra", [1, 5, 15])
def test_rehearsed_widths_not_a_multiple_of_16(extra, rehearsal, tile):
    """Rows of k tiles and a few bytes, streams cut at and next to the
    tile boundaries and at the row's end, aligned and not."""
    L = 2 * tile + extra
    rng = random.Random(extra)
    cuts = [0, 1, tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile, L]
    raws = [chat_stream(i, c, rng) for i, c in enumerate(cuts)]
    bufs, lengths = rows(raws, L)
    for enum, offset in ((True, 0), (False, 7)):
        held(rehearsal, bufs, lengths, STREAM_DELIMS, enum, offset,
             jax=True)


def test_rehearsed_one_stream_at_host_rows_width(rehearsal):
    """The chat service's call: one 8 KB stream in ``host_row``'s row of
    16,384 bytes, the shape chip_smoke.py times."""
    raw = chat_stream(7, 8192, random.Random(0)).decode()
    bufs, lengths = fk.host_row(raw, "cpu")
    assert tuple(bufs.shape) == (1, 16384)
    for enum in (False, True):
        held(rehearsal, bufs, lengths, STREAM_DELIMS, enum, jax=True)


def test_rehearsed_more_than_16_spans_over_several_tiles(rehearsal, tile):
    """40 spans over five tiles: the table clips at 16 and raw_n_spans
    counts on; an enumerated stream leaves the spans past 16 out."""
    raws = ["".join(f"<out>{prose(150 + j, k)}{k}</out>{prose(60)}"
                    for k in range(40)) for j in (0, 7)]
    bufs, lengths = rows(raws)
    for enum in (False, True):
        got = held(rehearsal, bufs, lengths, STREAM_DELIMS, enum,
                   jax=True)
    assert got["raw_n_spans"].tolist() == [40, 40]
    assert got["n_spans"].tolist() == [16, 16]
