"""A rehearsal of the chat-filter kernel (``csrc/chat_filter.cu``) on the CPU.

The kernel's per-stream function (``filter_stream``: the extract pass, the
hide pass in place, the zero padding) compiles with g++ under a small header
that defines the CUDA qualifiers away and stands in for ``uint4`` and
``make_uint4``. The harness runs it for every stream as the kernel's threads
would (one thread a stream, no barrier, no shared memory). The outputs start
as garbage, as ``torch.empty`` leaves them, with a guard past each end that
must stay untouched, and every field must equal ``filter_chat_reference``
byte for byte: the JAX package's curated cases and its fuzz
(``tests/test_filter_kernel.py``), batches of mixed lengths, non-ASCII text,
long delimiters, more than 16 spans, clamped lengths and unaligned rows.
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
#define __device__
#define __host__
#define __forceinline__ inline
struct alignas(16) uint4 { unsigned x, y, z, w; };
static inline uint4 make_uint4(unsigned x, unsigned y, unsigned z,
                               unsigned w) {
  uint4 v = {x, y, z, w};
  return v;
}
#include "chat_filter.cu"

// The kernel's launch, a stream at a time (what each thread does).
// 0: done; -1: arguments the launch refuses.
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
  for (int r = 0; r < n; ++r) filter_stream(a, r);
  return 0;
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
    """The kernel's outputs, from outputs filled with garbage; the rows
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


def held(lib, bufs, lengths, delims, enum, offset: int = 0) -> dict:
    got = rehearse(lib, bufs, lengths, delims, enum, offset)
    start, stop, hs, he = delims
    want = fk.filter_chat_reference(bufs, lengths, start=start, stop=stop,
                                    hide_start=hs, hide_stop=he,
                                    enumerate_outputs=enum)
    for key in want:
        if not torch.equal(got[key], want[key]):
            bad = torch.nonzero((got[key] != want[key]).reshape(
                got[key].shape[0], -1).any(dim=1))[:, 0].tolist()
            raise AssertionError(f"{key} differs in rows {bad}: kernel "
                                 f"{got[key][bad[0]].tolist()} plain "
                                 f"{want[key][bad[0]].tolist()}")
    return got


def test_layout_is_the_wrappers(rehearsal):
    out = (ctypes.c_int * 2)()
    rehearsal.chat_filter_layout(out)
    assert (out[0], out[1]) == (fk.MAX_SPANS, fk.TABLE) == (16, 35)


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
