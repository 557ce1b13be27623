"""A rehearsal of the brace-scan kernel (``csrc/brace_scan.cu``) on the CPU.

The kernel's phases compile with g++ under a small header that defines the
CUDA qualifiers away and stands in for the intrinsics it uses (``__popc``,
``__clz``, ``__ffs``, ``make_int4``). The harness runs them block by block
as the card would between its barriers: every thread's ``row_begin``, then
for each slice of the rows (the first, and each further one while a row of
the tile reaches it) ``copy_chunk`` for every thread, then ``scan_chunk``
for every thread, and last ``row_end``. Shared memory starts as garbage
(brace and backslash bytes) before every slice, and a guard past its end
must stay untouched. The result must equal ``brace_scan_reference`` bit for
bit, and the JAX package's Pallas kernel in interpret mode on the curated
rows of ``tests/test_torch_brace_scan.py``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_brace_scan import CURATED, EDGES, jax_pallas, make_rows

from interpolation_engine_tpu_torch.ops import brace_scan as scan

CSRC = Path(scan.__file__).resolve().parent.parent / "csrc"

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
static inline int4 make_int4(int x, int y, int z, int w) {
  int4 v = {x, y, z, w};
  return v;
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __clz(int x) {
  return x ? __builtin_clz((unsigned)x) : 32;
}
static inline int __ffs(int x) { return __builtin_ffs(x); }
#include "brace_scan.cu"

static const char GARBAGE[] = "{}\\{\\}";

// The kernel's launch, block by block of ROWS threads; in a block each
// phase runs for every thread before the next one starts, as the kernel's
// barriers order them. Shared memory is garbage before each slice.
// 0: done; -1: arguments refused; -2: a block wrote past its shared memory.
extern "C" int rehearse(const uint8_t* bufs, const int* lengths, int* out,
                        int n, int ms) {
  if (n <= 0) return 0;
  if (ms < 0) return -1;
  const Args a{bufs, lengths, out, n, ms, scan_tile(ms)};
  const int guard = 64, size = a.tl.smem + guard;
  uint8_t* sm = (uint8_t*)aligned_alloc(16, (size + 15) / 16 * 16);
  Row rows[ROWS];
  int rc = 0;
  for (int b = 0; (long long)b * ROWS < n && rc == 0; ++b) {
    for (int t = 0; t < ROWS; ++t) rows[t] = row_begin(a, b, t);
    for (int k = 0; k < a.tl.chunks; ++k) {
      bool any = k == 0;
      for (int t = 0; t < ROWS; ++t) any = any || rows[t].len > k * CHUNK;
      if (!any) break;
      for (int j = 0; j < size; ++j) sm[j] = GARBAGE[j % 6];
      for (int t = 0; t < ROWS; ++t) copy_chunk(a, b, k, t, ROWS, sm);
      for (int t = 0; t < ROWS; ++t) scan_chunk(a, k, t, sm, rows[t]);
      for (int j = a.tl.smem; j < size; ++j)
        if (sm[j] != (uint8_t)GARBAGE[j % 6]) rc = -2;
    }
    for (int t = 0; t < ROWS; ++t) row_end(a, b, t, rows[t]);
  }
  free(sm);
  return rc;
}

extern "C" void tile(int ms, int* out5) {
  const ScanTile tl = scan_tile(ms);
  out5[0] = tl.chunk;
  out5[1] = tl.stride;
  out5[2] = tl.chunks;
  out5[3] = tl.smem;
  out5[4] = ROWS;
}
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("scan_rehearsal")
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "librehearsal.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-fno-strict-aliasing", "-Wall", "-Werror",
                    "-Wno-unknown-pragmas", "-Wno-maybe-uninitialized",
                    "-I", str(CSRC), "-o", str(so),
                    str(tmp / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rehearse.argtypes = [p, p, p, i, i]
    lib.rehearse.restype = i
    lib.tile.argtypes = [i, ctypes.POINTER(i)]
    lib.tile.restype = None
    return lib


def tile(lib, ms: int) -> dict:
    """The kernel's layout for rows of ``ms`` bytes (``scan_tile``)."""
    out = (ctypes.c_int * 5)()
    lib.tile(ms, out)
    return dict(zip(("chunk", "stride", "chunks", "smem", "rows"), out))


def rows_and_chunk(lib):
    """R, the rows a block, and the widest slice of a row a tile holds."""
    wide = tile(lib, 1 << 20)
    return wide["rows"], wide["chunk"]


def rehearse(lib, bufs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    n, ms = bufs.shape
    out = torch.full((n, 4), -7, dtype=torch.int32)
    rc = lib.rehearse(bufs.data_ptr(), lengths.data_ptr(), out.data_ptr(), n,
                      ms)
    assert rc == 0
    return out


def at_offset(rows: np.ndarray, offset: int) -> torch.Tensor:
    """The rows as a contiguous view whose base lies ``offset`` bytes into
    a larger buffer (filled with braces around it)."""
    n, ms = rows.shape
    big = torch.full((n * ms + offset + 32,), ord("{"), dtype=torch.uint8)
    view = big[offset:offset + n * ms].view(n, ms)
    view.copy_(torch.from_numpy(rows))
    assert view.is_contiguous()
    assert view.numel() == 0 or view.data_ptr() == big.data_ptr() + offset
    return view


def fuzz(ms: int, n: int, seed: int):
    """n seeded rows over ``ab{}\\ `` with lengths in [-3, MS + 5], the
    first lengths 0 .. MS once each."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab{}\\ ", np.uint8)
    bufs = alphabet[rng.integers(0, 6, (n, ms))]
    lens = rng.integers(-3, ms + 6, n).astype(np.int32)
    k = min(n, ms + 1)
    lens[:k] = np.arange(k)
    return bufs, lens


def held(lib, bufs: torch.Tensor, lens: np.ndarray) -> torch.Tensor:
    """The rehearsed kernel == the plain version, bit for bit."""
    ln = torch.from_numpy(lens)
    got = rehearse(lib, bufs, ln)
    want = scan.brace_scan_reference(bufs.contiguous(), ln)
    assert torch.equal(got, want), int((got != want).any(dim=1).sum())
    return got


@pytest.mark.parametrize("offset", [0, 1, 130])
@pytest.mark.parametrize("ms", [0, 1, 3, 4, 5, 31, 96, 130, 512])
def test_rehearsed_fuzz_equals_plain(ms, offset, rehearsal):
    R, _ = rows_and_chunk(rehearsal)
    bufs, lens = fuzz(ms, 3 * R + 5, seed=ms * 10 + offset)
    got = held(rehearsal, at_offset(bufs, offset), lens)
    if ms >= 31:     # the fuzz reaches every outcome
        assert (got[:, 2] == -1).any() and (got[:, 2] >= 0).any()
        assert (got[:, 3] == -1).any() and (got[:, 3] >= 0).any()


@pytest.mark.parametrize("n", ["1", "R-1", "R+1", "3R+5"])
@pytest.mark.parametrize("ms", [5, 96, 130, 512])
def test_rehearsed_ragged_tiles(n, ms, rehearsal):
    R, _ = rows_and_chunk(rehearsal)
    rows = {"1": 1, "R-1": R - 1, "R+1": R + 1, "3R+5": 3 * R + 5}[n]
    bufs, lens = fuzz(ms, rows, seed=rows + ms)
    held(rehearsal, at_offset(bufs, 1), lens)
    held(rehearsal, at_offset(bufs, 0), lens)


@pytest.mark.parametrize("tail", [b"", b"}{}{"])
@pytest.mark.parametrize("ms", [96, 128, 130])
def test_rehearsed_curated_equals_pallas(ms, tail, rehearsal):
    bufs, lens = make_rows(CURATED + EDGES, ms, tail)
    got = held(rehearsal, at_offset(bufs, 3), lens)
    np.testing.assert_array_equal(got.numpy(), jax_pallas(bufs, lens))


def word_edges(ms: int, chunk: int):
    """A backslash at the last byte of a word (and of a slice) before a
    brace, at every byte of a word; runs of backslashes across words."""
    rows = []
    for p in range(1, min(ms, 2 * chunk + 9)):
        row = bytearray(b"a" * ms)
        row[p - 1] = ord("\\")
        row[p] = ord("{" if p % 2 else "}")
        if p + 2 < ms:
            row[p + 2] = ord("}")
        rows.append(bytes(row))
    rows.append(b"\\" * (ms - 1) + b"{")
    rows.append((b"\\{" * ms)[:ms])
    rows.append((b"{\\" * ms)[:ms])
    rows.append((b"}" * (ms - 1) + b"{")[:ms])
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows),
                                                          ms).copy()


@pytest.mark.parametrize("ms", [8, 96, 257, 600])
def test_rehearsed_backslash_at_word_and_slice_ends(ms, rehearsal):
    bufs = word_edges(ms, rows_and_chunk(rehearsal)[1])
    n = bufs.shape[0]
    for lens in (np.full(n, ms, np.int32),
                 (np.arange(n) % (ms + 1)).astype(np.int32)):
        for offset in (0, 2):
            held(rehearsal, at_offset(bufs, offset), lens)


@pytest.mark.parametrize("ms", [600, 1030])
def test_rehearsed_rows_wider_than_a_tile(ms, rehearsal):
    """Rows wider than a slice go slice by slice with the scan carried in
    registers; a slice no row reaches is skipped."""
    R, chunk = rows_and_chunk(rehearsal)
    assert ms > chunk
    bufs, lens = fuzz(ms, R + 3, seed=ms)
    held(rehearsal, at_offset(bufs, 0), lens)
    held(rehearsal, at_offset(bufs, 7), lens)
    short = np.minimum(lens, chunk - 1)
    held(rehearsal, at_offset(bufs, 5), short)


def test_rehearsed_empty_width_and_batch(rehearsal):
    got = rehearse(rehearsal, torch.zeros((3, 0), dtype=torch.uint8),
                   torch.tensor([0, 2, -1], dtype=torch.int32))
    assert got.tolist() == [[0, 0, -1, -1]] * 3
    assert rehearse(rehearsal, torch.zeros((0, 8), dtype=torch.uint8),
                    torch.zeros((0,), dtype=torch.int32)).shape == (0, 4)


@pytest.mark.parametrize("ms", [0, 1, 5, 96, 130, 256, 257, 512, 4096])
def test_tile_rows_lie_an_odd_number_of_words_apart(ms, rehearsal):
    """The layout: a slice is at most 256 bytes, a row stride an odd number
    of words that holds the slice, so 32 threads reading word j of 32 rows
    hit 32 banks; a block's tile stays under 48 KB (no opt-in) and at MS 96
    sixteen blocks share an H100 SM's 228 KB."""
    R, widest = rows_and_chunk(rehearsal)
    assert (R, widest) == (128, 256)
    t = tile(rehearsal, ms)
    chunk, stride, smem = t["chunk"], t["stride"], t["smem"]
    assert chunk == min(ms, widest) and t["chunks"] == -(-ms // widest)
    assert stride % 4 == 0 and (stride // 4) % 2 == 1 and stride >= chunk
    assert smem == R * stride <= 48 * 1024
    for j in range(stride // 4):
        assert len({(t * stride // 4 + j) % 32 for t in range(32)}) == 32
    if ms == 96:
        assert 16 * (smem + 1024) <= 228 * 1024
