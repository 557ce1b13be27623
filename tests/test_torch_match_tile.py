"""A rehearsal of the wildcard-matcher kernel (``csrc/wildcard_match.cu``) on
the CPU.

The kernel's phases compile with g++ under a small header that defines the
CUDA qualifiers away and stands in for the intrinsics it uses (``__popc``,
``__clz``, ``__ffs``, ``__funnelshift_r``, ``uint4``). The harness runs
them block by block as the card would between its barrier: ``stage_block``
for every thread of a block (its subject rows within slen, its pattern rows
within plen or the one shared pattern, into shared memory), then
``match_thread`` for every thread. Shared memory starts as garbage
(pattern, subject and newline bytes) before every block, a guard past its
end must stay untouched, and the outputs start as garbage. Every field of
every row (``ok``, ``supported``, ``n_caps``, ``cap_off``, ``cap_len``,
unsupported rows included) must equal the plain version
(``wildcard_match_reference``) and the JAX package's ``wildcard_match``
(jitted under ``vmap`` on the CPU) bit for bit: on the patterns and
subjects of ``tests/test_match_kernel.py``, on seeded random patterns
(0-3 stars, segments up to 33 bytes) and subjects up to 96 bytes, per row
and shared, and on one named test per hazard.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interpolation_engine_tpu.ops import match_kernel as jmk
from interpolation_engine_tpu_torch.ops import match_kernel as mk

CSRC = Path(mk.__file__).resolve().parent.parent / "csrc"
MS = 96             # the bench's general VMConfig
STARS = 2           # its max_stars
CHUNK = 256         # rows per JAX call: one compile per shape
SMS = 132           # an H100's SMs: the kernel's rows a warp follow them

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
struct alignas(16) uint4 { unsigned x, y, z, w; };
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __clz(int x) {
  return x ? __builtin_clz((unsigned)x) : 32;
}
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline unsigned __funnelshift_r(unsigned lo, unsigned hi,
                                       unsigned s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
#include "wildcard_match.cu"

static const char GARBAGE[] = "ab*\nba\xff";

extern "C" int rehearse_max_stars() { return MAX_STARS; }

// The kernel's launch on a card of `sms` SMs (rows_a_warp picks the rows a
// warp from the kernel's WARPS_AN_SM, a block 4 * rpw rows), block by block of ROWS threads; in a block
// each phase runs for every thread before the next one starts, as the
// kernel's barrier orders them. Shared memory is garbage before each block.
// 0: done; -1: arguments refused; -2: a block wrote past its shared memory;
// -3: a thread wrote shared memory outside its own column (word k * ROWS +
// t of the scratch).
extern "C" int rehearse(const uint8_t* pat, const int* plen, int pms,
                        int shared, const uint8_t* subj, const int* slen,
                        int n, int ms, int max_stars, uint8_t* ok,
                        uint8_t* supported, int* n_caps, int* cap_off,
                        int* cap_len, int sms) {
  if (n <= 0) return 0;
  if (pms < 0 || ms < 0 || max_stars < 0 || max_stars > MAX_STARS)
    return -1;
  const int rpw = stage::rows_a_warp(n, sms, WARPS_AN_SM);
  const MatchArgs a{pat, plen, subj, slen, n, pms, ms, shared, max_stars,
                    rpw, ok, supported, n_caps, cap_off, cap_len};
  const MatchLayout l = match_layout(ms, pms, shared, max_stars);
  const int guard = 64, size = l.bytes + guard;
  uint8_t* sm = (uint8_t*)aligned_alloc(16, (size + 15) / 16 * 16);
  uint8_t* before = (uint8_t*)malloc(size);
  const int g = (int)sizeof(GARBAGE) - 1;
  int rc = 0;
  for (int b = 0; (long long)b * 4 * rpw < n && rc == 0; ++b) {
    for (int j = 0; j < size; ++j) sm[j] = GARBAGE[(j + b) % g];
    for (int t = 0; t < ROWS; ++t) stage_block(a, l, b, t, ROWS, sm);
    memcpy(before, sm, size);
    for (int t = 0; t < ROWS && rc == 0; ++t) {
      match_thread(a, l, b, t, sm);
      for (int j = 0; j < size; ++j)
        if (sm[j] != before[j] &&
            (j < l.scratch || (j - l.scratch) / 4 % ROWS != t))
          rc = -3;
      memcpy(before, sm, size);
    }
    for (int j = l.bytes; j < size; ++j)
      if (sm[j] != (uint8_t)GARBAGE[(j + b) % g]) rc = -2;
  }
  free(sm);
  free(before);
  return rc;
}

extern "C" int rows_a_warp(long long n, int sms) {
  return stage::rows_a_warp(n, sms, WARPS_AN_SM);
}

extern "C" void layout(int ms, int pms, int shared, int max_stars,
                       int* out8) {
  const MatchLayout l = match_layout(ms, pms, shared, max_stars);
  const int v[8] = {l.s_cap, l.s_stride, l.p_cap, l.p_stride, l.pat,
                    l.scratch, l.bytes, ROWS};
  for (int k = 0; k < 8; ++k) out8[k] = v[k];
}
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("match_rehearsal")
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
    lib.rehearse.argtypes = [p, p, i, i, p, p, i, i, i] + [p] * 5 + [i]
    lib.rehearse.restype = i
    lib.rehearse_max_stars.restype = i
    lib.rows_a_warp.argtypes = [ctypes.c_longlong, i]
    lib.rows_a_warp.restype = i
    lib.layout.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.layout.restype = None
    return lib


def layout(lib, ms, pms, shared, max_stars) -> dict:
    """The kernel's shared memory for a block (``match_layout``)."""
    out = (ctypes.c_int * 8)()
    lib.layout(ms, pms, int(shared), max_stars, out)
    return dict(zip(("s_cap", "s_stride", "p_cap", "p_stride", "pat",
                     "scratch", "bytes", "rows"), out))


def rehearse(lib, pb, pl, sb, sl, max_stars, sms=SMS):
    n, ms = sb.shape
    pb, sb = (np.ascontiguousarray(a, np.uint8) for a in (pb, sb))
    pl, sl = (np.ascontiguousarray(a, np.int32) for a in (pl, sl))
    ok = np.full(n, 7, np.uint8)
    supported = np.full(n, 7, np.uint8)
    n_caps = np.full(n, -7, np.int32)
    cap_off = np.full((n, max_stars), -7, np.int32)
    cap_len = np.full((n, max_stars), -7, np.int32)
    rc = lib.rehearse(pb.ctypes.data, pl.ctypes.data, pb.shape[1],
                      int(pb.shape[0] == 1), sb.ctypes.data, sl.ctypes.data,
                      n, ms, max_stars, ok.ctypes.data,
                      supported.ctypes.data, n_caps.ctypes.data,
                      cap_off.ctypes.data, cap_len.ctypes.data, sms)
    assert rc == 0
    assert set(np.unique(ok)) <= {0, 1} and set(np.unique(supported)) <= {0, 1}
    return mk.MatchResult(ok.astype(bool), supported.astype(bool), n_caps,
                          cap_off, cap_len)


_JAX = {}


def jax_match(pb, pl, sb, sl, max_stars, chunk=CHUNK):
    """JAX's wildcard_match under vmap, in chunks of ``chunk`` rows
    (padded), the pattern shared when it is one row."""
    shared = pb.shape[0] == 1
    key = (max_stars, shared)
    if key not in _JAX:
        axes = (None, None, 0, 0) if shared else 0
        _JAX[key] = jax.jit(jax.vmap(lambda p, n, s, m: jmk.wildcard_match(
            p, n, s, m, max_stars), in_axes=axes))
    fn = _JAX[key]
    n = sb.shape[0]
    parts = []
    for s in range(0, n, chunk):
        rows = [a[s:s + chunk] for a in ((sb, sl) if shared else
                                         (pb, pl, sb, sl))]
        pad = chunk - rows[0].shape[0]
        rows = [np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                for a in rows]
        args = ([pb[0], pl[0]] + rows) if shared else rows
        res = fn(*map(jnp.asarray, args))
        parts.append([np.asarray(f)[:chunk - pad] for f in res])
    return mk.MatchResult(*(np.concatenate(f) for f in zip(*parts)))


def pack(strings, width=MS, fill=None):
    """Rows of ``width`` bytes; past its length a row holds ``fill`` bytes
    (a numpy Generator draws them) or zeros."""
    bufs = np.zeros((len(strings), width), np.uint8)
    if fill is not None:
        bufs[:] = np.frombuffer(b"ab*\n", np.uint8)[
            fill.integers(0, 4, bufs.shape)]
    lens = np.zeros(len(strings), np.int32)
    for i, s in enumerate(strings):
        data = s.encode()[:width]
        bufs[i, :len(data)] = np.frombuffer(data, np.uint8)
        lens[i] = len(data)
    return bufs, lens


def held(lib, pats, subjs, max_stars=STARS, width=MS, fill=None,
         chunk=CHUNK, sms=SMS):
    """The rehearsed kernel == the plain version == JAX on every field of
    every row; one pattern string is shared by all rows."""
    shared = isinstance(pats, str)
    pb, pl = pack([pats] if shared else pats, width, fill)
    sb, sl = pack(subjs, width, fill)
    got = rehearse(lib, pb, pl, sb, sl, max_stars, sms)
    ref = mk.wildcard_match_reference(*map(torch.from_numpy, (pb, pl, sb,
                                                              sl)),
                                      max_stars)
    want = jax_match(pb, pl, sb, sl, max_stars, chunk)
    for name, g, p, j in zip(mk.MatchResult._fields, got, ref, want):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=f"{name} plain")
        np.testing.assert_array_equal(g, j, err_msg=f"{name} jax")
    return got


# ---- the cases of tests/test_match_kernel.py ----------------------------------------

JAX_TEST_CASES = [
    ("*", "anything\nwith newlines"), ("a*c", "abc"), ("a*c", "ac"),
    ("a*c", "abd"), ("exact", "exact"), ("exact", "exactx"), ("a.c", "a.c"),
    ("a.c", "abc"), ("abc", "abc\n"), ("*<a>*</a>*", "x<a>y</a>z"),
    ("a*", "abc"), ("a*", "zzz"), ("*x*", "axbxc"), ("**", "ab"),
    ("a*b*c", "aXbYc"), ("a*b*c", "abc"), ("", ""), ("", "\n"),
]


@pytest.mark.parametrize("max_stars", [2, 3, 7])
def test_rehearsed_cases_of_the_jax_tests(max_stars, rehearsal):
    got = held(rehearsal, [p for p, _ in JAX_TEST_CASES],
               [s for _, s in JAX_TEST_CASES], max_stars)
    assert got.ok.any() and not got.ok.all()


# ---- seeded random patterns and subjects --------------------------------------------

def random_pattern(rng):
    """0-3 stars between literal segments of 0-33 bytes over a small
    alphabet, so that literals occur, overlap and sometimes run past
    MAX_LIT."""
    segs = [rng.choice(["", "a", "b", "ab", "ba", "aab", "\n"])
            if rng.random() < 0.8 else
            "".join(rng.choice("ab") for _ in range(rng.randint(20, 33)))
            for _ in range(rng.randint(1, 4))]
    return "*".join(segs)


def random_subject(rng):
    k = rng.random()
    if k < 0.7:
        s = "".join(rng.choice("aab") for _ in range(rng.randint(0, 24)))
    else:
        s = "".join(rng.choice("ab\n") for _ in range(rng.randint(0, 96)))
    if rng.random() < 0.25:
        s = s[:95] + "\n"
    return s[:MS]


@pytest.mark.parametrize("seed", range(4))
def test_rehearsed_random_per_row_patterns(seed, rehearsal):
    rng = random.Random(seed)
    pats = [random_pattern(rng) for _ in range(768)]
    subjs = [random_subject(rng) for _ in range(768)]
    got = held(rehearsal, pats, subjs, fill=np.random.default_rng(seed))
    assert got.ok.any() and not got.ok.all()
    assert got.supported.any() and not got.supported.all()


@pytest.mark.parametrize("seed", range(3))
def test_rehearsed_random_shared_patterns(seed, rehearsal):
    rng = random.Random(50 + seed)
    for _ in range(3):
        pat = random_pattern(rng)
        subjs = [random_subject(rng) for _ in range(256)]
        # subjects built to match: the literals with filler between
        lits = pat.split("*")
        subjs[:64] = ["".join(lit + "".join(rng.choice("ab\n") for _ in
                                            range(rng.randint(0, 5)))
                              for lit in lits)[:MS] for _ in range(64)]
        held(rehearsal, pat, subjs, fill=np.random.default_rng(seed))


@pytest.mark.parametrize("max_stars", [1, 3, 7])
def test_rehearsed_random_at_other_max_stars(max_stars, rehearsal):
    rng = random.Random(90 + max_stars)
    pats = ["*".join(rng.choice(["", "a", "b", "ab"])
                     for _ in range(rng.randint(1, 9))) for _ in range(512)]
    subjs = [random_subject(rng) for _ in range(512)]
    held(rehearsal, pats, subjs, max_stars, width=48)


# ---- the hazards, one test each ----------------------------------------------------

def test_trailing_newline_end_anchor(rehearsal):
    got = held(rehearsal, ["ab", "ab", "", "a*b", "a*", "*b", "a*\n", "ab"],
               ["ab\n", "ab\n\n", "\n", "a\nb\n", "ab\n", "xb\n", "a\n",
                "ab\r\n"])
    assert got.ok.tolist() == [True, False, True, True, True, True, True,
                               False]
    # the match before the newline keeps its captures ('a*b' takes '\n',
    # '*b' 'x'); one at the full length is greedy through the newline
    # ('a*' takes 'b\n')
    assert got.cap_len[3, 0] == 1 and got.cap_len[5, 0] == 1
    assert got.cap_len[4, 0] == 2


def test_greedy_captures(rehearsal):
    got = held(rehearsal, ["*x*", "*a", "a*a*", "*ab*b", "*<*>*"],
               ["axbxc", "aaaa", "aaaa", "abxabyb", "a<b>c<d>e"], 3)
    assert got.ok.all()
    assert got.cap_off[0, :2].tolist() == [0, 4] and \
        got.cap_len[0, :2].tolist() == [3, 1]
    assert got.cap_len[1, 0] == 3 and got.cap_len[2, :2].tolist() == [2, 0]
    assert got.cap_len[3, :2].tolist() == [3, 1]


def test_more_stars_than_max_stars(rehearsal):
    got = held(rehearsal, ["a*b*c", "a*b*c*d", "***", "*" * 3 + "x"],
               ["aXbYc", "aXbYcZd", "abc", "abcx"])
    assert got.supported.tolist() == [True, False, False, False]
    assert got.n_caps.tolist() == [2, 2, 2, 2]


def test_at_the_kernels_max_stars(rehearsal):
    """max_stars at the kernel's limit (MAX_STARS, which sizes each
    thread's scratch): 64 stars fill the scratch, 65 are unsupported."""
    assert rehearsal.rehearse_max_stars() == mk.KERNEL_MAX_STARS
    rng = random.Random(64)
    pats = ["*".join(rng.choice(["", "a", "b"]) for _ in range(k + 1))
            for k in (64, 64, 65, 63, 10, 0)]
    subjs = ["".join(lit + rng.choice(["", "", "a", "ba"])
                     for lit in p.split("*")) for p in pats]
    subjs[1] = "b" + subjs[1]
    got = held(rehearsal, pats, subjs, mk.KERNEL_MAX_STARS, width=160,
               chunk=8)
    assert got.n_caps.tolist() == [64, 64, 64, 63, 10, 0]
    assert got.supported.tolist() == [True, True, False, True, True, True]
    assert got.ok[0] and got.ok[3:].all()


def test_segments_of_32_and_33_bytes(rehearsal):
    s32, s33 = "ab" * 16, "ab" * 16 + "a"
    got = held(rehearsal, [s32, s33, "*" + s32, "*" + s33, s33 + "*",
                           "*" + s33[:-1] + "b"],
               [s32, s33, "xx" + s32, "x" + s33, s33 + "zz", "x" + s33])
    assert got.supported.tolist() == [True, False, True, False, False,
                                      False]
    assert got.ok[[0, 2]].all()


def test_empty_subject(rehearsal):
    got = held(rehearsal, ["", "*", "**", "a", "*a", ""], ["", "", "", "",
                                                          "", "a"])
    assert got.ok.tolist() == [True, True, True, False, False, False]


def test_pattern_of_only_stars(rehearsal):
    got = held(rehearsal, ["*", "**", "***", "*", "**"],
               ["abc", "abc", "abc", "a\nb\n", ""], 3)
    assert got.ok.all()
    assert got.cap_len[1, :2].tolist() == [3, 0]
    assert got.cap_len[3, 0] == 4


def test_shared_pattern(rehearsal):
    subjs = ["x-y-z", "x-", "-", "xx-yy", "", "x-y\n", "y-x"]
    for pat in ("x*-*", "*y", "xyz", "*", "x*-*-*", ""):
        held(rehearsal, pat, subjs, 3)


def test_lengths_past_the_row(rehearsal):
    """Pattern and subject lengths past the row's width: bytes past it
    read as zero, as the JAX padding gives them."""
    pb, _ = pack(["ab*", "a*b", "*", "ab"], 4)
    sb, _ = pack(["abab", "aab", "abcd", "ab"], 4)
    for pl, sl in (([3, 9, 6, 2], [4, 4, 4, 6]),
                   ([5, 3, 1, 8], [7, 3, 9, 2])):
        pl, sl = np.asarray(pl, np.int32), np.asarray(sl, np.int32)
        got = rehearse(rehearsal, pb, pl, sb, sl, STARS)
        ref = mk.wildcard_match_reference(
            *map(torch.from_numpy, (pb, pl, sb, sl)), STARS)
        want = jax_match(pb, pl, sb, sl, STARS)
        for name, g, p, j in zip(mk.MatchResult._fields, got, ref, want):
            np.testing.assert_array_equal(g, p.numpy(), err_msg=name)
            np.testing.assert_array_equal(g, j, err_msg=name)


# ---- the block design's hazards, one test each -------------------------------------

def at_offset(rows: np.ndarray, offset: int) -> np.ndarray:
    """The rows as a contiguous view whose base lies ``offset`` bytes into
    a larger buffer (filled with stars and newlines around it)."""
    n, ms = rows.shape
    big = np.frombuffer(b"*\n" * (n * ms + offset + 32), np.uint8).copy()
    view = big[offset:offset + n * ms].reshape(n, ms)
    view[:] = rows
    assert view.flags.c_contiguous
    return view


def held_rows(lib, pb, pl, sb, sl, max_stars=STARS, chunk=CHUNK):
    """``held`` on rows already packed (any base, any lengths)."""
    got = rehearse(lib, pb, pl, sb, sl, max_stars)
    ref = mk.wildcard_match_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (pb, pl, sb,
                                                              sl)),
        max_stars)
    want = jax_match(*(np.ascontiguousarray(a) for a in (pb, pl, sb, sl)),
                     max_stars, chunk)
    for name, g, p, j in zip(mk.MatchResult._fields, got, ref, want):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=f"{name} plain")
        np.testing.assert_array_equal(g, j, err_msg=f"{name} jax")
    return got


def test_layout_rows_lie_an_odd_number_of_words_apart(rehearsal):
    """A block's shared memory: subject and pattern rows an odd number of
    words apart (32 threads reading word j of 32 rows hit 32 banks), at
    most stage::CAP = 256 bytes of a row staged, the scratch
    2 * max_stars words a thread after them; at MS 96 eight blocks of
    per-row patterns (max_stars 2) share an H100 SM's 228 KB, and the
    largest block (max_stars 64, rows past the stage) stays under 227 KB."""
    for ms in (0, 4, 24, 96, 130, 256, 600, 8192):
        for shared in (False, True):
            lay = layout(rehearsal, ms, ms, shared, STARS)
            assert lay["rows"] == 128
            assert lay["s_cap"] == lay["p_cap"] == min(ms, 256)
            for stride in (lay["s_stride"], lay["p_stride"]):
                assert stride % 4 == 0 and (stride // 4) % 2 == 1
                assert stride >= lay["s_cap"]
            assert lay["pat"] == 128 * lay["s_stride"]
            assert lay["scratch"] == lay["pat"] + (1 if shared else 128) \
                * lay["p_stride"]
            assert lay["bytes"] == lay["scratch"] + 2 * STARS * 128 * 4
    per_row = layout(rehearsal, MS, MS, False, STARS)["bytes"]
    assert 8 * (per_row + 1024) <= 228 * 1024
    assert layout(rehearsal, 8192, 8192, False, 64)["bytes"] <= 227 * 1024


def test_rows_a_warp(rehearsal):
    """32 rows a warp, halved down to 1 while a call gives fewer warps than
    the card has schedulers (the matcher wants one a scheduler, four an
    SM)."""
    got = [rehearsal.rows_a_warp(n, sms) for n, sms in (
        (131_072, 132), (16_896, 132), (10_000, 132), (8_448, 132),
        (8_432, 132), (4_096, 132), (1, 132), (4_096, 8), (421, 4),
        (421, 1))]
    assert got == [32, 32, 16, 16, 8, 4, 1, 32, 16, 32]


@pytest.mark.parametrize("sms", [1, 4, 10, 20, 50, 132])
def test_each_rows_a_warp(sms, rehearsal):
    """The same 421 rows at 32, 16, 8, 4, 2 and 1 rows a warp (the cards
    of 1, 4, 10, 20, 50 and 132 SMs): the idle lanes stage and match
    nothing."""
    assert rehearsal.rows_a_warp(421, sms) == {
        1: 32, 4: 16, 10: 8, 20: 4, 50: 2, 132: 1}[sms]
    rng = random.Random(10)
    pats = [random_pattern(rng) for _ in range(421)]
    subjs = [random_subject(rng) for _ in range(421)]
    held(rehearsal, pats, subjs, fill=np.random.default_rng(sms), sms=sms)
    held(rehearsal, pats[0], subjs, fill=np.random.default_rng(sms),
         sms=sms)


def test_partial_last_block(rehearsal):
    """Rows that end a block short (3 blocks and 37 rows): the last
    block's threads past the rows stage and match nothing."""
    rng = random.Random(11)
    for n in (1, 127, 129, 3 * 128 + 37):
        pats = [random_pattern(rng) for _ in range(n)]
        subjs = [random_subject(rng) for _ in range(n)]
        held(rehearsal, pats, subjs, fill=np.random.default_rng(n))
        held(rehearsal, pats[0], subjs, fill=np.random.default_rng(n))


def test_lengths_past_ms_and_of_zero(rehearsal):
    """Subject and pattern lengths past MS (the row's bytes and then
    zeros), of 0 and below, mixed in one block at MS 96."""
    rng = random.Random(12)
    n = 300
    pats = [random_pattern(rng) for _ in range(n)]
    subjs = [random_subject(rng) for _ in range(n)]
    pb, pl = pack(pats, fill=np.random.default_rng(1))
    sb, sl = pack(subjs, fill=np.random.default_rng(2))
    gen = np.random.default_rng(3)
    pick = gen.integers(0, 4, (2, n))
    wide = gen.integers(MS + 1, 3 * MS, (2, n)).astype(np.int32)
    for lens, k in ((pl, 0), (sl, 1)):
        lens[pick[k] == 0] = 0
        lens[pick[k] == 1] = wide[k][pick[k] == 1]
        lens[pick[k] == 2] = -gen.integers(1, 5, int((pick[k] == 2).sum()))
    got = held_rows(rehearsal, pb, pl, sb, sl)
    assert got.ok.any() and not got.ok.all()


@pytest.mark.parametrize("lit_len", [1, 2, 3, 4, 5, 7, 8, 9, 31, 32])
def test_literal_straddling_a_word_boundary_at_every_offset(lit_len,
                                                            rehearsal):
    """A literal at every offset 0-3 of a subject word and of a pattern
    word (the funnel shifts on both sides), matching, one byte off at its
    first, last and middle byte, and cut short by the row's length."""
    lit = "".join("ab"[(k * 7 + lit_len) % 3 % 2] for k in range(lit_len))
    pats, subjs = [], []
    for po in range(4):          # the literal's offset in the pattern
        for so in range(4):      # its offset in the subject
            for bad in (None, 0, lit_len - 1, lit_len // 2):
                s = list(lit)
                if bad is not None:
                    s[bad] = "x"
                s = "".join(s)
                pats.append("z" * po + "*" + lit + "*")
                subjs.append("z" * po + "y" * so + s + "yy")
                pats.append("*" + "z" * po + lit)
                subjs.append("w" * (so + 4) + "z" * po + s)
            pats.append("*" + lit)
            subjs.append("y" * so + lit[:-1])
    got = held(rehearsal, pats, subjs, fill=np.random.default_rng(lit_len))
    assert got.ok.any() and not got.ok.all()


def test_shared_pattern_staged_once_while_the_rows_differ(rehearsal):
    """One shared pattern, staged once a block, against 3 blocks of
    different subjects (each block's rows ending at other offsets)."""
    rng = random.Random(13)
    for pat in ("a*b*", "*ab*ba", "\n*a", "*", "", "ab" * 16 + "*",
                "*" + "ab" * 16 + "a"):
        lits = pat.split("*")
        subjs = ["".join(lit + "".join(rng.choice("ab\n") for _ in range(
            rng.randint(0, 7))) for lit in lits)[:MS] for _ in range(200)]
        subjs += [random_subject(rng) for _ in range(190)]
        got = held(rehearsal, pat, subjs, 3, fill=np.random.default_rng(7))
        if pat:
            assert got.ok.any()


def test_max_stars_64_at_ms_96(rehearsal):
    """The scratch at its largest (64 stars, 128 columns of 2 * 64 words)
    at the main path's width, per row and shared."""
    rng = random.Random(14)
    pats = ["*".join(rng.choice(["", "a", "b"]) for _ in range(
        rng.randint(1, 70))) for _ in range(200)]
    subjs = ["".join(lit + rng.choice(["", "a"]) for lit in p.split("*"))
             [:MS] for p in pats]
    held(rehearsal, pats, subjs, mk.KERNEL_MAX_STARS, chunk=16)
    held(rehearsal, "*a" * 40, subjs, mk.KERNEL_MAX_STARS, chunk=16)


@pytest.mark.parametrize("offset", [1, 2, 4, 16])
def test_rows_at_unaligned_bases(offset, rehearsal):
    """Rows whose base is 1, 2, 4 or 16 bytes off a 16-byte boundary, and
    a pattern width of 24 (4-byte units) or 21 (bytes): every unit size
    of the staging."""
    rng = random.Random(15 + offset)
    n = 260
    pats = [random_pattern(rng)[:20] for _ in range(n)]
    subjs = [random_subject(rng) for _ in range(n)]
    for pw in (24, 21, MS):
        pb, pl = pack(pats, pw, np.random.default_rng(offset))
        sb, sl = pack(subjs, fill=np.random.default_rng(offset + 1))
        held_rows(rehearsal, at_offset(pb, offset), pl,
                  at_offset(sb, offset), sl)
        held_rows(rehearsal, at_offset(pb[:1], offset), pl[:1],
                  at_offset(sb, 3), sl)


def test_rows_wider_than_the_stage(rehearsal):
    """Rows of 600 bytes whose subjects (max_stars 3) and patterns
    (max_stars 64) run past the 256 staged bytes: their tails are read in
    place, backward searches and star scans included."""
    rng = random.Random(16)

    def filled(lits, most):     # filler where the stars are
        return "".join(lit + ("" if k == len(lits) - 1 else "".join(
            rng.choice("ab\n") for _ in range(rng.randint(0, most))))
            for k, lit in enumerate(lits))[:600]

    pats, subjs = [], []
    for _ in range(200):
        lits = ["".join(rng.choice("ab") for _ in range(rng.randint(0, 30)))
                for _ in range(rng.randint(1, 4))]
        pats.append("*".join(lits))
        subjs.append(filled(lits, 250))
    got = held(rehearsal, pats, subjs, 3, width=600, chunk=64,
               fill=np.random.default_rng(16))
    assert got.ok.sum() > 20 and max(map(len, subjs)) > 400
    pats = ["*".join("".join(rng.choice("ab") for _ in range(
        rng.randint(2, 6))) for _ in range(65)) for _ in range(130)]
    subjs = [filled(p.split("*"), 3) for p in pats]
    got = held(rehearsal, pats, subjs, mk.KERNEL_MAX_STARS, width=600,
               chunk=16, fill=np.random.default_rng(17))
    assert got.ok.sum() > 20 and min(map(len, pats)) > 256
