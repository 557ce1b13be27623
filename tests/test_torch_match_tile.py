"""A rehearsal of the wildcard-matcher kernel (``csrc/wildcard_match.cu``) on
the CPU.

The kernel's per-row function (``match_row``) compiles with g++ under a
small header that defines the CUDA qualifiers away; the harness runs it row
by row, as the kernel's threads do, with outputs that start as garbage.
Every field of every row (``ok``, ``supported``, ``n_caps``, ``cap_off``,
``cap_len``, unsupported rows included) must equal the plain version
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

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#define __device__
#define __host__
#define __forceinline__ inline
#include "wildcard_match.cu"

extern "C" int rehearse_max_stars() { return MAX_STARS; }

// The kernel's launch, a row at a time (one thread a row on the card), with
// the kernel's scratch arrays.
extern "C" void rehearse(const uint8_t* pat, const int* plen, int pms,
                         int shared, const uint8_t* subj, const int* slen,
                         int n, int ms, int max_stars, uint8_t* ok,
                         uint8_t* supported, int* n_caps, int* cap_off,
                         int* cap_len) {
  if (max_stars > MAX_STARS) abort();
  int stars[MAX_STARS], last[MAX_STARS + 1], trim_off[MAX_STARS],
      trim_len[MAX_STARS];
  for (int r = 0; r < n; ++r) {
    const long long pr = shared ? 0 : r;
    match_row(pat + pr * pms, pms, plen[pr], subj + (long long)r * ms, ms,
              slen[r], max_stars, stars, last, trim_off, trim_len, ok + r,
              supported + r, n_caps + r, cap_off + (long long)r * max_stars,
              cap_len + (long long)r * max_stars);
  }
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
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", str(CSRC), "-o", str(so),
                    str(tmp / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rehearse.argtypes = [p, p, i, i, p, p, i, i, i] + [p] * 5
    lib.rehearse.restype = None
    lib.rehearse_max_stars.restype = i
    return lib


def rehearse(lib, pb, pl, sb, sl, max_stars):
    n, ms = sb.shape
    pb, sb = (np.ascontiguousarray(a, np.uint8) for a in (pb, sb))
    pl, sl = (np.ascontiguousarray(a, np.int32) for a in (pl, sl))
    ok = np.full(n, 7, np.uint8)
    supported = np.full(n, 7, np.uint8)
    n_caps = np.full(n, -7, np.int32)
    cap_off = np.full((n, max_stars), -7, np.int32)
    cap_len = np.full((n, max_stars), -7, np.int32)
    lib.rehearse(pb.ctypes.data, pl.ctypes.data, pb.shape[1],
                 int(pb.shape[0] == 1), sb.ctypes.data, sl.ctypes.data, n, ms,
                 max_stars, ok.ctypes.data, supported.ctypes.data,
                 n_caps.ctypes.data, cap_off.ctypes.data, cap_len.ctypes.data)
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
         chunk=CHUNK):
    """The rehearsed kernel == the plain version == JAX on every field of
    every row; one pattern string is shared by all rows."""
    shared = isinstance(pats, str)
    pb, pl = pack([pats] if shared else pats, width, fill)
    sb, sl = pack(subjs, width, fill)
    got = rehearse(lib, pb, pl, sb, sl, max_stars)
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
