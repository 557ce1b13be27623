"""A rehearsal of the math-evaluator kernel (``csrc/math_eval.cu``) on the CPU.

The kernel's phases compile with g++ under a small header that defines the
CUDA qualifiers away and stands in for ``uint4``. The harness runs them
block by block as the card would between its barrier: ``stage_block`` for
every thread of a block (its rows within their lengths into shared
memory), then ``eval_thread`` for every thread (the flat mode, or min or
max over a comma list). Shared memory starts as garbage (digits, operators
and commas) before every block, a guard past its end must stay untouched,
and the outputs start as garbage. Every row's ``(err, value)``, the value
of an erroring row included, must equal the plain versions
(``eval_flat_reference``, ``eval_enum_minmax_reference``) and the JAX
package's ``eval_flat`` and ``_eval_enum_minmax`` (jitted under ``vmap`` on
the CPU), bit for bit: on the expressions of ``tests/test_math_kernel.py``,
on seeded random expressions and comma lists whose rows carry junk past
their length, and on one named test per hazard. Last, the whole evaluator
(``eval_math_bytes``: paren passes and function dispatch in torch) with the
rehearsal in place of the kernel equals the JAX package's.
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

from test_math_kernel import CASES
from test_torch_math_kernel import INSERTS, random_exprs

from interpolation_engine_tpu.ops import math_kernel as jmk
from interpolation_engine_tpu.vm import state as jst
from interpolation_engine_tpu.vm.config import VMConfig
from interpolation_engine_tpu_torch.ops import interp_kernel as ik
from interpolation_engine_tpu_torch.ops import math_kernel as pmk
from interpolation_engine_tpu_torch.vm import state as pst

CSRC = Path(pmk.__file__).resolve().parent.parent / "csrc"
MS = 96             # the bench's general VMConfig
CHUNK = 256         # rows per JAX call: one compile per function
WRAP = 2 ** 32
SMS = 132           # an H100's SMs: the kernel's rows a warp follow them

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
struct alignas(16) uint4 { unsigned x, y, z, w; };
#include "math_eval.cu"

static const char GARBAGE[] = "1+,2*-9/ %07";

// The kernel's launch on a card of `sms` SMs (rows_a_warp picks the rows a
// warp from the kernel's WARPS_AN_SM, a block 4 * rpw rows), block by block of ROWS threads; in a block
// each phase runs for every thread before the next one starts, as the
// kernel's barrier orders them. Shared memory is garbage before each block.
// 0: done; -1: arguments refused; -2: a block wrote past its shared memory;
// -3: a thread wrote shared memory outside its own column (word k * ROWS +
// t of the scratch).
extern "C" int rehearse(const uint8_t* bufs, const int* lengths,
                        const uint8_t* want_max, int n, int ms, int* err,
                        int* value, int sms) {
  if (n <= 0) return 0;
  if (ms < 0) return -1;
  const int rpw = stage::rows_a_warp(n, sms, WARPS_AN_SM);
  const MathArgs a{bufs, lengths, want_max, n, ms, rpw, err, value};
  const MathLayout l = math_layout(ms);
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
      eval_thread(a, l, b, t, sm);
      for (int j = 0; j < size; ++j)
        if (sm[j] != before[j] &&
            (j < l.nums || (j - l.nums) / 4 % ROWS != t))
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

extern "C" void layout(int ms, int* out5) {
  const MathLayout l = math_layout(ms);
  const int v[5] = {l.cap, l.stride, l.nums, l.bytes, ROWS};
  for (int k = 0; k < 5; ++k) out5[k] = v[k];
}
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("math_rehearsal")
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
    lib.rehearse.argtypes = [p, p, p, i, i, p, p, i]
    lib.rehearse.restype = i
    lib.rows_a_warp.argtypes = [ctypes.c_longlong, i]
    lib.rows_a_warp.restype = i
    lib.layout.argtypes = [i, ctypes.POINTER(i)]
    lib.layout.restype = None
    return lib


def layout(lib, ms) -> dict:
    """The kernel's shared memory for a block (``math_layout``)."""
    out = (ctypes.c_int * 5)()
    lib.layout(ms, out)
    return dict(zip(("cap", "stride", "nums", "bytes", "rows"), out))


def rehearse(lib, bufs, lens, want_max=None, sms=SMS):
    """(err, value) of the rehearsed kernel; outputs start as garbage."""
    n, ms = bufs.shape
    bufs = np.ascontiguousarray(bufs, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    err = np.full(n, -7, np.int32)
    value = np.full(n, -7, np.int32)
    wm = None if want_max is None else np.ascontiguousarray(want_max,
                                                            np.uint8)
    rc = lib.rehearse(bufs.ctypes.data, lens.ctypes.data,
                      None if wm is None else wm.ctypes.data, n, ms,
                      err.ctypes.data, value.ctypes.data, sms)
    assert rc == 0
    return err, value


@pytest.fixture(scope="module")
def jax_fns():
    return {"flat": jax.jit(jax.vmap(jmk.eval_flat)),
            "enum": jax.jit(jax.vmap(jmk._eval_enum_minmax))}


def jax_rows(fn, *arrays):
    """fn over the rows in chunks of CHUNK (padded): one compile."""
    n = arrays[0].shape[0]
    errs, vals = [], []
    for s in range(0, n, CHUNK):
        part = [a[s:s + CHUNK] for a in arrays]
        pad = CHUNK - part[0].shape[0]
        part = [np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                for a in part]
        res = fn(*map(jnp.asarray, part))
        errs.append(np.asarray(res.err)[:CHUNK - pad])
        vals.append(np.asarray(res.value)[:CHUNK - pad])
    return np.concatenate(errs), np.concatenate(vals)


def encode(exprs, ms=MS, junk=None):
    """Rows of ``ms`` bytes; past its length a row holds ``junk`` (a
    numpy Generator draws digits and operators) or zeros."""
    bufs = np.zeros((len(exprs), ms), np.uint8)
    if junk is not None:
        bufs[:] = np.frombuffer(b"0123456789+-*/%., ", np.uint8)[
            junk.integers(0, 18, bufs.shape)]
    lens = np.zeros(len(exprs), np.int32)
    for r, text in enumerate(exprs):
        data = text.encode()[:ms]
        bufs[r, :len(data)] = np.frombuffer(data, np.uint8)
        lens[r] = len(data)
    return bufs, lens


def held(lib, jax_fns, bufs, lens, want_max=None, sms=SMS):
    """The rehearsed kernel == the plain version == JAX, row for row;
    returns (err, value)."""
    got = rehearse(lib, bufs, lens, want_max, sms)
    tb, tl = torch.from_numpy(bufs), torch.from_numpy(lens)
    if want_max is None:
        ref = pmk.eval_flat_reference(tb, tl)
        want = jax_rows(jax_fns["flat"], bufs, lens)
    else:
        ref = pmk.eval_enum_minmax_reference(
            tb, tl, torch.from_numpy(np.asarray(want_max, bool)))
        want = jax_rows(jax_fns["enum"], bufs, lens,
                        np.asarray(want_max, bool))
    for name, g, p, j in zip(("err", "value"), got, ref, want):
        bad = np.nonzero((g != p.numpy()) | (g != j))[0]
        assert bad.size == 0, (name, [(bytes(bufs[r, :lens[r]]), g[r],
                                       int(p[r]), j[r]) for r in bad[:5]])
    return got


def flat(lib, jax_fns, exprs, **kw):
    return held(lib, jax_fns, *encode(exprs, **kw))


def wrap32(v: int) -> int:
    return (v + 2 ** 31) % WRAP - 2 ** 31


# ---- the cases of tests/test_math_kernel.py ----------------------------------------

@pytest.mark.parametrize("mode", ["flat", "min", "max"])
def test_rehearsed_cases_of_the_jax_tests(mode, rehearsal, jax_fns):
    exprs = [e for _, e in CASES]
    exprs += [e.replace("(", "").replace(")", "") for e in exprs]
    bufs, lens = encode(exprs)
    want_max = None if mode == "flat" else np.full(
        len(exprs), mode == "max")
    err, _ = held(rehearsal, jax_fns, bufs, lens, want_max)
    assert {ik.ERR_OK, ik.ERR_ASSERT} <= set(err.tolist())


# ---- seeded random expressions and comma lists -----------------------------------

NUMBERS = ["0", "1", "2", "3", "7", "9", "10", "31", "32", "99", "65536",
           "46341", "2147483647", "2147483648", "4294967295", "99999999999"]
OPS = ["+", "-", "*", "/", "%", "**", "//"]


def flat_expr(rng):
    """A paren-free expression: numbers (near-wrap ones too), the seven
    operators, unary signs, spaces, and now and then a fault."""
    parts = []
    for k in range(rng.randint(1, 6)):
        if k:
            parts.append(rng.choice(["", " "]) + rng.choice(OPS)
                         + rng.choice(["", " "]))
        parts.append(rng.choice(["", "", "", "-", "- ", "--", "+", "-+"])
                     + rng.choice(NUMBERS))
    e = "".join(parts)
    k = rng.random()
    if k < 0.05:
        e += rng.choice([" +", "*", "**", " //"])      # trailing operator
    elif k < 0.1:
        e = e[:rng.randint(0, len(e))] + rng.choice([".", "x", "(", ",", "^"]) \
            + e[rng.randint(0, len(e)):]
    elif k < 0.13:
        e = rng.choice(["", " ", "  ", "*1", "/2", "%3"]) + e
    return e


def random_flat(seed: int, count: int):
    rng = random.Random(seed)
    return [flat_expr(rng) for _ in range(count)]


@pytest.mark.parametrize("seed", range(4))
def test_rehearsed_random_flat_expressions(seed, rehearsal, jax_fns):
    exprs = random_flat(seed, 512)
    err, _ = flat(rehearsal, jax_fns, exprs,
                  junk=np.random.default_rng(seed))
    assert {ik.ERR_OK, ik.ERR_ASSERT, ik.ERR_HOST} <= set(err.tolist())


@pytest.mark.parametrize("seed", range(3))
def test_rehearsed_random_comma_lists(seed, rehearsal, jax_fns):
    rng = random.Random(100 + seed)
    exprs = [",".join(flat_expr(rng) for _ in range(rng.randint(1, 4)))
             + rng.choice(["", "", ",", ", ", ",,"]) for _ in range(512)]
    bufs, lens = encode(exprs, junk=np.random.default_rng(seed))
    want_max = np.asarray([rng.random() < 0.5 for _ in exprs])
    err, _ = held(rehearsal, jax_fns, bufs, lens, want_max)
    assert {ik.ERR_OK, ik.ERR_ASSERT, ik.ERR_HOST} <= set(err.tolist())


@pytest.mark.parametrize("seed", range(2))
def test_rehearsed_paren_test_generator(seed, rehearsal, jax_fns):
    """The expressions of tests/test_torch_math_kernel.py's generator,
    parens and function names and all, as flat rows (they mostly err, each
    at its own byte) and as comma lists."""
    exprs = random_exprs(3000 + seed, 256)
    bufs, lens = encode(exprs, junk=np.random.default_rng(seed))
    held(rehearsal, jax_fns, bufs, lens)
    held(rehearsal, jax_fns, bufs, lens, np.arange(len(exprs)) % 2 == 0)


def test_rehearsed_lengths_past_the_row(rehearsal, jax_fns):
    """A length below 0 or past MS: reads clamp to the row's last byte, as
    a JAX gather does."""
    bufs, _ = encode(["1+2", "12", "3*4", "-5", "9,8", "7 ", "1,", "5"], ms=4)
    lens = np.asarray([-1, 6, 9, 0, 7, 4, 12, 5], np.int32)
    held(rehearsal, jax_fns, bufs, lens)
    held(rehearsal, jax_fns, bufs, lens, np.arange(8) % 2 == 1)


# ---- the hazards, one test each ----------------------------------------------------

def test_int32_wrap_at_each_operator(rehearsal, jax_fns):
    exprs = ["2147483647 + 1", "-2147483647 - 2", "65536 * 65536",
             "46341 * 46341", "-2147483647 - 1 // -1", "2 ** 31",
             "-(2147483647)", "- 2147483647 - 1", "4294967296",
             "99999999999", "2147483648 - 1", "3 ** 20 * 3 ** 20"]
    err, value = flat(rehearsal, jax_fns, exprs)
    assert (err == ik.ERR_OK).sum() == len(exprs) - 1   # the '(' row errs
    assert value[0] == -2 ** 31 and value[2] == 0
    assert value[3] == wrap32(46341 * 46341)
    assert value[8] == 0 and value[9] == wrap32(99999999999)


def test_floor_division_and_modulo_take_the_divisor_sign(rehearsal,
                                                         jax_fns):
    exprs = ["-7 % 3", "7 % -3", "-7 // 2", "7 // -2", "-7 % -3", "-6 // 4",
             "6 // -4", "-1 % 5", "-2147483648 % -1", "-2147483647-1 // -1"]
    err, value = flat(rehearsal, jax_fns, exprs)
    assert (err == ik.ERR_OK).all()
    assert value[:8].tolist() == [eval(e) for e in exprs[:8]]
    assert value[8] == 0


def test_true_division_only_when_exact(rehearsal, jax_fns):
    err, value = flat(rehearsal, jax_fns, ["10 / 2", "-9 / 3", "7 / 2",
                                           "-7 / 2", "1/0", "5 % 0",
                                           "4 // 0", "0 / 5"])
    assert err.tolist() == [ik.ERR_OK, ik.ERR_OK, ik.ERR_HOST, ik.ERR_HOST] \
        + [ik.ERR_ASSERT] * 3 + [ik.ERR_OK]
    assert value[:4].tolist() == [5, -3, 3, -4]   # an erring row's value


def test_power_exponent_is_clipped_to_31(rehearsal, jax_fns):
    err, value = flat(rehearsal, jax_fns, ["2 ** 31", "2 ** 32", "3 ** 31",
                                           "3 ** 32", "2 ** -1", "1 ** 99",
                                           "-1 ** 32", "0 ** 0"])
    assert err.tolist() == [ik.ERR_OK] * 4 + [ik.ERR_HOST] + [ik.ERR_OK] * 3
    assert value.tolist()[:4] == [-2 ** 31, -2 ** 31, wrap32(3 ** 31),
                                  wrap32(3 ** 31)]
    assert value.tolist()[5:] == [1, -1, 1]


def test_unary_minus_binds_between_mul_and_pow(rehearsal, jax_fns):
    exprs = ["-2**2", "2*-3", "-2*3", "2**3**2", "--3", "2 - -3", "+5",
             "2**-2**2", "-3 % 5", "*3", "1 + % 2"]
    err, value = flat(rehearsal, jax_fns, exprs)
    assert value[:9].tolist() == [-4, -6, -6, 512, 3, 5, 5, 1, 2]
    assert err[7] == ik.ERR_HOST and err[9] == err[10] == ik.ERR_ASSERT


def test_stack_of_16_entries_and_the_17th(rehearsal, jax_fns):
    ops16 = "-" * 16 + "1"
    nums16 = "**".join(["1"] * 16)
    err, value = flat(rehearsal, jax_fns, [
        ops16, "-" + ops16, nums16, nums16 + "**1",
        "1+" + "-" * 15 + "1", "1+" + "-" * 16 + "1"])
    assert err.tolist() == [ik.ERR_OK, ik.ERR_HOST, ik.ERR_OK, ik.ERR_HOST,
                            ik.ERR_OK, ik.ERR_HOST]
    assert value[0] == 1 and value[2] == 1


def test_a_dot_in_a_number_defers(rehearsal, jax_fns):
    err, value = flat(rehearsal, jax_fns, ["1.5", "1.", "2 + 3.0", "7..",
                                           ".5"])
    assert err.tolist() == [ik.ERR_HOST] * 4 + [ik.ERR_ASSERT]
    assert value[0] == 15      # the digits, the dot skipped


def test_empty_expression_and_trailing_operator(rehearsal, jax_fns):
    err, value = flat(rehearsal, jax_fns, ["", "   ", "1 +", "2 **", "-",
                                           "3 //", "4 5"])
    assert (err == ik.ERR_ASSERT).all()
    assert value[2] == 1 and value[6] == 4


def test_enumeration_min_and_max_with_an_erring_segment(rehearsal,
                                                        jax_fns):
    exprs = ["3,1,2", "3,1,2", "5,2/0,1", "5,2/0,1", "4,7/2,9", "", ",",
             "1,,2", "-1, 2**3 ,-9", "2,"]
    want_max = np.asarray([False, True] * 5)
    err, value = held(rehearsal, jax_fns, *encode(exprs), want_max)
    assert err.tolist() == [ik.ERR_OK, ik.ERR_OK, ik.ERR_ASSERT,
                            ik.ERR_ASSERT, ik.ERR_HOST, ik.ERR_ASSERT,
                            ik.ERR_ASSERT, ik.ERR_ASSERT, ik.ERR_OK,
                            ik.ERR_ASSERT]
    assert value[:2].tolist() == [1, 3] and value[8] == -9


# ---- the block design's hazards, one test each -------------------------------------

def at_offset(rows: np.ndarray, offset: int) -> np.ndarray:
    """The rows as a contiguous view whose base lies ``offset`` bytes into
    a larger buffer (filled with digits and commas around it)."""
    n, ms = rows.shape
    big = np.frombuffer(b"9," * (n * ms + offset + 32), np.uint8).copy()
    view = big[offset:offset + n * ms].reshape(n, ms)
    view[:] = rows
    assert view.flags.c_contiguous
    return view


def both_modes(lib, jax_fns, bufs, lens, sms=SMS):
    """``held`` in the flat mode and in the enumeration mode (min and max
    alternating)."""
    held(lib, jax_fns, bufs, lens, sms=sms)
    held(lib, jax_fns, bufs, lens, np.arange(bufs.shape[0]) % 2 == 0, sms)


def test_layout_rows_lie_an_odd_number_of_words_apart(rehearsal):
    """A block's shared memory: rows an odd number of words apart (32
    threads reading word j of 32 rows hit 32 banks), at most stage::CAP =
    256 bytes of a row staged, then the operand stacks (16 words a thread,
    entry k of thread t at word k * 128 + t); at MS 96 ten blocks share an
    H100 SM's 228 KB, and no block needs the opt-in past 48 KB."""
    for ms in (0, 1, 7, 24, 96, 130, 256, 600, 8192):
        lay = layout(rehearsal, ms)
        assert lay["rows"] == 128 and lay["cap"] == min(ms, 256)
        assert lay["stride"] % 4 == 0 and (lay["stride"] // 4) % 2 == 1
        assert lay["stride"] >= lay["cap"]
        assert lay["nums"] == 128 * lay["stride"]
        assert lay["bytes"] == lay["nums"] + 16 * 128 * 4 <= 48 * 1024
    assert 10 * (layout(rehearsal, MS)["bytes"] + 1024) <= 228 * 1024


def test_rows_a_warp(rehearsal):
    """32 rows a warp, halved down to 1 while a call gives fewer than four
    warps a scheduler (sixteen an SM), to overlap the walks' chains."""
    got = [rehearsal.rows_a_warp(n, 132) for n in (
        131_072, 67_584, 67_552, 16_384, 4_096, 1)]
    assert got == [32, 32, 16, 4, 1, 1]


@pytest.mark.parametrize("sms", [1, 2, 4, 8, 16, 132])
def test_each_rows_a_warp(sms, rehearsal, jax_fns):
    """The same 600 rows at 32, 16, 8, 4, 2 and 1 rows a warp (the cards
    of 1, 2, 4, 8, 16 and 132 SMs): the idle lanes stage and evaluate
    nothing."""
    assert rehearsal.rows_a_warp(600, sms) == {
        1: 32, 2: 16, 4: 8, 8: 4, 16: 2, 132: 1}[sms]
    rng = random.Random(10)
    exprs = [",".join(flat_expr(rng) for _ in range(rng.randint(1, 3)))
             for _ in range(600)]
    both_modes(rehearsal, jax_fns,
               *encode(exprs, junk=np.random.default_rng(sms)), sms)


@pytest.mark.parametrize("n", [1, 127, 129, 3 * 128 + 37])
def test_partial_last_block(n, rehearsal, jax_fns):
    """Rows that end a block short: the last block's threads past the
    rows stage and evaluate nothing."""
    rng = random.Random(n)
    exprs = [",".join(flat_expr(rng) for _ in range(rng.randint(1, 3)))
             for _ in range(n)]
    both_modes(rehearsal, jax_fns, *encode(exprs,
                                           junk=np.random.default_rng(n)))


def test_lengths_past_ms_and_of_zero(rehearsal, jax_fns):
    """Lengths of 0, below 0 and past MS (reads clamp to byte MS - 1 in
    the flat mode and in an enumeration's first segment, zero in a later
    one), mixed in the blocks at MS 96."""
    rng = random.Random(21)
    n = 400
    exprs = [",".join(flat_expr(rng) for _ in range(rng.randint(1, 3)))
             for _ in range(n)]
    bufs, lens = encode(exprs, junk=np.random.default_rng(21))
    gen = np.random.default_rng(22)
    pick = gen.integers(0, 4, n)
    lens[pick == 0] = 0
    lens[pick == 1] = gen.integers(MS + 1, 4 * MS, int((pick == 1).sum()))
    lens[pick == 2] = -gen.integers(1, 5, int((pick == 2).sum()))
    both_modes(rehearsal, jax_fns, bufs, lens)
    # rows of digits to the end, so that the clamped byte is a digit
    digits = ["1" * MS, "12+" * 32, "3," * 48, "7" * 95 + ",", "8" * 40]
    bufs, _ = encode(digits)
    lens = np.asarray([MS + 5, MS + 1, 200, 150, 0], np.int32)
    both_modes(rehearsal, jax_fns, bufs, lens)


def test_int_min_floor_division_and_modulo_by_minus_one(rehearsal,
                                                        jax_fns):
    """INT_MIN // -1 and INT_MIN / -1 wrap to INT_MIN, INT_MIN % -1 is 0,
    as the 64-bit path computes them (a 32-bit division would trap)."""
    exprs = ["-2147483648 // -1", "2147483648 // -1", "-2147483648 % -1",
             "2147483648 % -1", "-2147483648 / -1", "2147483648 / -1",
             "2147483648 // 4294967295", "2147483648 % 4294967295",
             "7 // -1", "-7 % -1", "0 // -1", "2147483648 // 1",
             "2147483648 // -2", "2147483648 % 3", "2147483648 // 3"]
    err, value = flat(rehearsal, jax_fns, exprs)
    assert (err == ik.ERR_OK).all()
    lo = -2 ** 31
    assert value[:8].tolist() == [lo, lo, 0, 0, lo, lo, lo, 0]
    assert value[8:].tolist() == [-7, 0, 0, lo, 2 ** 30, lo % 3, lo // 3]


BASES = ["0", "1", "2", "3", "7", "10", "46341", "65535", "2147483647",
         "2147483648", "4294967295", "4294967294", "4294967293"]


def test_power_by_squaring_equals_the_loop_at_exponents_0_to_40(
        rehearsal, jax_fns):
    """'**' by squaring equals the repeated wrapped product, the exponent
    clipped to 31, for exponents 0-40 and bases near 0 and near the wrap
    (the last three are -1, -2 and -3 once wrapped)."""
    exprs = [f"{b} ** {e}" for b in BASES for e in range(41)]
    err, value = flat(rehearsal, jax_fns, exprs)
    assert (err == ik.ERR_OK).all()
    want = []
    for b in BASES:
        for e in range(41):
            acc = 1
            for _ in range(min(e, 31)):
                acc = wrap32(acc * wrap32(int(b)))
            want.append(acc)
    assert value.tolist() == want


@pytest.mark.parametrize("offset", [1, 2, 4, 16])
def test_rows_at_unaligned_bases(offset, rehearsal, jax_fns):
    """Rows whose base is 1, 2, 4 or 16 bytes off a 16-byte boundary, at
    widths 96, 24 (4-byte units) and 21 (bytes): every unit size of the
    staging."""
    rng = random.Random(30 + offset)
    for ms in (MS, 24, 21):
        exprs = [",".join(flat_expr(rng) for _ in range(rng.randint(1, 3)))
                 for _ in range(260)]
        bufs, lens = encode(exprs, ms, np.random.default_rng(offset))
        both_modes(rehearsal, jax_fns, at_offset(bufs, offset), lens)


def test_rows_wider_than_the_stage(rehearsal, jax_fns):
    """Rows of 600 bytes whose expressions and comma lists run past the
    256 staged bytes (their tails read in place), and lengths past 600."""
    rng = random.Random(40)
    exprs = []
    for k in range(300):
        parts = [flat_expr(rng) for _ in range(rng.randint(20, 60))]
        sep = "," if k % 2 else rng.choice([" + ", " - ", "*"])
        exprs.append(sep.join(parts))
    bufs, lens = encode(exprs, 600, np.random.default_rng(40))
    assert (lens > 300).sum() > 100
    lens[::7] += 50
    both_modes(rehearsal, jax_fns, bufs, lens)


# ---- the whole evaluator with the rehearsal in place of the kernel ----------------

@pytest.fixture(scope="module")
def jax_whole():
    cfg = VMConfig(max_str=MS, max_key=48, n_slots=16, arena_size=1024,
                   pool_size=16, out_size=256)
    fn = jax.jit(jax.vmap(
        lambda st, b, ln: jmk._eval_math_bytes_impl(st, b, ln, cfg),
        in_axes=(None, 0, 0)))
    return cfg, fn


@pytest.mark.parametrize("seed", range(2))
def test_eval_math_bytes_through_the_rehearsal_equals_jax(
        seed, rehearsal, jax_whole, monkeypatch):
    """The paren passes and the function dispatch in torch, every flat and
    enumeration evaluation through the rehearsed kernel (the card's path,
    where eval_flat and _eval_enum_minmax launch it)."""
    cfg, jfn = jax_whole
    calls = []

    def kernel(buf, length, want_max=None):
        n = buf.shape[0]
        lens = pmk.bs.col(length, n, buf.device).numpy()
        wm = None if want_max is None else want_max.numpy()
        calls.append(n)
        err, value = rehearse(rehearsal, buf.numpy(), lens, wm)
        return pmk.EvalResult(torch.from_numpy(err), torch.from_numpy(value))

    monkeypatch.setattr(pmk, "eval_flat", kernel)
    monkeypatch.setattr(pmk, "_eval_enum_minmax", kernel)
    exprs = [e for _, e in CASES] + random_exprs(4000 + seed, 200)
    exprs = [e for e in exprs if len(e.encode()) <= MS]
    bufs, lens = encode(exprs)
    st = pst.stack_rows([pst.encode_inserts(INSERTS, cfg)] * len(exprs))
    got = pmk.eval_math_bytes(st, torch.from_numpy(bufs),
                              torch.from_numpy(lens), cfg)
    jrow = jst.encode_inserts(INSERTS, cfg)
    want = jax_rows(lambda b, ln: jfn(jrow, b, ln), bufs, lens)
    np.testing.assert_array_equal(got.err.numpy(), want[0])
    np.testing.assert_array_equal(got.value.numpy(), want[1])
    assert calls and (got.err.numpy() == ik.ERR_OK).sum() > 50
