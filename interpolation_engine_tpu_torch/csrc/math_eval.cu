// Byte math evaluator kernel for Hopper (sm_90a): an interpolated, paren-free
// integer expression evaluated in int32 per row, with Python's operator
// semantics.
//
// Replaces the flat evaluator of interpolation_engine_tpu/ops/math_kernel.py,
// which the JAX package jits as XLA (no pallas_call): `eval_flat` (:92, its
// lax.while_loops at :135, :177, :207 and :221) and `_eval_enum_minmax`
// (:282, loop :304), the per-byte parts of `_eval_math_bytes_impl` (:334,
// jitted at :324). The paren loop around them (innermost group first, at
// most MAX_PARENS passes, and the function dispatch over stored lists)
// stays batched torch in ops/math_kernel.py and calls this kernel once a
// pass.
//
// For row r of bufs (N, MS) uint8 with lengths (N,) int32 it writes err[r]
// and value[r] (int32), in one of two modes:
//   flat         (want_max null) the row's expression;
//   enumeration  (want_max (N,) bool) min (0) or max (1) over the row's
//                comma-separated expressions, each evaluated flat, in turn,
//                stopping at the first that errs.
// Both equal the plain versions (eval_flat_reference,
// eval_enum_minmax_reference) on every row, the value an erroring row
// carries included:
//   * int32 arithmetic, wrapping after every operation, digits included;
//   * '//' and '%' floor and take the divisor's sign (never fmod); '/' only
//     when exact, else ERR_HOST; a zero divisor ERR_ASSERT;
//   * '**' right-associative, a negative exponent ERR_HOST, the loop count
//     clipped to [0, 31] (the JAX fori_loop's quirk: 2**32 is 2**31 and
//     3**40 is 3**31, both wrapped);
//   * unary minus binds tighter than '*', '/', '%' and looser than '**';
//     unary '+' is the identity, any other unary operator ERR_ASSERT;
//   * a '.' in a number ERR_HOST; a 17th entry on either stack ERR_HOST;
//   * an empty expression, a trailing operator, a byte that is no digit,
//     space or operator, or a final stack that is not one number,
//     ERR_ASSERT.
// Reads clamp to the row as a JAX gather does: an index past MS reads byte
// MS - 1. An enumeration segment reads as the JAX bs.substring gives it
// (zero past the segment's length and past the row).
//
// What bounds it on this card: device-memory bytes. A call must read each
// row's bytes within its length (and the length) once and write 8 bytes a
// row; the work a byte is a few integer operations.
//
// Design: one thread a row, one walk over the bytes, the classic two-stack
// (shunting-yard) evaluation: the operand stack (int32) and the operator
// stack (STACK = 16 entries each) in local memory, reductions as an
// operator of lower precedence arrives. The TPU program moved every row by
// one event per loop trip and so kept the rows in lockstep; a thread needs
// none of that. The row is read in place, a byte at a time (its bytes come
// through L1 after the first), which is far from the bound: a later design
// would stage a block's rows in shared memory in 16-byte loads, as the
// brace scan does.
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the per-row functions
// (`eval_flat_row`, `eval_enum_row`): the CPU tests
// (tests/test_torch_math_tile.py) run them that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int STACK = 16;
constexpr int ERR_OK = 0, ERR_ASSERT = 2, ERR_HOST = 4;
constexpr int OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4, OP_MOD = 5,
              OP_POW = 6, OP_FLOORDIV = 7, OP_NEG = 8;
constexpr int COMMA = 44, DOT = 46, SPACE = 32;

struct MathResult {
  int err;
  int32_t value;
};

// One expression's bytes: the segment [start, start + len) of a row as
// bs.substring cuts it into a fresh row of the same width; the whole row
// is the segment (0, n).
struct MathView {
  const uint8_t* row;
  int n;  // the row's width (MS)
  int start;
  int len;
};

__device__ __forceinline__ int view_byte(const MathView& v, int j) {
  if (v.n <= 0) return 0;
  const int q = j < 0 ? 0 : (j >= v.n ? v.n - 1 : j);
  return (q < v.len && v.start + q < v.n) ? v.row[v.start + q] : 0;
}

__device__ __forceinline__ int clip_stack(int i) {
  return i < 0 ? 0 : (i >= STACK ? STACK - 1 : i);
}

__device__ __forceinline__ int precedence(int op) {
  switch (op) {
    case OP_ADD: case OP_SUB: return 1;
    case OP_MUL: case OP_DIV: case OP_MOD: case OP_FLOORDIV: return 2;
    case OP_NEG: return 3;
    case OP_POW: return 4;
    default: return 0;
  }
}

__device__ __forceinline__ int32_t wrap(int64_t x) {
  return (int32_t)(uint32_t)(uint64_t)x;
}

// Apply the top operator to the top operands; the result replaces them
// (stack indices clamped as the JAX gathers clamp them). Returns the error.
__device__ int reduce_once(int32_t* nums, int& ns, const uint8_t* ops,
                           int& os) {
  const int op = ops[clip_stack(os - 1)];
  const bool unary = op == OP_NEG;
  const int32_t b = nums[clip_stack(ns - 1)];
  const int32_t a = unary ? 0 : nums[clip_stack(ns - 2)];
  const int64_t sb = b == 0 ? 1 : b;
  int64_t mod = (int64_t)a % sb;
  if (mod != 0 && ((mod < 0) != (sb < 0))) mod += sb;
  const int64_t div = ((int64_t)a - mod) / sb;  // exact: the floor
  int32_t val = 0;
  switch (op) {
    case OP_ADD: val = wrap((int64_t)a + b); break;
    case OP_SUB: val = wrap((int64_t)a - b); break;
    case OP_MUL: val = wrap((int64_t)a * b); break;
    case OP_DIV: case OP_FLOORDIV: val = wrap(div); break;
    case OP_MOD: val = (int32_t)mod; break;
    case OP_POW: {
      const int times = b < 0 ? 0 : (b > 31 ? 31 : b);
      int32_t acc = 1;
      for (int k = 0; k < times; ++k) acc = wrap((int64_t)acc * a);
      val = acc;
      break;
    }
    case OP_NEG: val = wrap(-(int64_t)b); break;
    default: break;
  }
  int err = ERR_OK;
  if (op == OP_DIV && mod != 0)
    err = ERR_HOST;
  else if ((op == OP_DIV || op == OP_MOD || op == OP_FLOORDIV) && b == 0)
    err = ERR_ASSERT;
  else if (op == OP_POW && b < 0)
    err = ERR_HOST;
  if (!unary) ns -= 1;
  nums[clip_stack(ns - 1)] = val;
  os -= 1;
  return err;
}

__device__ MathResult eval_flat_view(const MathView& v, int length) {
  int32_t nums[STACK];
  uint8_t ops[STACK];
  for (int k = 0; k < STACK; ++k) {
    nums[k] = 0;
    ops[k] = 0;
  }
  int i = 0, ns = 0, os = 0, err = ERR_OK;
  bool expect_operand = true;
  while (i < length && err == ERR_OK) {
    const int b = view_byte(v, i);
    if (b == SPACE) {
      ++i;
      continue;
    }
    if (b >= 48 && b <= 57) {  // a number: digits, and dots that defer
      int32_t val = 0;
      bool dot = false;
      int j = i;
      for (; j < length; ++j) {
        const int bj = view_byte(v, j);
        if (bj >= 48 && bj <= 57)
          val = wrap((int64_t)val * 10 + (bj - 48));
        else if (bj == DOT)
          dot = true;
        else
          break;
      }
      err = dot ? ERR_HOST
                : (!expect_operand ? ERR_ASSERT
                                   : (ns >= STACK ? ERR_HOST : err));
      nums[clip_stack(ns)] = val;
      ++ns;
      expect_operand = false;
      i = j;
      continue;
    }
    const bool pair = i + 1 < length;
    const int nxt = view_byte(v, i + 1);
    int code = 0, width = 1;
    if (b == 42 && nxt == 42 && pair) {
      code = OP_POW;
      width = 2;
    } else if (b == 47 && nxt == 47 && pair) {
      code = OP_FLOORDIV;
      width = 2;
    } else if (b == 43) {
      code = OP_ADD;
    } else if (b == 45) {
      code = OP_SUB;
    } else if (b == 42) {
      code = OP_MUL;
    } else if (b == 47) {
      code = OP_DIV;
    } else if (b == 37) {
      code = OP_MOD;
    }
    if (code == 0) {  // no digit, space or operator
      ++i;
      err = ERR_ASSERT;
      continue;
    }
    if (expect_operand) {  // unary: '+x' is x, '-x' pushes OP_NEG
      if (code != OP_ADD && code != OP_SUB) {
        err = ERR_ASSERT;
      } else if (code == OP_SUB) {
        if (os >= STACK) err = ERR_HOST;
        ops[clip_stack(os)] = OP_NEG;
        ++os;
      }
      i += width;
      continue;
    }
    // binary: reduce what binds at least as tightly (more tightly for the
    // right-associative '**'), then push
    const int prec = precedence(code);
    while (os > 0 && err == ERR_OK) {
      const int top = precedence(ops[clip_stack(os - 1)]);
      if (code == OP_POW ? top <= prec : top < prec) break;
      err = reduce_once(nums, ns, ops, os);
    }
    if (os >= STACK) err = ERR_HOST;
    ops[clip_stack(os)] = (uint8_t)code;
    ++os;
    i += width;
    expect_operand = true;
  }
  if (err == ERR_OK && expect_operand) err = ERR_ASSERT;
  while (os > 0 && err == ERR_OK) err = reduce_once(nums, ns, ops, os);
  if (err == ERR_OK && ns != 1) err = ERR_ASSERT;
  return MathResult{err, nums[0]};
}

// eval_flat on one row of n bytes.
__device__ MathResult eval_flat_row(const uint8_t* row, int n, int length) {
  return eval_flat_view(MathView{row, n, 0, n}, length);
}

// _eval_enum_minmax on one row: the comma-separated segments in turn.
__device__ MathResult eval_enum_row(const uint8_t* row, int n, int length,
                                    bool want_max) {
  int start = 0, err = ERR_OK;
  int32_t best = 0;
  bool any = false, done = false;
  const int limit = length < n ? length : n;
  while (!done && err == ERR_OK && start <= length) {
    int comma = -1;
    for (int p = start < 0 ? 0 : start; p < limit; ++p)
      if (row[p] == COMMA) {
        comma = p;
        break;
      }
    const int end = comma == -1 ? length : comma;
    const MathResult r =
        eval_flat_view(MathView{row, n, start, end - start}, end - start);
    err = r.err;
    best = !any ? r.value
                : (want_max ? (r.value > best ? r.value : best)
                            : (r.value < best ? r.value : best));
    any = true;
    done = comma == -1;
    start = end + 1;
  }
  if (!any) err = ERR_ASSERT;
  return MathResult{err, best};
}

#ifdef __CUDACC__
constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
    math_eval_kernel(const uint8_t* __restrict__ bufs,
                     const int* __restrict__ lengths,
                     const uint8_t* __restrict__ want_max, int n, int ms,
                     int* __restrict__ err, int* __restrict__ value) {
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r >= n) return;
  const uint8_t* row = bufs + r * ms;
  const MathResult res =
      want_max ? eval_enum_row(row, ms, lengths[r], want_max[r] != 0)
               : eval_flat_row(row, ms, lengths[r]);
  err[r] = res.err;
  value[r] = res.value;
}
#endif

}  // namespace

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success). A null
// `want_max` is the flat mode, else the enumeration mode.
extern "C" int math_eval_launch(const uint8_t* bufs, const int* lengths,
                                const uint8_t* want_max, int n, int ms,
                                int* err, int* value, void* stream) {
  if (n <= 0) return 0;
  if (ms < 0) return (int)cudaErrorInvalidValue;
  const long long grid = ((long long)n + BLOCK - 1) / BLOCK;
  math_eval_kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      bufs, lengths, want_max, n, ms, err, value);
  return (int)cudaGetLastError();
}
#endif
