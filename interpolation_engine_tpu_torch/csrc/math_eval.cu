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
// row; the work a byte is a few integer operations. The first design (one
// thread a row reading its row in place a byte at a time, both stacks in
// local memory, a 64-bit division on every reduction, an enumeration
// segment read twice) reached 1.2-1.7 % of that bound.
//
// Design. A block of ROWS = 128 threads takes 4 * rpw rows, one thread a
// row: rpw = 32 rows a warp, or fewer (the other lanes idle) for a call
// too small to give each of the card's schedulers four warps
// (stage::rows_a_warp), where the warps' serial chains are the time:
//   1. stage: the block's rows within their lengths go to shared memory in
//      coalesced 16-byte loads (csrc/stage_rows.cuh), rows an odd number of
//      words apart;
//   2. evaluate: each thread walks its row once, a word of it read from
//      shared memory at a time, with the classic two-stack (shunting-yard)
//      evaluation, reductions as an operator of lower precedence arrives.
//      The operand stack (16 int32) lives in shared memory, entry k of
//      thread t at word k * ROWS + t (no bank conflicts); the operator
//      stack is 16 four-bit codes in one 64-bit register. A reduction
//      computes only its own operator: 32-bit wrapping '+', '-', '*' and
//      negation as selects; '/', '//' and '%' in 32 bits, the floor from
//      the truncating quotient and remainder, a divisor of -1 as the
//      64-bit path wraps it (INT_MIN // -1 is INT_MIN, INT_MIN % -1 is 0);
//      '**' by squaring, which wrapped 32-bit multiplication (associative
//      modulo 2^32) makes equal to the repeated product, the clip at 31
//      included. Precedences and operator codes are nibbles of constants,
//      so no switch becomes a jump table (an indirect branch that a warp's
//      rows take to different targets one after another). A run of digits
//      is read from the kept word alone while it lies within the length
//      and the width. In the enumeration mode the walk that evaluates a
//      segment also finds its end (the first comma within the row's length
//      and width), so each byte is read once.
// What holds it is each thread's serial walk, branches a byte, and the 32
// rows of a warp, each at its own place in its own expression. The TPU
// program moved every row by one event per loop trip, in lockstep; that
// form (one loop, an event a step) measured slower here, and slower still
// with a warp vote a step to hold the rows together (PERF.md).
// Rows longer than stage::CAP bytes (wider configs) read their tail in
// place.
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the phase functions
// (`stage_block`, then after a barrier `eval_thread`): the CPU tests
// (tests/test_torch_math_tile.py) run them block by block.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "stage_rows.cuh"

namespace {

using stage::ROWS;
using stage::RowView;

constexpr int STACK = 16;
// Warps an SM a call should give (stage::rows_a_warp): four a scheduler,
// to overlap the walks' serial chains; at 4,096 rows on an H100 that is
// one row a warp, 1.2-1.5x faster than one warp a scheduler.
constexpr int WARPS_AN_SM = 16;
constexpr int ERR_OK = 0, ERR_ASSERT = 2, ERR_HOST = 4;
constexpr int OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4, OP_MOD = 5,
              OP_POW = 6, OP_FLOORDIV = 7, OP_NEG = 8;
constexpr int COMMA = 44, DOT = 46, SPACE = 32;

struct MathResult {
  int err;
  int32_t value;
};

struct MathArgs {
  const uint8_t* bufs;
  const int* lengths;
  const uint8_t* want_max;  // null: the flat mode
  int n, ms;
  int rpw;  // rows a warp (stage::rows_a_warp); a block takes 4 * rpw
  int* err;
  int* value;
};

// A block's shared memory: the rows, then the operand stacks, in bytes.
struct MathLayout {
  int cap, stride, nums, bytes;
};

__host__ __device__ inline MathLayout math_layout(int ms) {
  MathLayout l;
  l.cap = stage::row_cap(ms);
  l.stride = stage::row_stride(l.cap);
  l.nums = ROWS * l.stride;
  l.bytes = l.nums + STACK * ROWS * 4;
  return l;
}

__device__ __forceinline__ int clip_stack(int i) {
  return i < 0 ? 0 : (i >= STACK ? STACK - 1 : i);
}

// A thread's operand stack: entry k at p[k * ROWS] in shared memory.
struct Operands {
  int32_t* p;
  __device__ __forceinline__ int32_t& operator[](int k) const {
    return p[k * ROWS];
  }
};

// A thread's operator stack: entry k in bits 4k..4k+3.
struct Operators {
  uint64_t bits;
  __device__ __forceinline__ int get(int k) const {
    return (int)(bits >> (4 * k)) & 15;
  }
  __device__ __forceinline__ void set(int k, int op) {
    bits = (bits & ~(15ull << (4 * k))) | ((uint64_t)op << (4 * k));
  }
};

// An operator's precedence, a nibble of one constant (no jump table):
// '+' '-' 1; '*' '/' '%' '//' 2; unary '-' 3; '**' 4; none 0.
__device__ __forceinline__ int precedence(int op) {
  return (int)(0x324222110ull >> (4 * op)) & 15;
}

// Apply the top operator to the top operands; the result replaces them
// (stack indices clamped as the JAX gathers clamp them). Returns the error.
__device__ int reduce_once(Operands nums, int& ns, Operators& ops, int& os) {
  const int op = ops.get(clip_stack(os - 1));
  const bool unary = op == OP_NEG;
  const int32_t b = nums[clip_stack(ns - 1)];
  const int32_t a = unary ? 0 : nums[clip_stack(ns - 2)];
  const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
  // '+', '-', '*' and negation are selects; only the dividing operators
  // divide and only '**' multiplies in a loop
  uint32_t val = op == OP_ADD ? ua + ub
               : op == OP_SUB ? ua - ub
               : op == OP_MUL ? ua * ub
               : op == OP_NEG ? 0u - ub : 0u;
  int err = ERR_OK;
  if (op == OP_DIV || op == OP_FLOORDIV || op == OP_MOD) {
    const int32_t d = b == 0 ? 1 : b;
    int32_t q, r;
    if (d == -1) {  // a / -1 overflows int32 only at INT_MIN: it wraps
      q = (int32_t)(0u - ua);
      r = 0;
    } else {
      q = a / d;
      r = a % d;
      if (r != 0 && ((r < 0) != (d < 0))) {  // floor, the divisor's sign
        r += d;
        q -= 1;
      }
    }
    val = (uint32_t)(op == OP_MOD ? r : q);
    if (op == OP_DIV && r != 0)
      err = ERR_HOST;
    else if (b == 0)
      err = ERR_ASSERT;
  } else if (op == OP_POW) {
    uint32_t acc = 1, base = ua;
    for (int e = b < 0 ? 0 : (b > 31 ? 31 : b); e; e >>= 1) {
      if (e & 1) acc *= base;
      base *= base;
    }
    val = acc;
    if (b < 0) err = ERR_HOST;
  }
  if (!unary) ns -= 1;
  nums[clip_stack(ns - 1)] = (int32_t)val;
  os -= 1;
  return err;
}

// The walk over one row: the byte at row position P as an expression
// segment starting at `start` reads it (the flat mode is the one segment at
// 0): byte P within the width; past it byte MS - 1 for the segment at 0, as
// a clamped gather reads it, else zero. The word that holds it is kept.
struct Walk {
  RowView v;
  int length;
  bool commas;  // the enumeration mode: a comma ends a segment
  int start;
  int word;     // the index of the kept word, or -1
  uint32_t w;
};

__device__ __forceinline__ int walk_byte(Walk& k, int P) {
  const int n = k.v.width;
  const int q = P < n ? P : (k.start == 0 ? n - 1 : -1);
  if (q < 0) return 0;
  if ((q >> 2) != k.word) {
    k.word = q >> 2;
    k.w = stage::word_at(k.v, q & ~3);
  }
  return (int)(k.w >> (8 * (q & 3))) & 0xff;
}

// P (holding byte b) ends the segment: the row's length, or in the
// enumeration mode a comma within the length and the width. (Past the
// width the first segment reads byte MS - 1, which cannot be a comma
// there: the walk would have stopped at it.)
__device__ __forceinline__ bool walk_end(const Walk& k, int P, int b) {
  return P >= k.length || (k.commas && b == COMMA);
}

__device__ __forceinline__ bool is_digit(int b) { return b >= 48 && b <= 57; }

// One paren-free expression: the segment from P to its end, where P is
// left (when it ends without an error).
__device__ MathResult eval_segment(Walk& k, Operands nums, int& P) {
  Operators ops{0};
  nums[0] = 0;  // the value of an expression that pushes nothing
  int ns = 0, os = 0, err = ERR_OK;
  bool expect_operand = true;
  while (err == ERR_OK) {
    const int b = walk_byte(k, P);
    if (walk_end(k, P, b)) break;
    if (b == SPACE) {
      ++P;
      continue;
    }
    if (is_digit(b)) {  // a number: digits, and dots that defer
      uint32_t val = 0;
      bool dot = false;
      // within the length and the width the bytes come from the kept
      // word alone (a comma ends the run as any byte but a digit or a
      // dot does); past the width, through walk_byte's clamp
      const int lim = k.length < k.v.width ? k.length : k.v.width;
      for (; P < lim; ++P) {
        if ((P >> 2) != k.word) {
          k.word = P >> 2;
          k.w = stage::word_at(k.v, P & ~3);
        }
        const int bj = (int)(k.w >> (8 * (P & 3))) & 0xff;
        if (is_digit(bj))
          val = val * 10u + (uint32_t)(bj - 48);
        else if (bj == DOT)
          dot = true;
        else
          break;
      }
      for (; P >= lim; ++P) {
        const int bj = walk_byte(k, P);
        if (walk_end(k, P, bj)) break;
        if (is_digit(bj))
          val = val * 10u + (uint32_t)(bj - 48);
        else if (bj == DOT)
          dot = true;
        else
          break;
      }
      err = dot ? ERR_HOST
                : (!expect_operand ? ERR_ASSERT
                                   : (ns >= STACK ? ERR_HOST : err));
      nums[clip_stack(ns)] = (int32_t)val;
      ++ns;
      expect_operand = false;
      continue;
    }
    const int nxt = walk_byte(k, P + 1);
    const bool pair = !walk_end(k, P + 1, nxt);
    // the operator of byte b, a nibble of one constant for b in '%'..'/'
    // ('%' MOD, '*' MUL, '+' ADD, '-' SUB, '/' DIV), no branch ladder; a
    // doubled '*' or '/' is '**' or '//'
    int code = b >= 37 && b <= 47
                   ? (int)(0x40201300005ull >> (4 * (b - 37))) & 15
                   : 0;
    const bool doubled = nxt == b && pair && (code == OP_MUL ||
                                              code == OP_DIV);
    if (doubled) code = code == OP_MUL ? OP_POW : OP_FLOORDIV;
    const int width = doubled ? 2 : 1;
    if (code == 0) {  // no digit, space or operator
      ++P;
      err = ERR_ASSERT;
      continue;
    }
    if (expect_operand) {  // unary: '+x' is x, '-x' pushes OP_NEG
      if (code != OP_ADD && code != OP_SUB) {
        err = ERR_ASSERT;
      } else if (code == OP_SUB) {
        if (os >= STACK) err = ERR_HOST;
        ops.set(clip_stack(os), OP_NEG);
        ++os;
      }
      P += width;
      continue;
    }
    // binary: reduce what binds at least as tightly (more tightly for the
    // right-associative '**'), then push
    const int prec = precedence(code);
    while (os > 0 && err == ERR_OK) {
      const int top = precedence(ops.get(clip_stack(os - 1)));
      if (code == OP_POW ? top <= prec : top < prec) break;
      err = reduce_once(nums, ns, ops, os);
    }
    if (os >= STACK) err = ERR_HOST;
    ops.set(clip_stack(os), code);
    ++os;
    P += width;
    expect_operand = true;
  }
  if (err == ERR_OK && expect_operand) err = ERR_ASSERT;
  while (os > 0 && err == ERR_OK) err = reduce_once(nums, ns, ops, os);
  if (err == ERR_OK && ns != 1) err = ERR_ASSERT;
  return MathResult{err, nums[0]};
}

// One row: the flat mode (want_max < 0), or min (0) or max (1) over its
// comma-separated segments in turn, stopping at the first that errs.
__device__ MathResult eval_row(const RowView& v, int length, int want_max,
                               Operands nums) {
  Walk k{v, length, want_max >= 0, 0, -1, 0};
  int P = 0;
  if (want_max < 0) return eval_segment(k, nums, P);
  int err = ERR_OK;
  int32_t best = 0;
  bool any = false;
  while (err == ERR_OK && P <= length) {
    k.start = P;
    const MathResult r = eval_segment(k, nums, P);
    err = r.err;
    best = !any ? r.value
                : (want_max ? (r.value > best ? r.value : best)
                            : (r.value < best ? r.value : best));
    any = true;
    if (P >= length) break;  // no comma: that was the last segment
    ++P;                     // past the comma
  }
  if (!any) err = ERR_ASSERT;
  return MathResult{err, best};
}

// Phase 1, block-wide (thread t of nt): block b's rows into shared memory.
__device__ __forceinline__ void stage_block(const MathArgs& a,
                                            const MathLayout& l, int b,
                                            int t, int nt, uint8_t* sm) {
  const long long r0 = (long long)b * 4 * a.rpw;
  const int rows = a.n - r0 < 4 * a.rpw ? (int)(a.n - r0) : 4 * a.rpw;
  stage::stage_rows(sm, l.stride, l.cap,
                    stage::Tile{a.bufs + r0 * a.ms, a.lengths + r0, a.ms,
                                rows, a.ms},
                    t, nt);
}

// Phase 2, per thread: the row of thread t of block b (none for an idle
// lane).
__device__ __forceinline__ void eval_thread(const MathArgs& a,
                                            const MathLayout& l, int b,
                                            int t, uint8_t* sm) {
  const int i = stage::tile_row(t, a.rpw);
  const long long r = (long long)b * 4 * a.rpw + i;
  if (i < 0 || r >= a.n) return;
  const RowView v{sm + i * l.stride, a.bufs + r * a.ms, l.cap, a.ms};
  const MathResult res =
      eval_row(v, a.lengths[r], a.want_max ? a.want_max[r] != 0 : -1,
               Operands{reinterpret_cast<int32_t*>(sm + l.nums) + t});
  a.err[r] = res.err;
  a.value[r] = res.value;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(ROWS)
    math_eval_kernel(const MathArgs a, const MathLayout l) {
  extern __shared__ __align__(16) uint8_t sm[];
  stage_block(a, l, blockIdx.x, threadIdx.x, ROWS, sm);
  __syncthreads();
  eval_thread(a, l, blockIdx.x, threadIdx.x, sm);
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
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int rpw = stage::rows_a_warp(n, sms, WARPS_AN_SM);
  // at most 41,472 shared bytes a block (rows staged to stage::CAP): no
  // opt-in past 48 KB
  const MathArgs a{bufs, lengths, want_max, n, ms, rpw, err, value};
  const MathLayout l = math_layout(ms);
  const long long grid = ((long long)n + 4 * rpw - 1) / (4 * rpw);
  math_eval_kernel<<<(unsigned)grid, ROWS, l.bytes, (cudaStream_t)stream>>>(
      a, l);
  return (int)cudaGetLastError();
}

// The kernel's registers, local (stack) bytes and the dynamic shared bytes
// a block at ms: out4.
extern "C" int math_eval_attributes(int ms, int* out4) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, math_eval_kernel);
  if (e != cudaSuccess) return (int)e;
  out4[0] = fa.numRegs;
  out4[1] = (int)fa.localSizeBytes;
  out4[2] = math_layout(ms).bytes;
  out4[3] = ROWS;
  return 0;
}
#endif
