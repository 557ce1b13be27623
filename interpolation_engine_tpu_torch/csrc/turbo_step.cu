// Turbo VM step kernel for Hopper (sm_90a): up to K VM steps per instance.
//
// Replaces the TPU mega-kernel of interpolation_engine_tpu/vm/turbo.py,
// build_step_fn's inner `kernel` (:1879, pl.pallas_call at :1960), for the
// scalar instructions: the branches of _build_branch at :1037-1340 and the
// helpers _int_to_dec, _parse_dec, _has_brace_or_escape (:483-544) and
// _render, _match, _eval_item, _eval_rpn, _advance (:744-1027). The list
// branches, the dynamic for head and the parallel thread lanes are not here
// yet; a plan that holds them never reaches this kernel (NotPorted).
//
// Design. The TPU kernel was specialised per program at trace time and ran
// every branch over a tile of lanes, with min-pc scheduling and a cond tree
// because Mosaic has no per-lane control flow. Here the program is data
// (vm/turbo_tables.py: one int32 buffer, one uint8 literal table) and one
// thread runs one instance with its own pc: it reads the opcode at its pc,
// switches on it and stops at DONE, PARKED or after K steps. A template
// renders into a per-thread buffer of W bytes; nothing else is staged.
//
// What bounds it on this card: memory traffic on the per-instance rows
// (a 128-int register row, the string rows, the output row), with almost
// no arithmetic. The first design does nothing about that yet: each thread
// walks its own rows, so neighbouring threads touch addresses a row apart
// and every access is uncoalesced. That is the first thing a later
// performance PR should look at (a transposed or shared-memory-staged
// layout, the program tables in shared memory).
//
// Semantics are those of ops/turbo_step.py turbo_step_reference, bit for
// bit after every launch: ints wrap at 32 bits (computed in 64 bits and
// truncated, since signed overflow is undefined in C++), `//` and `%` are
// Python's floor division and modulo, and a lane parks wherever the TPU
// kernel parks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUNNING = 0, DONE = 1, PARKED = 2;
constexpr int C_PC = 0, C_STATUS = 1, C_STEPS = 2, C_OUTLEN = 3;
constexpr int C_CLREPOCH = 8;
constexpr int T_EMPTY = 0, T_INT = 1, T_STR = 2, T_LIST = 3;

constexpr int MAX_W = 512;       // per-thread render buffer
constexpr int MAX_STACK = 16;    // vm/turbo_tables.py RPN_MAX_STACK
constexpr int HEADER = 16;       // vm/turbo_tables.py HEADER

enum Op {
  OP_HALT, OP_NOP, OP_GOTO, OP_PARK, OP_CLEAR, OP_DELETE, OP_SET, OP_MATH,
  OP_PRINT, OP_GOTOMAP, OP_GOTOMAP_INT, OP_FORHEAD, OP_FORNEXT
};
enum Src { SRC_INT, SRC_STR, SRC_COPY, SRC_TMPL };
enum Seg { SEG_LIT, SEG_HOLE };
enum Pat { PAT_ANY, PAT_EXACT, PAT_PREFIX, PAT_SUFFIX, PAT_AFFIX };
enum Elem { ELEM_INT, ELEM_STR };
enum Kind { KIND_NONE, KIND_INT, KIND_STR, KIND_MIX };
enum Rpn {
  RPN_CONST, RPN_SLOT, RPN_LENGTH, RPN_NEG, RPN_SIGN, RPN_ADD, RPN_SUB,
  RPN_MUL, RPN_MIN2, RPN_MAX2, RPN_DIV, RPN_MOD
};

// The program tables, carved out of the flat buffer by its header.
struct Prog {
  const int* ins;      // (P, 8)
  const int* segs;     // (G, 2)
  const int* ents;     // (E, 4)
  const int* rpn;      // (Q, 2)
  const int* dels;     // (D,)
  const int* pairs;    // (F, 2)
  const int* elems;    // (X, 2)
  const int* slots;    // (S, 5): kind, stype col, sint col, slen col, row
  const int* lit_len;  // (L,)
  const uint8_t* lits; // (L, W)
  int P;
  int W;
};

// One instance's state: its register row, its string rows, its output row.
struct Lane {
  int* regs;
  uint8_t* sbuf;       // row 0 of this instance; row r is r * rstride on
  size_t rstride;
  uint8_t* out;
  __device__ uint8_t* row(int r) const { return sbuf + (size_t)r * rstride; }
};

__device__ __forceinline__ int wrap32(long long v) {
  return (int)(unsigned int)(unsigned long long)v;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// Python str(int) of an int32, INT32_MIN included. Returns the length.
__device__ int int_to_dec(int v, uint8_t* d) {
  unsigned int mag = v < 0 ? ~(unsigned int)v + 1u : (unsigned int)v;
  uint8_t rev[10];
  int nd = 0;
  do {
    rev[nd++] = (uint8_t)('0' + mag % 10u);
    mag /= 10u;
  } while (mag);
  int o = 0;
  if (v < 0) d[o++] = '-';
  while (nd) d[o++] = rev[--nd];
  return o;
}

// Optionally signed decimal of at most 9 digits; anything else is not ok.
__device__ bool parse_dec(const uint8_t* b, int ln, int* out) {
  int start = (ln > 0 && (b[0] == '-' || b[0] == '+')) ? 1 : 0;
  int ndig = ln - start;
  if (ndig <= 0 || ndig > 9) return false;
  int val = 0;
  for (int j = start; j < ln; ++j) {
    if (b[j] < '0' || b[j] > '9') return false;
    val = val * 10 + (b[j] - '0');
  }
  *out = (start && b[0] == '-') ? -val : val;
  return true;
}

__device__ bool brace_or_escape(const uint8_t* b, int n) {
  for (int j = 0; j < n; ++j)
    if (b[j] == '{' || b[j] == '}' || b[j] == '\\') return true;
  return false;
}

// Append n bytes of src at offset *ln, keeping what fits in W.
__device__ void put(uint8_t* buf, int W, int* ln, const uint8_t* src, int n) {
  int lim = min(n, W - *ln);
  for (int j = 0; j < lim; ++j) buf[*ln + j] = src[j];
  *ln += n;
}

__device__ void copy_row(uint8_t* dst, const uint8_t* src, int W) {
  if ((W & 15) == 0 && (((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int j = 0; j < W / 16; ++j) d[j] = s[j];
  } else {
    for (int j = 0; j < W; ++j) dst[j] = src[j];
  }
}

// Render a template into buf (zero past the result). Sets *missing when a
// hole's slot is empty and *park when a hole value carries a brace or an
// escape, or the result is longer than W. Returns min(length, W).
__device__ int render(const Prog& g, const Lane& L, int seg0, int nseg,
                      uint8_t* buf, bool* missing, bool* park) {
  const int W = g.W;
  int ln = 0;
  for (int k = 0; k < nseg; ++k) {
    const int* seg = g.segs + 2 * (seg0 + k);
    if (seg[0] == SEG_LIT) {
      put(buf, W, &ln, g.lits + (size_t)seg[1] * W, g.lit_len[seg[1]]);
      continue;
    }
    const int* s = g.slots + 5 * seg[1];
    int st = L.regs[s[1]];
    if (st == T_EMPTY) *missing = true;
    if (s[0] == KIND_INT || (s[0] == KIND_MIX && st == T_INT)) {
      uint8_t d[11];
      put(buf, W, &ln, d, int_to_dec(L.regs[s[2]], d));
    } else if ((s[0] == KIND_STR || s[0] == KIND_MIX) && st == T_STR) {
      const uint8_t* r = L.row(s[4]);
      int n = L.regs[s[3]];
      if (brace_or_escape(r, min(n, W))) *park = true;
      put(buf, W, &ln, r, n);
    }
  }
  for (int q = min(ln, W); q < W; ++q) buf[q] = 0;
  if (ln > W) {
    *park = true;
    ln = W;
  }
  return ln;
}

__device__ bool bytes_eq(const uint8_t* a, const uint8_t* b, int n) {
  for (int j = 0; j < n; ++j)
    if (a[j] != b[j]) return false;
  return true;
}

// Anchored match of one decomposed pattern against buf[:ln].
__device__ bool match_at(const Prog& g, const int* e, const uint8_t* buf,
                         int ln) {
  const uint8_t* a = g.lits + (size_t)e[1] * g.W;
  int al = g.lit_len[e[1]];
  switch (e[0]) {
    case PAT_ANY: return true;
    case PAT_EXACT: return ln == al && bytes_eq(buf, a, al);
    case PAT_PREFIX: return ln >= al && bytes_eq(buf, a, al);
    case PAT_SUFFIX: return ln >= al && bytes_eq(buf + ln - al, a, al);
    default: {
      const uint8_t* b = g.lits + (size_t)e[2] * g.W;
      int bl = g.lit_len[e[2]];
      return ln >= al + bl && bytes_eq(buf, a, al) &&
             bytes_eq(buf + ln - bl, b, bl);
    }
  }
}

// The reference's end anchor also matches before one trailing newline.
__device__ bool match(const Prog& g, const int* e, const uint8_t* buf,
                      int ln) {
  if (match_at(g, e, buf, ln)) return true;
  if (e[0] == PAT_ANY || e[0] == PAT_PREFIX) return false;
  return ln > 0 && buf[ln - 1] == '\n' && match_at(g, e, buf, ln - 1);
}

// Evaluate an RPN program; *park when an operand is missing, not an int or
// a clean decimal, or a division is inexact or by zero.
__device__ int eval_rpn(const Prog& g, const Lane& L, int q0, int nq,
                        bool* park) {
  int st[MAX_STACK];
  int sp = 0;
  for (int k = 0; k < nq; ++k) {
    const int* o = g.rpn + 2 * (q0 + k);
    switch (o[0]) {
      case RPN_CONST: st[sp++] = o[1]; break;
      case RPN_SLOT: {
        const int* s = g.slots + 5 * o[1];
        int t = L.regs[s[1]];
        int v = L.regs[s[2]];
        if (s[4] >= 0) {
          if (t == T_STR) {
            if (!parse_dec(L.row(s[4]), L.regs[s[3]], &v)) *park = true;
          } else if (t != T_INT) {
            *park = true;
          }
        } else if (t != T_INT) {
          *park = true;
        }
        st[sp++] = v;
        break;
      }
      case RPN_LENGTH: {
        const int* s = g.slots + 5 * o[1];
        if (L.regs[s[1]] != T_LIST) *park = true;
        st[sp++] = L.regs[s[3]];
        break;
      }
      case RPN_NEG: st[sp - 1] = wrap32(-(long long)st[sp - 1]); break;
      case RPN_SIGN: st[sp - 1] = (st[sp - 1] > 0) - (st[sp - 1] < 0); break;
      default: {
        long long b = st[--sp];
        long long a = st[sp - 1];
        long long r;
        switch (o[0]) {
          case RPN_ADD: r = a + b; break;
          case RPN_SUB: r = a - b; break;
          case RPN_MUL: r = a * b; break;
          case RPN_MIN2: r = a < b ? a : b; break;
          case RPN_MAX2: r = a > b ? a : b; break;
          default: {
            long long safe = b == 0 ? 1 : b;
            long long q = floor_div(a, safe);
            long long m = a - q * safe;
            if (o[0] == RPN_DIV) {
              if (b == 0 || m != 0) *park = true;
              r = q;
            } else {
              if (b == 0) *park = true;
              r = m;
            }
          }
        }
        st[sp - 1] = wrap32(r);
      }
    }
  }
  return st[sp - 1];
}

__device__ __forceinline__ void advance(const Lane& L, bool park,
                                        int next_pc) {
  if (park) L.regs[C_STATUS] = PARKED;
  else L.regs[C_PC] = next_pc;
  L.regs[C_STEPS] += 1;
}

// One VM step of one lane at pc.
__device__ void step(const Prog& g, const Lane& L, int pc, uint8_t* buf,
                     int OW) {
  const int* in = g.ins + 8 * pc;
  const int a = in[1], b = in[2], c = in[3], d = in[4], e = in[5];
  switch (in[0]) {
    case OP_HALT:
      L.regs[C_STATUS] = DONE;
      return;
    case OP_NOP:
      advance(L, false, pc + 1);
      return;
    case OP_GOTO:
      advance(L, false, a);
      return;
    case OP_PARK:
      // a literal-name await_insert whose key is present does not yield
      if (a >= 0 && L.regs[g.slots[5 * a + 1]] != T_EMPTY)
        advance(L, false, pc + 1);
      else
        L.regs[C_STATUS] = PARKED;
      return;
    case OP_CLEAR:
      L.regs[C_CLREPOCH] += 1;
      for (int j = 0; j < OW; ++j) L.out[j] = 0;
      L.regs[C_OUTLEN] = 0;
      advance(L, false, pc + 1);
      return;
    case OP_DELETE:
      for (int k = 0; k < b; ++k)
        L.regs[g.slots[5 * g.dels[a + k] + 1]] = T_EMPTY;
      advance(L, false, pc + 1);
      return;
    case OP_SET: {
      const int* out = g.slots + 5 * a;
      bool park = false, missing = false;
      int vt = T_STR, vi = 0, vln = 0;
      const uint8_t* vbuf = nullptr;
      if (b == SRC_INT) {
        vt = T_INT;
        vi = c;
      } else if (b == SRC_STR) {
        vbuf = g.lits + (size_t)c * g.W;
        vln = g.lit_len[c];
      } else if (b == SRC_COPY) {
        const int* s = g.slots + 5 * c;
        vt = L.regs[s[1]];
        vi = L.regs[s[2]];
        park = vt == T_EMPTY;
        if (s[4] >= 0) {
          vbuf = L.row(s[4]);
          vln = L.regs[s[3]];
        }
      } else {
        vln = render(g, L, c, d, buf, &missing, &park);
        vbuf = buf;
        park = park || missing;
      }
      if (!park) {
        L.regs[out[1]] = vt;
        L.regs[out[2]] = vi;
        L.regs[out[3]] = vln;
        if (vbuf != nullptr && out[4] >= 0 && L.row(out[4]) != vbuf)
          copy_row(L.row(out[4]), vbuf, g.W);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_MATH: {
      bool park = false;
      int v = eval_rpn(g, L, b, c, &park);
      if (!park) {
        const int* out = g.slots + 5 * a;
        L.regs[out[1]] = T_INT;
        L.regs[out[2]] = v;
        L.regs[out[3]] = 0;
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_PRINT: {
      bool park = false, missing = false;
      int n = render(g, L, a, b, buf, &missing, &park);
      // print of a non-string simple key raises on the host
      if (c >= 0 && L.regs[g.slots[5 * c + 1]] != T_STR) park = true;
      int ol = L.regs[C_OUTLEN];
      park = park || missing || ol + n > OW;
      if (!park) {
        for (int j = 0; j < n; ++j) L.out[ol + j] = buf[j];
        L.regs[C_OUTLEN] = ol + n;
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_GOTOMAP:
    case OP_GOTOMAP_INT: {
      bool park = false, missing = false, decided = false;
      int tgt = 0;
      if (in[0] == OP_GOTOMAP) {
        int ln = render(g, L, a, b, buf, &missing, &park);
        for (int k = 0; k < d && !decided; ++k) {
          const int* ent = g.ents + 4 * (c + k);
          if (match(g, ent, buf, ln)) {
            tgt = ent[3];
            decided = true;
          }
        }
      } else {
        const int* s = g.slots + 5 * a;
        missing = L.regs[s[1]] == T_EMPTY;
        int v = L.regs[s[2]];
        for (int k = 0; k < d && !decided; ++k) {
          const int* ent = g.ents + 4 * (c + k);
          if (ent[0] == PAT_ANY || ent[1] == v) {
            tgt = ent[3];
            decided = true;
          }
        }
      }
      bool routed;
      if (e >= 0) {
        if (missing) tgt = e;
        routed = missing || decided;
      } else {
        routed = decided && !missing;
      }
      advance(L, park || !routed, tgt);
      return;
    }
    case OP_FORHEAD: {
      int counter = L.regs[a];
      int cur = counter == 0 ? 1 : counter;
      if (cur > b) {
        // exit: loop variables keep the last iteration's values
        L.regs[a] = 0;
        advance(L, false, c);
        return;
      }
      L.regs[a] = cur;
      int k = cur - 1;
      if (k >= 0) {
        for (int p = 0; p < e; ++p) {
          const int* pr = g.pairs + 2 * (d + p);
          const int* s = g.slots + 5 * pr[0];
          const int* el = g.elems + 2 * (pr[1] + k);
          if (el[0] == ELEM_INT) {
            L.regs[s[1]] = T_INT;
            L.regs[s[2]] = el[1];
            L.regs[s[3]] = 0;
          } else {
            L.regs[s[1]] = T_STR;
            L.regs[s[2]] = 0;
            L.regs[s[3]] = g.lit_len[el[1]];
            if (s[4] >= 0)
              copy_row(L.row(s[4]), g.lits + (size_t)el[1] * g.W, g.W);
          }
        }
      }
      advance(L, false, pc + 1);
      return;
    }
    case OP_FORNEXT:
      L.regs[a] += 1;
      advance(L, false, b);
      return;
  }
}

__global__ void turbo_step_kernel(const int* __restrict__ flat,
                                  const uint8_t* __restrict__ lits,
                                  int* regs, uint8_t* sbuf, uint8_t* out,
                                  int n, int regw, int W, int OW, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Prog g;
  g.P = flat[0];
  g.ins = flat + flat[3];
  g.segs = flat + flat[4];
  g.ents = flat + flat[5];
  g.rpn = flat + flat[6];
  g.dels = flat + flat[7];
  g.pairs = flat + flat[8];
  g.elems = flat + flat[9];
  g.slots = flat + flat[10];
  g.lit_len = flat + flat[11];
  g.lits = lits;
  g.W = W;
  Lane L{regs + (size_t)i * regw, sbuf + (size_t)i * W, (size_t)n * W,
         out + (size_t)i * OW};
  uint8_t buf[MAX_W];
  for (int k = 0; k < K; ++k) {
    if (L.regs[C_STATUS] != RUNNING) break;
    int pc = L.regs[C_PC];
    if (pc < 0 || pc >= g.P) break;
    step(g, L, pc, buf, OW);
  }
}

}  // namespace

static_assert(HEADER == 16, "flat header size");

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int turbo_step_launch(const int* flat, const uint8_t* lits,
                                 int* regs, uint8_t* sbuf, uint8_t* out,
                                 int n, int regw, int width, int out_width,
                                 int k_steps, int block, void* stream) {
  if (n <= 0 || k_steps <= 0) return 0;
  if (width <= 0 || width > MAX_W || block <= 0 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + block - 1) / block;
  turbo_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      flat, lits, regs, sbuf, out, n, regw, width, out_width, k_steps);
  return (int)cudaGetLastError();
}

extern "C" const char* turbo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
