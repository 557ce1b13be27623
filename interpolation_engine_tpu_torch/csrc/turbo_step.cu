// Turbo VM step kernel for Hopper (sm_90a): up to K VM steps per instance.
//
// Replaces the TPU mega-kernel of interpolation_engine_tpu/vm/turbo.py,
// build_step_fn's inner `kernel` (:1879, pl.pallas_call at :1960), whole:
// every branch of _build_branch (:1037-1811: scalar, list, dynamic for and
// parallel thread-lane instructions), the lane yield _lane_yield
// (:1827-1859) and their helpers (_int_to_dec, _parse_dec,
// _has_brace_or_escape, the list-pool helpers, _repr_list, _join_elems,
// _render, _match, _eval_item, _eval_rpn, _advance: :483-1027).
//
// Design. The TPU kernel was specialised per program at trace time and ran
// every branch over a tile of lanes, with min-pc scheduling and a cond tree
// because Mosaic has no per-lane control flow. Here the program is data
// (vm/turbo_tables.py: one int32 buffer, one uint8 literal table) and one
// thread runs one instance with its own pc: it reads the opcode at its pc,
// switches on it and stops at DONE, PARKED or after K steps. A template
// renders into a per-thread buffer of W bytes; a list join appends its three
// templates and the elements into that one buffer. Thread lanes of a
// parallel block are per-instance registers (cur_tid and the tpc, tstate,
// tparg columns), so switching lanes is a register write, not a warp
// change. A list literal stages its elements in a per-instance scratch row
// (its items may read the list they replace); every other list write goes
// in place, in an order that reads each source cell before it is written.
//
// What bounds it on this card: memory traffic on the per-instance rows
// (a 128-int register row, the string and element rows, the output row,
// the meta plane), with almost no arithmetic. The first design does
// nothing about that yet: each thread walks its own rows, so neighbouring
// threads touch addresses a row apart and every access is uncoalesced.
// That is the first thing a later performance PR should look at (a
// transposed or shared-memory-staged layout, the program tables in shared
// memory).
//
// Semantics are those of ops/turbo_step.py turbo_step_reference, bit for
// bit after every launch: ints wrap at 32 bits (computed in 64 bits and
// truncated, since signed overflow is undefined in C++), `//` and `%` are
// Python's floor division and modulo, a lane parks wherever the TPU kernel
// parks, and a list write leaves the cells past the count zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUNNING = 0, DONE = 1, PARKED = 2;
constexpr int C_PC = 0, C_STATUS = 1, C_STEPS = 2, C_OUTLEN = 3;
constexpr int C_CURTID = 4, C_PARMODE = 5, C_PARJOIN = 6, C_PAREPOCH = 7;
constexpr int C_CLREPOCH = 8, C_BASE = 9;
constexpr int T_EMPTY = 0, T_INT = 1, T_STR = 2, T_LIST = 3;
// thread-lane states and parallel-block modes (vm/config.py)
constexpr int T_FREE = 0, T_NEW = 1, T_READY = 2, T_WAIT = 3, T_DONE = 4;
constexpr int PM_NONE = 0, PM_WAIT = 1, PM_DRAIN = 3;

constexpr int MAX_W = 512;       // per-thread render buffer
constexpr int MAX_STACK = 16;    // vm/turbo_tables.py RPN_MAX_STACK
constexpr int HEADER = 32;       // vm/turbo_tables.py HEADER
constexpr int OFF0 = 8;          // vm/turbo_tables.py _OFF0
constexpr int SLOTW = 8;         // columns of the slots table

enum Op {
  OP_HALT, OP_NOP, OP_GOTO, OP_PARK, OP_CLEAR, OP_DELETE, OP_SET, OP_MATH,
  OP_PRINT, OP_GOTOMAP, OP_GOTOMAP_INT, OP_FORHEAD, OP_FORNEXT, OP_SETLIST,
  OP_LISTNEW, OP_LISTAPPEND, OP_LISTREMOVE, OP_LISTINDEX, OP_LISTSLICE,
  OP_LISTJOIN, OP_LISTCONCAT, OP_FORHEADDYN, OP_PARBEGIN, OP_THREADEND
};
enum Src { SRC_INT, SRC_STR, SRC_COPY, SRC_TMPL };
enum Idx { IDX_CONST, IDX_COPY, IDX_TMPL };
enum Seg { SEG_LIT, SEG_HOLE };
enum Pat { PAT_ANY, PAT_EXACT, PAT_PREFIX, PAT_SUFFIX, PAT_AFFIX };
enum Elem { ELEM_INT, ELEM_STR };
enum Kind { KIND_NONE, KIND_INT, KIND_STR, KIND_MIX, KIND_LIST };
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
  const int* ints;     // (D,)
  const int* pairs;    // (F, 2)
  const int* elems;    // (X, 2)
  const int* slots;    // (S, 8): kind, stype col, sint col, slen col, row,
                       //         list plane, first element row, elem kind
  const int* lit_len;  // (L,)
  const int* items;    // (I, 3)
  const int* dpairs;   // (Y, 2)
  const uint8_t* lits; // (L, W)
  int P;
  int W;
  int E;               // elements per list
  int ew;              // bytes per element
  int pack;            // elements per byte row
  int nt;              // thread lanes
};

// One instance's state: its register row, its string and element rows, its
// output row, its list meta planes and its scratch row.
struct Lane {
  int* regs;
  uint8_t* sbuf;       // row 0 of this instance; row r is r * rstride on
  size_t rstride;
  uint8_t* out;
  int* meta;           // plane 0 of this instance; plane p is p * mstride on
  size_t mstride;
  uint8_t* scratch;
  __device__ uint8_t* row(int r) const { return sbuf + (size_t)r * rstride; }
};

__device__ __forceinline__ const int* slot(const Prog& g, int s) {
  return g.slots + SLOTW * s;
}

// meta plane of list slot s: [0,E) etype, [E,2E) eint, [2E,3E) elen
__device__ __forceinline__ int* plane(const Lane& L, const int* s) {
  return L.meta + (size_t)s[5] * L.mstride;
}

// the ew bytes of element e of list slot s
__device__ __forceinline__ uint8_t* cell(const Prog& g, const Lane& L,
                                         const int* s, int e) {
  return L.row(s[6] + e / g.pack) + (e % g.pack) * g.ew;
}

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

__device__ void put_str(uint8_t* buf, int W, int* ln, const char* s) {
  while (*s) {
    if (*ln < W) buf[*ln] = (uint8_t)*s;
    ++*ln;
    ++s;
  }
}

__device__ void put_int(uint8_t* buf, int W, int* ln, int v) {
  uint8_t d[11];
  put(buf, W, ln, d, int_to_dec(v, d));
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

// The first n bytes of src, then zeros, into dst[0, W).
__device__ void put_row(uint8_t* dst, const uint8_t* src, int n, int W) {
  n = max(0, min(n, W));
  for (int j = 0; j < n; ++j) dst[j] = src[j];
  for (int j = n; j < W; ++j) dst[j] = 0;
}

// ---- list cells -------------------------------------------------------------

// Cell `to` of list slot d := cell `from` of list slot s (meta and bytes).
__device__ void copy_cell(const Prog& g, const Lane& L, const int* d, int to,
                          const int* s, int from) {
  int* md = plane(L, d);
  const int* ms = plane(L, s);
  const int E = g.E;
  md[to] = ms[from];
  md[E + to] = ms[E + from];
  md[2 * E + to] = ms[2 * E + from];
  uint8_t* bd = cell(g, L, d, to);
  const uint8_t* bs = cell(g, L, s, from);
  for (int j = 0; j < g.ew; ++j) bd[j] = bs[j];
}

// Cell e of list slot d := one element (bytes: the first vln of vbuf, then
// zeros; none when vbuf is null).
__device__ void set_cell(const Prog& g, const Lane& L, const int* d, int e,
                         int vt, int vi, int vln, const uint8_t* vbuf) {
  int* md = plane(L, d);
  md[e] = vt;
  md[g.E + e] = vi;
  md[2 * g.E + e] = vln;
  uint8_t* bd = cell(g, L, d, e);
  int n = vbuf == nullptr ? 0 : max(0, min(vln, g.ew));
  for (int j = 0; j < n; ++j) bd[j] = vbuf[j];
  for (int j = n; j < g.ew; ++j) bd[j] = 0;
}

__device__ void zero_cell(const Prog& g, const Lane& L, const int* d, int e) {
  set_cell(g, L, d, e, 0, 0, 0, nullptr);
}

__device__ __forceinline__ void set_list_regs(const Lane& L, const int* s,
                                              int count) {
  L.regs[s[1]] = T_LIST;
  L.regs[s[2]] = 0;
  L.regs[s[3]] = count;
}

// Python str(list) of list slot s, appended at *ln (keeping what fits in
// W). Parks on an element of the wrong kind for the slot's element kind,
// on a string element with a byte outside printable ASCII, ' or \, and
// (as a template hole) on a brace or escape or a repr longer than W.
__device__ void repr_list(const Prog& g, const Lane& L, const int* s,
                          uint8_t* buf, int* ln, bool* park) {
  const int W = g.W, E = g.E, ek = s[7];
  const int* m = plane(L, s);
  const int n = L.regs[s[3]];
  const int start = *ln;
  put_str(buf, W, ln, "[");
  for (int e = 0; e < E && e < n; ++e) {
    const int et = m[e], el = m[2 * E + e];
    const int elc = max(0, min(el, g.ew));
    const uint8_t* c = cell(g, L, s, e);
    if (ek != KIND_STR && e > 0) put_str(buf, W, ln, ", ");
    if (ek == KIND_INT || (ek == KIND_MIX && et != T_STR)) {
      if (ek == KIND_INT && et != T_INT) *park = true;
      put_int(buf, W, ln, m[E + e]);
      continue;
    }
    if (et != T_STR || el > g.ew) *park = true;
    for (int j = 0; j < elc; ++j)
      if (c[j] < 32 || c[j] > 126 || c[j] == '\'' || c[j] == '\\')
        *park = true;
    put_str(buf, W, ln, (ek == KIND_STR && e > 0) ? ", '" : "'");
    put(buf, W, ln, c, elc);
    put_str(buf, W, ln, "'");
  }
  put_str(buf, W, ln, "]");
  const int rl = *ln - start;
  if (rl > W) *park = true;
  if (start < W && brace_or_escape(buf + start, min(rl, W - start)))
    *park = true;
}

// Append a rendered template at *ln (keeping what fits in W). Sets *missing
// when a hole's slot is empty and *park when a hole value carries a brace
// or an escape; the caller checks the length against W.
__device__ void render_at(const Prog& g, const Lane& L, int seg0, int nseg,
                          uint8_t* buf, int* ln, bool* missing, bool* park) {
  const int W = g.W;
  for (int k = 0; k < nseg; ++k) {
    const int* seg = g.segs + 2 * (seg0 + k);
    if (seg[0] == SEG_LIT) {
      put(buf, W, ln, g.lits + (size_t)seg[1] * W, g.lit_len[seg[1]]);
      continue;
    }
    const int* s = slot(g, seg[1]);
    int st = L.regs[s[1]];
    if (st == T_EMPTY) *missing = true;
    if (s[0] == KIND_LIST) {
      if (st == T_LIST) repr_list(g, L, s, buf, ln, park);
    } else if (s[0] == KIND_INT || (s[0] == KIND_MIX && st == T_INT)) {
      put_int(buf, W, ln, L.regs[s[2]]);
    } else if ((s[0] == KIND_STR || s[0] == KIND_MIX) && st == T_STR) {
      const uint8_t* r = L.row(s[4]);
      int n = L.regs[s[3]];
      if (brace_or_escape(r, min(n, W))) *park = true;
      put(buf, W, ln, r, n);
    }
  }
}

// Render a template into buf (zero past the result); *park also when the
// result is longer than W. Returns min(length, W).
__device__ int render(const Prog& g, const Lane& L, int seg0, int nseg,
                      uint8_t* buf, bool* missing, bool* park) {
  const int W = g.W;
  int ln = 0;
  render_at(g, L, seg0, nseg, buf, &ln, missing, park);
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
        const int* s = slot(g, o[1]);
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
        const int* s = slot(g, o[1]);
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

// A value from an item source: type, int, bytes (null: none) and length.
struct Val {
  int vt, vi, vln;
  const uint8_t* vbuf;
};

// Evaluate an item source (SRC_*, c, d; a template renders into buf). A
// copy of a list slot parks: a nested list is the host's.
__device__ Val eval_src(const Prog& g, const Lane& L, int kind, int c, int d,
                        uint8_t* buf, bool* park) {
  Val v{T_INT, 0, 0, nullptr};
  if (kind == SRC_INT) {
    v.vi = c;
  } else if (kind == SRC_STR) {
    v.vt = T_STR;
    v.vbuf = g.lits + (size_t)c * g.W;
    v.vln = g.lit_len[c];
  } else if (kind == SRC_COPY) {
    const int* s = slot(g, c);
    v.vt = L.regs[s[1]];
    if (s[0] == KIND_LIST) {
      *park = true;
    } else {
      v.vi = L.regs[s[2]];
      if (v.vt == T_EMPTY) *park = true;
      if (s[4] >= 0) {
        v.vbuf = L.row(s[4]);
        v.vln = L.regs[s[3]];
      }
    }
  } else {
    bool missing = false;
    v.vt = T_STR;
    v.vln = render(g, L, c, d, buf, &missing, park);
    v.vbuf = buf;
    if (missing) *park = true;
  }
  return v;
}

// The item source of the items table's row.
__device__ Val eval_item(const Prog& g, const Lane& L, int row, uint8_t* buf,
                         bool* park) {
  const int* it = g.items + 3 * row;
  return eval_src(g, L, it[0], it[1], it[2], buf, park);
}

__device__ __forceinline__ void advance(const Lane& L, bool park,
                                        int next_pc) {
  if (park) L.regs[C_STATUS] = PARKED;
  else L.regs[C_PC] = next_pc;
  L.regs[C_STEPS] += 1;
}

__device__ __forceinline__ int tpc_col(const Prog& g, int l) {
  return C_BASE + l;
}
__device__ __forceinline__ int tstate_col(const Prog& g, int l) {
  return C_BASE + g.nt + l;
}
__device__ __forceinline__ int tparg_col(const Prog& g, int l) {
  return C_BASE + 2 * g.nt + l;
}

// One VM step of one lane at pc.
__device__ void step(const Prog& g, const Lane& L, int pc, uint8_t* buf,
                     int OW) {
  const int* in = g.ins + 8 * pc;
  const int a = in[1], b = in[2], c = in[3], d = in[4], e = in[5],
            f = in[6];
  const int E = g.E;
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
      if (a >= 0 && L.regs[slot(g, a)[1]] != T_EMPTY)
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
        L.regs[slot(g, g.ints[a + k])[1]] = T_EMPTY;
      advance(L, false, pc + 1);
      return;
    case OP_SET: {
      bool park = false;
      Val v = eval_src(g, L, b, c, d, buf, &park);
      if (!park) {
        const int* out = slot(g, a);
        L.regs[out[1]] = v.vt;
        L.regs[out[2]] = v.vi;
        L.regs[out[3]] = v.vln;
        if (v.vbuf != nullptr && out[4] >= 0 && L.row(out[4]) != v.vbuf)
          copy_row(L.row(out[4]), v.vbuf, g.W);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_MATH: {
      bool park = false;
      int v = eval_rpn(g, L, b, c, &park);
      if (!park) {
        const int* out = slot(g, a);
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
      if (c >= 0 && L.regs[slot(g, c)[1]] != T_STR) park = true;
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
        const int* s = slot(g, a);
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
          const int* s = slot(g, pr[0]);
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
    case OP_SETLIST: {
      // whole-list copy: registers, and the cells when the slots differ
      const int* src = slot(g, b);
      const int* out = slot(g, a);
      int st = L.regs[src[1]];
      bool park = st == T_EMPTY;
      if (!park) {
        if (a != b)
          for (int k = 0; k < E; ++k) copy_cell(g, L, out, k, src, k);
        L.regs[out[1]] = st;
        L.regs[out[2]] = L.regs[src[2]];
        L.regs[out[3]] = L.regs[src[3]];
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTNEW: {
      // items may render the list they replace: stage, then commit
      int* sm = reinterpret_cast<int*>(L.scratch);
      uint8_t* sb = L.scratch + 12 * E;
      bool park = false;
      for (int k = 0; k < c && !park; ++k) {
        Val v = eval_item(g, L, b + k, buf, &park);
        if (v.vln > g.ew) park = true;
        if (park) break;
        sm[k] = v.vt;
        sm[E + k] = v.vi;
        sm[2 * E + k] = v.vln;
        put_row(sb + k * g.ew, v.vbuf, v.vbuf ? v.vln : 0, g.ew);
      }
      if (!park) {
        const int* out = slot(g, a);
        for (int k = 0; k < E; ++k) {
          if (k < c)
            set_cell(g, L, out, k, sm[k], sm[E + k], sm[2 * E + k],
                     sb + k * g.ew);
          else
            zero_cell(g, L, out, k);
        }
        set_list_regs(L, out, c);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTAPPEND: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = false;
      Val v = eval_item(g, L, c, buf, &park);
      if (L.regs[src[1]] != T_LIST || n >= E || v.vln > g.ew) park = true;
      if (!park) {
        const int* out = slot(g, a);
        if (a != b)
          for (int k = 0; k < E; ++k) copy_cell(g, L, out, k, src, k);
        set_cell(g, L, out, n, v.vt, v.vi, v.vln, v.vbuf);
        set_list_regs(L, out, n + 1);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTREMOVE: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = false;
      Val v = eval_item(g, L, c, buf, &park);
      if (L.regs[src[1]] != T_LIST) park = true;
      if (!park) {
        // the first match: int == int by value, str == str by bytes
        const int* ms = plane(L, src);
        int m = E;
        for (int k = 0; k < E && k < n; ++k) {
          bool eq = (v.vt == T_INT && ms[k] == T_INT && ms[E + k] == v.vi) ||
                    (v.vbuf != nullptr && v.vt == T_STR && ms[k] == T_STR &&
                     ms[2 * E + k] == v.vln && v.vln <= g.ew &&
                     bytes_eq(cell(g, L, src, k), v.vbuf, v.vln));
          if (eq) {
            m = k;
            break;
          }
        }
        const int* out = slot(g, a);
        if (a != b)
          for (int k = 0; k < m; ++k) copy_cell(g, L, out, k, src, k);
        if (m < E) {
          for (int k = m; k < E - 1; ++k) copy_cell(g, L, out, k, src, k + 1);
          zero_cell(g, L, out, E - 1);
        }
        // an absent item leaves the list as it was
        set_list_regs(L, out, m < E ? n - 1 : n);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTINDEX: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = L.regs[src[1]] != T_LIST;
      int idx = 0;
      if (c == IDX_CONST) {
        idx = d;
      } else if (c == IDX_COPY) {
        const int* s = slot(g, d);
        int st = L.regs[s[1]];
        idx = L.regs[s[2]];
        if (s[4] >= 0) {
          if (st == T_STR && !parse_dec(L.row(s[4]), L.regs[s[3]], &idx))
            park = true;
          if (st == T_EMPTY || st == T_LIST) park = true;
        } else if (st != T_INT) {
          park = true;
        }
      } else {
        bool missing = false;
        int rl = render(g, L, d, e, buf, &missing, &park);
        if (!parse_dec(buf, rl, &idx) || missing) park = true;
      }
      // 1-based; 0 raises on the host; negatives count from the end
      long long j = idx > 0 ? (long long)idx - 1 : (long long)n + idx;
      if (idx == 0 || j < 0 || j >= n) park = true;
      if (!park) {
        int k = (int)min(max(j, 0LL), (long long)E - 1);
        const int* ms = plane(L, src);
        const int* out = slot(g, a);
        int el = ms[2 * E + k];
        L.regs[out[1]] = ms[k];
        L.regs[out[2]] = ms[E + k];
        L.regs[out[3]] = el;
        if (out[4] >= 0)
          put_row(L.row(out[4]), cell(g, L, src, k), min(el, g.ew), g.W);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTSLICE: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = L.regs[src[1]] != T_LIST;
      int frm = eval_rpn(g, L, c, d, &park);
      int to = eval_rpn(g, L, e, f, &park);
      if (frm == 0) park = true;  // the host raises
      if (!park) {
        // 1-based right-inclusive, with the right-bound-0 quirk, then
        // Python's own slice clamping
        int s0 = frm > 0 ? frm - 1 : n + frm;
        int e0 = (to > 0 ? to - 1 : (to < 0 ? n + to : 0)) + 1;
        int pys = s0 < 0 ? max(s0 + n, 0) : min(s0, n);
        int pye = e0 < 0 ? max(e0 + n, 0) : min(e0, n);
        int count = max(pye - pys, 0);
        const int* out = slot(g, a);
        // ascending: cell k reads cell k + pys >= k
        for (int k = 0; k < E; ++k) {
          if (k < count) copy_cell(g, L, out, k, src, k + pys);
          else zero_cell(g, L, out, k);
        }
        set_list_regs(L, out, count);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTJOIN: {
      // before + between.join(elements) + after, in the one buffer
      const int* src = slot(g, b);
      const int W = g.W;
      bool park = L.regs[src[1]] != T_LIST, missing = false;
      int ln = 0;
      render_at(g, L, c, d, buf, &ln, &missing, &park);
      int mark = ln;  // the separator's flags count with fewer than 2
      render_at(g, L, c + d, e, buf, &mark, &missing, &park);
      if (mark - ln > W) park = true;
      const int* ms = plane(L, src);
      int n = L.regs[src[3]];
      for (int k = 0; k < E && k < n; ++k) {
        if (k > 0) render_at(g, L, c + d, e, buf, &ln, &missing, &park);
        if (ms[k] != T_STR) park = true;
        put(buf, W, &ln, cell(g, L, src, k),
            max(0, min(ms[2 * E + k], g.ew)));
      }
      render_at(g, L, c + d + e, f, buf, &ln, &missing, &park);
      park = park || missing || ln > W;
      if (!park) {
        const int* out = slot(g, a);
        L.regs[out[1]] = T_STR;
        L.regs[out[2]] = 0;
        L.regs[out[3]] = ln;
        if (out[4] >= 0) put_row(L.row(out[4]), buf, ln, W);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_LISTCONCAT: {
      bool park = false;
      int total = 0;
      for (int q = 0; q < c; ++q) {
        const int* s = slot(g, g.ints[b + q]);
        if (L.regs[s[1]] != T_LIST) park = true;
        total += L.regs[s[3]];
      }
      if (total > E) park = true;
      if (!park) {
        const int* out = slot(g, a);
        // descending: cell k reads a source cell <= k, so a source that is
        // the out slot is read before it is overwritten
        for (int k = E - 1; k >= 0; --k) {
          if (k >= total) {
            zero_cell(g, L, out, k);
            continue;
          }
          int off = 0;
          for (int q = 0; q < c; ++q) {
            const int* s = slot(g, g.ints[b + q]);
            int nq = L.regs[s[3]];
            if (k < off + nq) {
              copy_cell(g, L, out, k, s, k - off);
              break;
            }
            off += nq;
          }
        }
        set_list_regs(L, out, total);
      }
      advance(L, park, pc + 1);
      return;
    }
    case OP_FORHEADDYN: {
      const int* dp = g.dpairs + 2 * c;
      bool park = false;
      int n = 0;
      for (int q = 0; q < d; ++q) {
        const int* ls = slot(g, dp[2 * q + 1]);
        if (L.regs[ls[1]] != T_LIST) park = true;
        // lists of differing lengths: the host raises the exact assert
        if (q == 0) n = L.regs[ls[3]];
        else if (L.regs[ls[3]] != n) park = true;
      }
      int counter = L.regs[a];
      int cur = counter == 0 ? 1 : counter;
      bool exiting = cur > n;
      if (!park) {
        if (!exiting) {  // an exiting lane keeps the last values
          int k = min(max(cur - 1, 0), E - 1);
          for (int q = 0; q < d; ++q) {
            const int* var = slot(g, dp[2 * q]);
            const int* ls = slot(g, dp[2 * q + 1]);
            const int* ms = plane(L, ls);
            int el = ms[2 * E + k];
            L.regs[var[1]] = ms[k];
            L.regs[var[2]] = ms[E + k];
            L.regs[var[3]] = el;
            if (var[4] >= 0)
              put_row(L.row(var[4]), cell(g, L, ls, k), min(el, g.ew), g.W);
          }
        }
        L.regs[a] = exiting ? 0 : cur;
      }
      advance(L, park, exiting ? b : pc + 1);
      return;
    }
    case OP_PARBEGIN: {
      // spawn b lanes at their entry pcs; lane 0 runs first
      L.regs[C_CURTID] = 0;
      L.regs[C_PARMODE] = a;
      L.regs[C_PARJOIN] = c;
      for (int l = 0; l < g.nt; ++l) {
        L.regs[tpc_col(g, l)] = l < b ? g.ints[d + l] : 0;
        L.regs[tstate_col(g, l)] = l < b ? T_NEW : T_FREE;
        L.regs[tparg_col(g, l)] = 0;
      }
      // loop counters of the block restart (a raced lane may have left one
      // mid-loop)
      for (int q = 0; q < f; ++q) L.regs[g.ints[e + q]] = 0;
      advance(L, false, g.ints[d]);
      return;
    }
    case OP_THREADEND: {
      const int nt = g.nt;
      const int cur = min(max(L.regs[C_CURTID], 0), nt - 1);
      L.regs[tstate_col(g, cur)] = T_DONE;
      bool new_left = false, wait_left = false, ready_left = false;
      bool all_done = true;
      for (int l = 0; l < nt && l < a; ++l) {
        int st = L.regs[tstate_col(g, l)];
        new_left |= st == T_NEW;
        wait_left |= st == T_WAIT;
        ready_left |= st == T_READY;
        all_done &= st == T_DONE;
      }
      const bool wait_mode = L.regs[C_PARMODE] == PM_WAIT;
      // a race completes only when no lane has a slice coming
      const bool complete = wait_mode ? all_done
                                      : !new_left && !wait_left && !ready_left;
      const bool drain = !wait_mode && !complete;
      // the next runnable lane, cyclic from cur + 1
      int nxt = 0;
      bool any_run = false;
      for (int off = 0; off < nt && !any_run; ++off) {
        int l = (cur + 1 + off) % nt;
        int st = L.regs[tstate_col(g, l)];
        if ((st == T_NEW || st == T_READY) && l < a) {
          nxt = l;
          any_run = true;
        }
      }
      if (complete)
        for (int l = 0; l < nt; ++l) L.regs[tstate_col(g, l)] = T_FREE;
      if (complete) L.regs[C_PARMODE] = PM_NONE;
      else if (drain) L.regs[C_PARMODE] = PM_DRAIN;
      if (complete) L.regs[C_PARJOIN] = 0;
      L.regs[C_PAREPOCH] += complete ? 1 : 0;
      L.regs[C_CURTID] = complete ? -1 : (any_run ? nxt : -1);
      if (complete) L.regs[C_PC] = b;
      else if (any_run) L.regs[C_PC] = L.regs[tpc_col(g, nxt)];
      L.regs[C_STATUS] = (complete || any_run) ? RUNNING : PARKED;
      L.regs[C_STEPS] += 1;
      return;
    }
  }
}

// A park inside a parallel block suspends the current lane: WAIT, with its
// saved pc and park pc at the parked pc. It never switches lanes; the host
// ring decides what runs next.
__device__ void lane_yield(const Prog& g, const Lane& L) {
  if (g.nt == 0 || L.regs[C_STATUS] != PARKED || L.regs[C_PARMODE] <= 0 ||
      L.regs[C_CURTID] < 0)
    return;
  const int cur = min(L.regs[C_CURTID], g.nt - 1);
  const int pc = L.regs[C_PC];
  L.regs[tstate_col(g, cur)] = T_WAIT;
  L.regs[tparg_col(g, cur)] = pc;
  L.regs[tpc_col(g, cur)] = pc;
}

__global__ void turbo_step_kernel(const int* __restrict__ flat,
                                  const uint8_t* __restrict__ lits,
                                  int* regs, uint8_t* sbuf, uint8_t* out,
                                  int* meta, uint8_t* scratch, int n,
                                  int regw, int W, int OW, int scr, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Prog g;
  g.P = flat[0];
  g.E = flat[3];
  g.ew = flat[4];
  g.pack = flat[5];
  g.nt = flat[6];
  g.ins = flat + flat[OFF0 + 0];
  g.segs = flat + flat[OFF0 + 1];
  g.ents = flat + flat[OFF0 + 2];
  g.rpn = flat + flat[OFF0 + 3];
  g.ints = flat + flat[OFF0 + 4];
  g.pairs = flat + flat[OFF0 + 5];
  g.elems = flat + flat[OFF0 + 6];
  g.slots = flat + flat[OFF0 + 7];
  g.lit_len = flat + flat[OFF0 + 8];
  g.items = flat + flat[OFF0 + 9];
  g.dpairs = flat + flat[OFF0 + 10];
  g.lits = lits;
  g.W = W;
  const size_t cells = 3 * (size_t)g.E;
  Lane L{regs + (size_t)i * regw, sbuf + (size_t)i * W, (size_t)n * W,
         out + (size_t)i * OW, meta + (size_t)i * cells, (size_t)n * cells,
         scratch + (size_t)i * scr};
  uint8_t buf[MAX_W];
  for (int k = 0; k < K; ++k) {
    if (L.regs[C_STATUS] != RUNNING) break;
    int pc = L.regs[C_PC];
    if (pc < 0 || pc >= g.P) break;
    step(g, L, pc, buf, OW);
    lane_yield(g, L);
  }
}

}  // namespace

static_assert(HEADER == 32 && OFF0 + 11 <= HEADER, "flat header size");

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int turbo_step_launch(const int* flat, const uint8_t* lits,
                                 int* regs, uint8_t* sbuf, uint8_t* out,
                                 int* meta, uint8_t* scratch, int n, int regw,
                                 int width, int out_width, int scratch_bytes,
                                 int k_steps, int block, void* stream) {
  if (n <= 0 || k_steps <= 0) return 0;
  if (width <= 0 || width > MAX_W || block <= 0 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + block - 1) / block;
  turbo_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      flat, lits, regs, sbuf, out, meta, scratch, n, regw, width, out_width,
      scratch_bytes, k_steps);
  return (int)cudaGetLastError();
}

extern "C" const char* turbo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
