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
// What bounds it on this card. A VM step does almost no arithmetic: it is
// a chain of dependent loads (status, pc, the instruction row, the slot
// row, a register, then the bytes) and byte loops over W-byte rows, one
// thread per instance. Run from device memory (the first design), every
// access of a warp touched 32 rows a row apart and every link of the chain
// paid device-memory latency: 3 % of the byte bound. So the kernel does
// what the TPU kernel did with VMEM: one block takes a tile of T
// instances, T consecutive slots of the launch's row order (ops/turbo_step.py
// tile_plan sizes T and the layout from the bytes per instance and the
// card's shared memory, 227 KB a block on an H100) and
//   1. stage in: copies the program tables (the flat int32 buffer, parsed
//      once per block, and the literals when they are small) and the
//      tile's register, string, output and meta rows into shared memory,
//      with asynchronous copies (cp.async) so that many are in flight. The
//      tables go by neighbouring threads on neighbouring 16-byte units.
//      The state's shared rows are padded (below): a row of 512 bytes or
//      more goes a warp a row, its lanes on neighbouring words, so that one
//      warp instruction reads 128 contiguous bytes of device memory and
//      writes 32 consecutive words, 32 banks; a shorter row goes by
//      neighbouring threads on neighbouring 16-byte units, each as four
//      words, where a warp's row lookup would cost more than its bank
//      conflicts;
//   2. run: each thread steps its instance up to K times on shared memory,
//      its render buffer and scratch row there too (no stack buffer);
//   3. stage out: writes the tile's rows back once, each row the way it
//      came in (a lane of a long row loads up to four words from shared
//      memory before it stores them).
// Barriers sit only between the phases. A tile with no RUNNING instance
// reads its status column and nothing else. In shared memory every row of
// an instance is padded to an odd number of words, so that a warp reading
// one column or one byte of its rows hits 32 distinct banks. What bounds
// the kernel now is the steps: on an H100 (chip_smoke.py phase 5, adventure
// at 131,072 instances and K = 64) staging in and out alone takes under a
// fifth of a launch, about 1.3 times a plain copy of the batch, and each
// step is a chain of dependent shared-memory loads and byte loops per
// thread with only about 4 warps stepping on each SM (shared memory holds
// about 110 adventure instances an SM), so latency sets the pace.
//
// The row order. A warp's 32 threads issue one instruction stream, so rows
// of a warp at different pcs take their branches one after another. A
// launch of more than one wave of blocks therefore first groups its rows by
// pc into `perm` (csrc/regroup.cu: RUNNING rows by pc, the others last,
// each bin in row order), and tile slot s steps row perm[s]; the rows stay
// where they are in the batch. Each block notes its tile's rows in shared
// memory at entry and stages each row in whole units.
//
// Lane groups. A row is stepped by a group of G lanes, G a template
// parameter: 1, one thread a row as above, or WARP, a warp a row, where a
// block's tile has at most MAX_TILE / WARP rows (the plan's `lanes`,
// ops/turbo_step.py row_lanes). Wide rows give small tiles, and there one
// thread a row left most of the block idle while it copied and scanned
// kilobyte prompts a byte at a time. The step is written once for both:
// every lane of a group runs the same scalar code on the same row, so its
// loads of instructions, registers and meta are broadcasts, and the byte
// loops are strided, lane l taking bytes (or words) l, l + G, ... At G = 1
// those are the plain loops, and every barrier and vote below compiles to
// nothing: the one-thread instance compiles to the code it had before the
// warp came (only the three byte scans are written out for each group). Three hazards of a group under independent thread scheduling,
// each handled by design:
//   1. Divergence. A predicate computed over bytes (a brace or an escape in
//      a value, a byte unlike the pattern's, a character a repr refuses) is
//      a vote over the group (`any`) before anyone branches on it, so the
//      group takes every branch, and parks, as one.
//   2. Shared scalars. A step writes registers, meta cells and loop
//      counters only after its `commit` barrier, which every lane reaches
//      once it has made all of the step's reads; so no lane reads a value a
//      faster lane has already replaced. (Two writes come before it, where
//      no lane needs the old value and each reads its own write: a list
//      literal's staged items, and THREADEND's T_DONE.) Every lane writes
//      the same value, except in a read-modify-write (C_STEPS in `advance`,
//      C_CLREPOCH, C_PAREPOCH, a FORNEXT counter), which lane 0 alone makes
//      (`lead`); the next lane to read it does so past a later barrier.
//   3. Strided bytes. Each byte helper that writes ends with `sync`, or its
//      caller syncs before anyone reads (the render into buf, then its
//      brace scan, put_row or the print copy; a list literal's scratch row,
//      then its commit), so no lane reads bytes another lane has yet to
//      write, nor writes bytes another lane has yet to read.
//
// Semantics are those of ops/turbo_step.py turbo_step_reference, bit for
// bit after every launch: ints wrap at 32 bits (computed in 64 bits and
// truncated, since signed overflow is undefined in C++), `//` and `%` are
// Python's floor division and modulo, a lane parks wherever the TPU kernel
// parks, and a list write leaves the cells past the count zero.

// nvcc compiles the whole file. The kernel, its launch and the one PTX copy
// sit behind __CUDACC__, so that a host compiler can build the rest: the
// CPU tests (tests/test_torch_turbo_tile.py) run the phases that way, a
// warp as 32 host threads.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>
#include <string.h>

namespace {

constexpr int RUNNING = 0, DONE = 1, PARKED = 2;
constexpr int C_PC = 0, C_STATUS = 1, C_STEPS = 2, C_OUTLEN = 3;
constexpr int C_CURTID = 4, C_PARMODE = 5, C_PARJOIN = 6, C_PAREPOCH = 7;
constexpr int C_CLREPOCH = 8, C_BASE = 9;
constexpr int T_EMPTY = 0, T_INT = 1, T_STR = 2, T_LIST = 3;
// thread-lane states and parallel-block modes (vm/config.py)
constexpr int T_FREE = 0, T_NEW = 1, T_READY = 2, T_WAIT = 3, T_DONE = 4;
constexpr int PM_NONE = 0, PM_WAIT = 1, PM_DRAIN = 3;

constexpr int MAX_W = 2048;      // widest slot: the sibling of a 512-wide batch
constexpr int MAX_TILE = 256;    // ops/turbo_step.py MAX_TILE; threads a block
constexpr int WARP = 32;         // ops/turbo_step.py WARP: the wide group
constexpr int PROG_BYTES = 256;  // ops/turbo_step.py PROG_BYTES
constexpr int MAX_STACK = 16;    // vm/turbo_tables.py RPN_MAX_STACK
constexpr int HEADER = 32;       // vm/turbo_tables.py HEADER
constexpr int OFF0 = 8;          // vm/turbo_tables.py _OFF0
constexpr int SLOTW = 8;         // columns of the slots table
// the shortest padded row staged a word a lane, a warp a row: four warp
// instructions (ops/turbo_step.py WORD_ROW)
constexpr int WORD_ROW = 4 * 4 * WARP;

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

// One instance's state, staged in shared memory: its register row, its
// string and element rows, its output row, its list meta planes and its
// scratch row.
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

// ---- a lane group -----------------------------------------------------------

// This thread's lane in its group of G.
template <int G>
__device__ __forceinline__ int lane() {
  static_assert(G == 1 || G == WARP, "a lane group is a thread or a warp");
  if constexpr (G == 1) return 0;
  else return (int)(threadIdx.x % G);
}

// The lane that makes the group's read-modify-writes (hazard 2).
template <int G>
__device__ __forceinline__ bool lead() {
  return lane<G>() == 0;
}

// Hazard 3's barrier: the group's byte writes are done, and its reads.
template <int G>
__device__ __forceinline__ void sync() {
  if constexpr (G > 1) __syncwarp();
}

// Hazard 2's barrier: every lane has made the step's reads; writes follow.
template <int G>
__device__ __forceinline__ void commit() {
  sync<G>();
}

// Hazard 1's vote: p on any lane of the group, on every lane.
template <int G>
__device__ __forceinline__ bool any(bool p) {
  if constexpr (G == 1) return p;
  else return __any_sync(0xffffffffu, p);
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

// Hazard 1: a vote of the group, once. The three scans (this one,
// bytes_eq and repr_list's) are written out for each group: one thread stops
// at its first hit, as it always did; a warp runs its loop out and votes
// once. One loop for both changed one thread's code (with one vote after the
// loop), or cost a warp 4 registers and 7 % of a prompt-chain launch on an
// H100 (with a vote each round).
template <int G>
__device__ bool brace_or_escape(const uint8_t* b, int n) {
  if constexpr (G == 1) {
    for (int j = 0; j < n; ++j)
      if (b[j] == '{' || b[j] == '}' || b[j] == '\\') return true;
    return false;
  }
  bool hit = false;
  for (int j = lane<G>(); j < n; j += G)
    if (b[j] == '{' || b[j] == '}' || b[j] == '\\') {
      hit = true;
      break;
    }
  return any<G>(hit);
}

// The byte loops below leave the barrier to their callers (hazard 3).

// dst[from, to) := 0, by words where dst is 4-byte aligned
template <int G>
__device__ __forceinline__ void zero_bytes(uint8_t* dst, int from, int to) {
  int j = from;
  for (; j < to && ((uintptr_t)(dst + j) & 3); ++j)
    if (lead<G>()) dst[j] = 0;
  int k = j + 4 * lane<G>();
  for (; k + 4 <= to; k += 4 * G) *reinterpret_cast<uint32_t*>(dst + k) = 0u;
  if constexpr (G > 1) k = to - (to - j) % 4 + lane<G>();  // the tail
  for (; k < to; k += G) dst[k] = 0;
}

// A lane group's words of dst[0, n) := src[0, n), where both are 4-byte
// aligned; returns the bytes copied, where the byte loop after it starts.
template <int G>
__device__ __forceinline__ int copy_words(uint8_t* dst, const uint8_t* src,
                                          int n) {
  if (((uintptr_t)dst & 3) || ((uintptr_t)src & 3) || n < 4) return 0;
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int k = lane<G>(); k < n / 4; k += G) d[k] = s[k];
  return n / 4 * 4;
}

// dst[0, n) := src[0, n); a warp copies by words where both are 4-byte
// aligned. (`put` and the print's copy write this loop out with their own
// indexing: so indexed, the one-thread instance keeps its code and its
// registers.)
template <int G>
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int n) {
  int j = 0;
  if constexpr (G > 1) j = copy_words<G>(dst, src, n);
  for (j += lane<G>(); j < n; j += G) dst[j] = src[j];
}

// Append n bytes of src at offset *ln, keeping what fits in W.
template <int G>
__device__ void put(uint8_t* buf, int W, int* ln, const uint8_t* src, int n) {
  int lim = min(n, W - *ln);
  int j = 0;
  if constexpr (G > 1) j = copy_words<G>(buf + *ln, src, lim);
  for (j += lane<G>(); j < lim; j += G) buf[*ln + j] = src[j];
  *ln += n;
}

__device__ void put_str(uint8_t* buf, int W, int* ln, const char* s) {
  while (*s) {
    if (*ln < W) buf[*ln] = (uint8_t)*s;
    ++*ln;
    ++s;
  }
}

// Append Python str(v) of an int32 (INT32_MIN included), keeping what fits
// in W: the digits are written in place, last first, with no stack buffer.
__device__ void put_int(uint8_t* buf, int W, int* ln, int v) {
  unsigned int mag = v < 0 ? ~(unsigned int)v + 1u : (unsigned int)v;
  int nd = 1;
  for (unsigned int m = mag; m >= 10u; m /= 10u) ++nd;
  if (v < 0 && *ln < W) buf[*ln] = '-';
  const int o = *ln + (v < 0 ? 1 : 0);
  for (int k = nd - 1; k >= 0; --k) {
    if (o + k < W) buf[o + k] = (uint8_t)('0' + mag % 10u);
    mag /= 10u;
  }
  *ln = o + nd;
}

template <int G>
__device__ void copy_row(uint8_t* dst, const uint8_t* src, int W) {
  const uintptr_t at = (uintptr_t)dst | (uintptr_t)src;
  if ((W & 15) == 0 && (at & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int j = lane<G>(); j < W / 16; j += G) d[j] = s[j];
  } else if ((W & 3) == 0 && (at & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int j = lane<G>(); j < W / 4; j += G) d[j] = s[j];
  } else {
    for (int j = lane<G>(); j < W; j += G) dst[j] = src[j];
  }
  sync<G>();
}

// The first n bytes of src, then zeros, into dst[0, W).
template <int G>
__device__ void put_row(uint8_t* dst, const uint8_t* src, int n, int W) {
  n = max(0, min(n, W));
  copy_bytes<G>(dst, src, n);
  zero_bytes<G>(dst, n, W);
  sync<G>();
}

// ---- list cells -------------------------------------------------------------

// Cell `to` of list slot d := cell `from` of list slot s (meta and bytes).
template <int G>
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
  copy_bytes<G>(bd, bs, g.ew);
  sync<G>();
}

// Cell e of list slot d := one element (bytes: the first vln of vbuf, then
// zeros; none when vbuf is null).
template <int G>
__device__ void set_cell(const Prog& g, const Lane& L, const int* d, int e,
                         int vt, int vi, int vln, const uint8_t* vbuf) {
  int* md = plane(L, d);
  md[e] = vt;
  md[g.E + e] = vi;
  md[2 * g.E + e] = vln;
  uint8_t* bd = cell(g, L, d, e);
  int n = vbuf == nullptr ? 0 : max(0, min(vln, g.ew));
  copy_bytes<G>(bd, vbuf, n);
  zero_bytes<G>(bd, n, g.ew);
  sync<G>();
}

template <int G>
__device__ void zero_cell(const Prog& g, const Lane& L, const int* d, int e) {
  set_cell<G>(g, L, d, e, 0, 0, 0, nullptr);
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
template <int G>
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
    if constexpr (G == 1) {  // as brace_or_escape
      for (int j = 0; j < elc; ++j)
        if (c[j] < 32 || c[j] > 126 || c[j] == '\'' || c[j] == '\\')
          *park = true;
    } else {
      bool bad = false;
      for (int j = lane<G>(); j < elc; j += G)
        if (c[j] < 32 || c[j] > 126 || c[j] == '\'' || c[j] == '\\')
          bad = true;
      if (any<G>(bad)) *park = true;
    }
    put_str(buf, W, ln, (ek == KIND_STR && e > 0) ? ", '" : "'");
    put<G>(buf, W, ln, c, elc);
    put_str(buf, W, ln, "'");
  }
  put_str(buf, W, ln, "]");
  const int rl = *ln - start;
  if (rl > W) *park = true;
  sync<G>();  // the repr's bytes, then their scan
  if (start < W && brace_or_escape<G>(buf + start, min(rl, W - start)))
    *park = true;
}

// Append a rendered template at *ln (keeping what fits in W). Sets *missing
// when a hole's slot is empty and *park when a hole value carries a brace
// or an escape; the caller checks the length against W, and syncs before
// the bytes are read.
template <int G>
__device__ void render_at(const Prog& g, const Lane& L, int seg0, int nseg,
                          uint8_t* buf, int* ln, bool* missing, bool* park) {
  const int W = g.W;
  for (int k = 0; k < nseg; ++k) {
    const int* seg = g.segs + 2 * (seg0 + k);
    if (seg[0] == SEG_LIT) {
      put<G>(buf, W, ln, g.lits + (size_t)seg[1] * W, g.lit_len[seg[1]]);
      continue;
    }
    const int* s = slot(g, seg[1]);
    int st = L.regs[s[1]];
    if (st == T_EMPTY) *missing = true;
    if (s[0] == KIND_LIST) {
      if (st == T_LIST) repr_list<G>(g, L, s, buf, ln, park);
    } else if (s[0] == KIND_INT || (s[0] == KIND_MIX && st == T_INT)) {
      put_int(buf, W, ln, L.regs[s[2]]);
    } else if ((s[0] == KIND_STR || s[0] == KIND_MIX) && st == T_STR) {
      const uint8_t* r = L.row(s[4]);
      int n = L.regs[s[3]];
      if (brace_or_escape<G>(r, min(n, W))) *park = true;
      put<G>(buf, W, ln, r, n);
    }
  }
}

// Render a template into buf (zero past the result); *park also when the
// result is longer than W. Returns min(length, W).
template <int G>
__device__ int render(const Prog& g, const Lane& L, int seg0, int nseg,
                      uint8_t* buf, bool* missing, bool* park) {
  const int W = g.W;
  int ln = 0;
  render_at<G>(g, L, seg0, nseg, buf, &ln, missing, park);
  zero_bytes<G>(buf, min(ln, W), W);
  sync<G>();
  if (ln > W) {
    *park = true;
    ln = W;
  }
  return ln;
}

// Hazard 1: a vote of the group, once (as brace_or_escape).
template <int G>
__device__ bool bytes_eq(const uint8_t* a, const uint8_t* b, int n) {
  if constexpr (G == 1) {
    for (int j = 0; j < n; ++j)
      if (a[j] != b[j]) return false;
    return true;
  }
  bool ne = false;
  for (int j = lane<G>(); j < n; j += G)
    if (a[j] != b[j]) {
      ne = true;
      break;
    }
  return !any<G>(ne);
}

// Anchored match of one decomposed pattern against buf[:ln].
template <int G>
__device__ bool match_at(const Prog& g, const int* e, const uint8_t* buf,
                         int ln) {
  const uint8_t* a = g.lits + (size_t)e[1] * g.W;
  int al = g.lit_len[e[1]];
  switch (e[0]) {
    case PAT_ANY: return true;
    case PAT_EXACT: return ln == al && bytes_eq<G>(buf, a, al);
    case PAT_PREFIX: return ln >= al && bytes_eq<G>(buf, a, al);
    case PAT_SUFFIX: return ln >= al && bytes_eq<G>(buf + ln - al, a, al);
    default: {
      const uint8_t* b = g.lits + (size_t)e[2] * g.W;
      int bl = g.lit_len[e[2]];
      return ln >= al + bl && bytes_eq<G>(buf, a, al) &&
             bytes_eq<G>(buf + ln - bl, b, bl);
    }
  }
}

// The reference's end anchor also matches before one trailing newline.
template <int G>
__device__ bool match(const Prog& g, const int* e, const uint8_t* buf,
                      int ln) {
  if (match_at<G>(g, e, buf, ln)) return true;
  if (e[0] == PAT_ANY || e[0] == PAT_PREFIX) return false;
  return ln > 0 && buf[ln - 1] == '\n' && match_at<G>(g, e, buf, ln - 1);
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
template <int G>
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
    v.vln = render<G>(g, L, c, d, buf, &missing, park);
    v.vbuf = buf;
    if (missing) *park = true;
  }
  return v;
}

// The item source of the items table's row.
template <int G>
__device__ Val eval_item(const Prog& g, const Lane& L, int row, uint8_t* buf,
                         bool* park) {
  const int* it = g.items + 3 * row;
  return eval_src<G>(g, L, it[0], it[1], it[2], buf, park);
}

// The step's end: the pc on, or PARKED; one step more. Its barrier also
// ends the step's byte work (hazard 3).
template <int G>
__device__ __forceinline__ void advance(const Lane& L, bool park,
                                        int next_pc) {
  commit<G>();
  if (park) L.regs[C_STATUS] = PARKED;
  else L.regs[C_PC] = next_pc;
  if (lead<G>()) L.regs[C_STEPS] += 1;
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

// One VM step of one instance at pc, by its lane group.
template <int G>
__device__ void step(const Prog& g, const Lane& L, int pc, uint8_t* buf,
                     int OW) {
  const int* in = g.ins + 8 * pc;
  const int a = in[1], b = in[2], c = in[3], d = in[4], e = in[5],
            f = in[6];
  const int E = g.E;
  switch (in[0]) {
    case OP_HALT:
      commit<G>();
      L.regs[C_STATUS] = DONE;
      return;
    case OP_NOP:
      advance<G>(L, false, pc + 1);
      return;
    case OP_GOTO:
      advance<G>(L, false, a);
      return;
    case OP_PARK:
      // a literal-name await_insert whose key is present does not yield
      if (a >= 0 && L.regs[slot(g, a)[1]] != T_EMPTY) {
        advance<G>(L, false, pc + 1);
      } else {
        commit<G>();
        L.regs[C_STATUS] = PARKED;
      }
      return;
    case OP_CLEAR:
      commit<G>();
      if (lead<G>()) L.regs[C_CLREPOCH] += 1;
      zero_bytes<G>(L.out, 0, OW);
      L.regs[C_OUTLEN] = 0;
      advance<G>(L, false, pc + 1);
      return;
    case OP_DELETE:
      commit<G>();
      for (int k = 0; k < b; ++k)
        L.regs[slot(g, g.ints[a + k])[1]] = T_EMPTY;
      advance<G>(L, false, pc + 1);
      return;
    case OP_SET: {
      bool park = false;
      Val v = eval_src<G>(g, L, b, c, d, buf, &park);
      commit<G>();
      if (!park) {
        const int* out = slot(g, a);
        L.regs[out[1]] = v.vt;
        L.regs[out[2]] = v.vi;
        L.regs[out[3]] = v.vln;
        if (v.vbuf != nullptr && out[4] >= 0 && L.row(out[4]) != v.vbuf)
          copy_row<G>(L.row(out[4]), v.vbuf, g.W);
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_MATH: {
      bool park = false;
      int v = eval_rpn(g, L, b, c, &park);
      commit<G>();
      if (!park) {
        const int* out = slot(g, a);
        L.regs[out[1]] = T_INT;
        L.regs[out[2]] = v;
        L.regs[out[3]] = 0;
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_PRINT: {
      bool park = false, missing = false;
      int n = render<G>(g, L, a, b, buf, &missing, &park);
      // print of a non-string simple key raises on the host
      if (c >= 0 && L.regs[slot(g, c)[1]] != T_STR) park = true;
      int ol = L.regs[C_OUTLEN];
      park = park || missing || ol + n > OW;
      commit<G>();
      if (!park) {
        int j = 0;
        if constexpr (G > 1) j = copy_words<G>(L.out + ol, buf, n);
        for (j += lane<G>(); j < n; j += G) L.out[ol + j] = buf[j];
        L.regs[C_OUTLEN] = ol + n;
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_GOTOMAP:
    case OP_GOTOMAP_INT: {
      bool park = false, missing = false, decided = false;
      int tgt = 0;
      if (in[0] == OP_GOTOMAP) {
        int ln = render<G>(g, L, a, b, buf, &missing, &park);
        for (int k = 0; k < d && !decided; ++k) {
          const int* ent = g.ents + 4 * (c + k);
          if (match<G>(g, ent, buf, ln)) {
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
      advance<G>(L, park || !routed, tgt);
      return;
    }
    case OP_FORHEAD: {
      int counter = L.regs[a];
      int cur = counter == 0 ? 1 : counter;
      commit<G>();
      if (cur > b) {
        // exit: loop variables keep the last iteration's values
        L.regs[a] = 0;
        advance<G>(L, false, c);
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
              copy_row<G>(L.row(s[4]), g.lits + (size_t)el[1] * g.W, g.W);
          }
        }
      }
      advance<G>(L, false, pc + 1);
      return;
    }
    case OP_FORNEXT:
      commit<G>();
      if (lead<G>()) L.regs[a] += 1;
      advance<G>(L, false, b);
      return;
    case OP_SETLIST: {
      // whole-list copy: registers, and the cells when the slots differ
      const int* src = slot(g, b);
      const int* out = slot(g, a);
      int st = L.regs[src[1]];
      bool park = st == T_EMPTY;
      commit<G>();
      if (!park) {
        if (a != b)
          for (int k = 0; k < E; ++k) copy_cell<G>(g, L, out, k, src, k);
        L.regs[out[1]] = st;
        L.regs[out[2]] = L.regs[src[2]];
        L.regs[out[3]] = L.regs[src[3]];
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_LISTNEW: {
      // items may render the list they replace: stage, then commit
      int* sm = reinterpret_cast<int*>(L.scratch);
      uint8_t* sb = L.scratch + 12 * E;
      bool park = false;
      for (int k = 0; k < c && !park; ++k) {
        Val v = eval_item<G>(g, L, b + k, buf, &park);
        if (v.vln > g.ew) park = true;
        if (park) break;
        sm[k] = v.vt;
        sm[E + k] = v.vi;
        sm[2 * E + k] = v.vln;
        put_row<G>(sb + k * g.ew, v.vbuf, v.vbuf ? v.vln : 0, g.ew);
      }
      commit<G>();
      if (!park) {
        const int* out = slot(g, a);
        for (int k = 0; k < E; ++k) {
          if (k < c)
            set_cell<G>(g, L, out, k, sm[k], sm[E + k], sm[2 * E + k],
                        sb + k * g.ew);
          else
            zero_cell<G>(g, L, out, k);
        }
        set_list_regs(L, out, c);
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_LISTAPPEND: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = false;
      Val v = eval_item<G>(g, L, c, buf, &park);
      if (L.regs[src[1]] != T_LIST || n >= E || v.vln > g.ew) park = true;
      commit<G>();
      if (!park) {
        const int* out = slot(g, a);
        if (a != b)
          for (int k = 0; k < E; ++k) copy_cell<G>(g, L, out, k, src, k);
        set_cell<G>(g, L, out, n, v.vt, v.vi, v.vln, v.vbuf);
        set_list_regs(L, out, n + 1);
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_LISTREMOVE: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = false;
      Val v = eval_item<G>(g, L, c, buf, &park);
      if (L.regs[src[1]] != T_LIST) park = true;
      if (!park) {
        // the first match: int == int by value, str == str by bytes
        const int* ms = plane(L, src);
        int m = E;
        for (int k = 0; k < E && k < n; ++k) {
          bool eq = (v.vt == T_INT && ms[k] == T_INT && ms[E + k] == v.vi) ||
                    (v.vbuf != nullptr && v.vt == T_STR && ms[k] == T_STR &&
                     ms[2 * E + k] == v.vln && v.vln <= g.ew &&
                     bytes_eq<G>(cell(g, L, src, k), v.vbuf, v.vln));
          if (eq) {
            m = k;
            break;
          }
        }
        commit<G>();
        const int* out = slot(g, a);
        if (a != b)
          for (int k = 0; k < m; ++k) copy_cell<G>(g, L, out, k, src, k);
        if (m < E) {
          for (int k = m; k < E - 1; ++k)
            copy_cell<G>(g, L, out, k, src, k + 1);
          zero_cell<G>(g, L, out, E - 1);
        }
        // an absent item leaves the list as it was
        set_list_regs(L, out, m < E ? n - 1 : n);
      }
      advance<G>(L, park, pc + 1);
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
        int rl = render<G>(g, L, d, e, buf, &missing, &park);
        if (!parse_dec(buf, rl, &idx) || missing) park = true;
      }
      // 1-based; 0 raises on the host; negatives count from the end
      long long j = idx > 0 ? (long long)idx - 1 : (long long)n + idx;
      if (idx == 0 || j < 0 || j >= n) park = true;
      commit<G>();
      if (!park) {
        int k = (int)min(max(j, 0LL), (long long)E - 1);
        const int* ms = plane(L, src);
        const int* out = slot(g, a);
        int el = ms[2 * E + k];
        L.regs[out[1]] = ms[k];
        L.regs[out[2]] = ms[E + k];
        L.regs[out[3]] = el;
        if (out[4] >= 0)
          put_row<G>(L.row(out[4]), cell(g, L, src, k), min(el, g.ew),
                     g.W);
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_LISTSLICE: {
      const int* src = slot(g, b);
      int n = L.regs[src[3]];
      bool park = L.regs[src[1]] != T_LIST;
      int frm = eval_rpn(g, L, c, d, &park);
      int to = eval_rpn(g, L, e, f, &park);
      if (frm == 0) park = true;  // the host raises
      commit<G>();
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
          if (k < count) copy_cell<G>(g, L, out, k, src, k + pys);
          else zero_cell<G>(g, L, out, k);
        }
        set_list_regs(L, out, count);
      }
      advance<G>(L, park, pc + 1);
      return;
    }
    case OP_LISTJOIN: {
      // before + between.join(elements) + after, in the one buffer
      const int* src = slot(g, b);
      const int W = g.W;
      bool park = L.regs[src[1]] != T_LIST, missing = false;
      int ln = 0;
      render_at<G>(g, L, c, d, buf, &ln, &missing, &park);
      int mark = ln;  // the separator's flags count with fewer than 2
      render_at<G>(g, L, c + d, e, buf, &mark, &missing, &park);
      sync<G>();  // the elements overwrite this measure of the separator
      if (mark - ln > W) park = true;
      const int* ms = plane(L, src);
      int n = L.regs[src[3]];
      for (int k = 0; k < E && k < n; ++k) {
        if (k > 0) render_at<G>(g, L, c + d, e, buf, &ln, &missing, &park);
        if (ms[k] != T_STR) park = true;
        put<G>(buf, W, &ln, cell(g, L, src, k),
               max(0, min(ms[2 * E + k], g.ew)));
      }
      render_at<G>(g, L, c + d + e, f, buf, &ln, &missing, &park);
      park = park || missing || ln > W;
      commit<G>();  // and the joined bytes are all in buf
      if (!park) {
        const int* out = slot(g, a);
        L.regs[out[1]] = T_STR;
        L.regs[out[2]] = 0;
        L.regs[out[3]] = ln;
        if (out[4] >= 0) put_row<G>(L.row(out[4]), buf, ln, W);
      }
      advance<G>(L, park, pc + 1);
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
      commit<G>();
      if (!park) {
        const int* out = slot(g, a);
        // descending: cell k reads a source cell <= k, so a source that is
        // the out slot is read before it is overwritten
        for (int k = E - 1; k >= 0; --k) {
          if (k >= total) {
            zero_cell<G>(g, L, out, k);
            continue;
          }
          int off = 0;
          for (int q = 0; q < c; ++q) {
            const int* s = slot(g, g.ints[b + q]);
            int nq = L.regs[s[3]];
            if (k < off + nq) {
              copy_cell<G>(g, L, out, k, s, k - off);
              break;
            }
            off += nq;
          }
        }
        set_list_regs(L, out, total);
      }
      advance<G>(L, park, pc + 1);
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
      commit<G>();
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
              put_row<G>(L.row(var[4]), cell(g, L, ls, k), min(el, g.ew),
                         g.W);
          }
        }
        L.regs[a] = exiting ? 0 : cur;
      }
      advance<G>(L, park, exiting ? b : pc + 1);
      return;
    }
    case OP_PARBEGIN: {
      // spawn b lanes at their entry pcs; lane 0 runs first
      commit<G>();
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
      advance<G>(L, false, g.ints[d]);
      return;
    }
    case OP_THREADEND: {
      const int nt = g.nt;
      const int cur = min(max(L.regs[C_CURTID], 0), nt - 1);
      // before the commit, as no lane needs the old state and each reads
      // its own write
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
      commit<G>();
      if (complete)
        for (int l = 0; l < nt; ++l) L.regs[tstate_col(g, l)] = T_FREE;
      if (complete) L.regs[C_PARMODE] = PM_NONE;
      else if (drain) L.regs[C_PARMODE] = PM_DRAIN;
      if (complete) L.regs[C_PARJOIN] = 0;
      if (lead<G>()) L.regs[C_PAREPOCH] += complete ? 1 : 0;
      L.regs[C_CURTID] = complete ? -1 : (any_run ? nxt : -1);
      if (complete) L.regs[C_PC] = b;
      else if (any_run) L.regs[C_PC] = L.regs[tpc_col(g, nxt)];
      L.regs[C_STATUS] = (complete || any_run) ? RUNNING : PARKED;
      if (lead<G>()) L.regs[C_STEPS] += 1;
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


// ---- the tile ---------------------------------------------------------------

// Where a block's tile lives in dynamic shared memory, in bytes: the fields
// of ops/turbo_step.py TilePlan, in its order. T instances per block; the
// parsed program (Prog) at 0, then the tables, the tile's row indices (T
// ints at idx_off), then the state. `*_is` is the stride from one instance
// to the next, `*_ps` from one meta plane or sbuf row to the next.
// lits_off < 0: the literals stay in device memory. `lanes` steps each
// row: 1 or WARP, the lane group's G.
struct Tile {
  int tile, smem;
  int flat_off, flat_bytes, lits_off, lits_bytes;
  int idx_off;
  int regs_off, regs_is;
  int meta_off, meta_is, meta_ps;
  int sbuf_off, sbuf_is, sbuf_ps;
  int out_off, out_is;
  int scr_off, scr_is;
  int buf_off, buf_is;
  int rows, planes, cells;
  int lanes;
};
constexpr int TILE_FIELDS = 25;
static_assert(sizeof(Tile) == TILE_FIELDS * sizeof(int), "Tile is flat");
static_assert(sizeof(Prog) <= PROG_BYTES, "Prog fits its region");

struct Args {
  const int* flat;
  const uint8_t* lits;
  int* regs;      // (n, regw)
  uint8_t* sbuf;  // (rows, n, W)
  uint8_t* out;   // (n, OW)
  int* meta;      // (planes, n, cells)
  const int* perm;  // (n,): tile slot s steps row perm[s]; null: row s
  int n, regw, W, OW, K;
  Tile tl;
};

#ifdef __CUDACC__
// The one copy of the prologue that is PTX: bytes (4 or 16) from device
// memory to shared memory, asynchronously, so that a thread keeps many in
// flight; copy_async_wait waits for the calling thread's copies.
__device__ __forceinline__ void copy_async(void* s, const void* g,
                                           int bytes) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                 "l"(g) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

// The long padded rows of `stage` (shared rows 4-byte but not 16-byte
// aligned, at least WORD_ROW bytes), `words` words each: each warp takes a
// whole row in turn, its lanes neighbouring words (lane l words l, l + 32,
// ...), so one warp instruction moves 128 contiguous bytes of device memory
// to or from 32 consecutive shared words, 32 banks. The row's index and
// addresses are worked out once a row, for at least four instructions.
// IN copies asynchronously; out loads up to four words a lane from shared
// memory before it stores them.
template <bool IN>
__device__ __forceinline__ void stage_words(uint32_t* s, uint32_t* g,
                                            int planes, size_t gps,
                                            const int* rows, int cnt,
                                            int words, int sps, int sis,
                                            int t, int nt) {
  const int lane = t % WARP, warps = nt / WARP;
  int p = t / WARP / cnt, i = t / WARP % cnt;
  while (p < planes) {
    const size_t r = rows ? (size_t)rows[i] : (size_t)i;
    uint32_t* gw = g + (size_t)p * gps + r * words;
    uint32_t* sw = s + (size_t)p * sps + (size_t)i * sis;
    if (IN) {
#pragma unroll 4
      for (int w = lane; w < words; w += WARP) copy_async(sw + w, gw + w, 4);
    } else {
      for (int w = lane; w < words; w += 4 * WARP) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w + j * WARP < words) v[j] = sw[w + j * WARP];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w + j * WARP < words) gw[w + j * WARP] = v[j];
      }
    }
    for (i += warps; i >= cnt; i -= cnt) ++p;
  }
}

// Copy `planes` planes of cnt rows of len bytes between the batch and the
// tile, block-wide (thread t of nt). In the batch, plane p's rows lie back
// to back from g + p * gps, and row i of the tile is the batch's row
// rows[i] (row i where rows is null); in shared memory row i of plane p is
// at s + p * sps + i * sis. A padded row (shared address only 4-aligned)
// of at least WORD_ROW bytes moves a word a lane, a warp a row
// (`stage_words`). Otherwise neighbouring threads take neighbouring units
// of a row, which costs a thread one row lookup a unit: 16 bytes where the
// alignment allows, else 4, else 1; a 16-byte unit of a shorter padded row
// moves as four words. IN copies asynchronously (the caller waits); out is
// plain stores.
template <bool IN>
__device__ __forceinline__ void stage(uint8_t* s, uint8_t* g, int planes,
                                      size_t gps, const int* rows, int cnt,
                                      int len, int sps, int sis, int t,
                                      int nt) {
  if (planes <= 0 || cnt <= 0 || len <= 0) return;
  const uintptr_t ga = (uintptr_t)g | (uintptr_t)gps;
  const uintptr_t sa = (uintptr_t)s | (uintptr_t)sps | (uintptr_t)sis;
  const bool whole = (sa & 15) == 0;
  int u = 1;
  if ((len & 3) == 0 && (ga & 3) == 0 && (sa & 3) == 0) {
    if (!whole && len >= WORD_ROW) {
      stage_words<IN>(reinterpret_cast<uint32_t*>(s),
                      reinterpret_cast<uint32_t*>(g), planes, gps / 4, rows,
                      cnt, len / 4, sps / 4, sis / 4, t, nt);
      return;
    }
    u = ((len & 15) == 0 && (ga & 15) == 0) ? 16 : 4;
  }
  const int per = len / u, total = planes * cnt * per;
  // unit q is unit k of row i of plane p; from one of this thread's units
  // to the next is nt units: di rows and dk units on
  int p = t / (cnt * per), i = t % (cnt * per) / per, k = t % per;
  const int di = nt / per, dk = nt % per;
#pragma unroll 4
  for (int q = t; q < total; q += nt) {
    const size_t r = rows ? (size_t)rows[i] : (size_t)i;
    uint8_t* gq = g + (size_t)p * gps + (r * per + k) * u;
    uint8_t* sq = s + (size_t)p * sps + (size_t)i * sis + (size_t)k * u;
    k += dk;
    i += di;
    if (k >= per) {
      k -= per;
      ++i;
    }
    while (i >= cnt) {
      i -= cnt;
      ++p;
    }
    if (u == 1) {
      if (IN) *sq = *gq;
      else *gq = *sq;
    } else if (IN) {
      if (u == 16 && !whole) {
        for (int w = 0; w < u; w += 4) copy_async(sq + w, gq + w, 4);
      } else {
        copy_async(sq, gq, u);
      }
    } else if (u == 16) {
      uint4 v;
      if (whole) {
        v = *reinterpret_cast<const uint4*>(sq);
      } else {
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(sq);
        v.x = sw[0];
        v.y = sw[1];
        v.z = sw[2];
        v.w = sw[3];
      }
      *reinterpret_cast<uint4*>(gq) = v;
    } else {
      *reinterpret_cast<uint32_t*>(gq) =
          *reinterpret_cast<const uint32_t*>(sq);
    }
  }
}

// The tile's register, meta, string and output rows (the cnt batch rows
// that the tile's row indices at idx_off name), into shared memory or back.
template <bool IN>
__device__ __forceinline__ void stage_state(const Args& a, int cnt, int t,
                                            int nt, uint8_t* sm) {
  const Tile& tl = a.tl;
  const int* rows = reinterpret_cast<const int*>(sm + tl.idx_off);
  const size_t n = (size_t)a.n, rb = 4 * (size_t)a.regw,
               cb = 4 * (size_t)tl.cells;
  stage<IN>(sm + tl.regs_off, reinterpret_cast<uint8_t*>(a.regs), 1, 0, rows,
            cnt, (int)rb, 0, tl.regs_is, t, nt);
  stage<IN>(sm + tl.meta_off, reinterpret_cast<uint8_t*>(a.meta), tl.planes,
            n * cb, rows, cnt, (int)cb, tl.meta_ps, tl.meta_is, t, nt);
  stage<IN>(sm + tl.sbuf_off, a.sbuf, tl.rows, n * a.W, rows, cnt, a.W,
            tl.sbuf_ps, tl.sbuf_is, t, nt);
  stage<IN>(sm + tl.out_off, a.out, 1, 0, rows, cnt, a.OW, 0, tl.out_is, t,
            nt);
}

__device__ __forceinline__ int tile_rows(const Args& a, int b) {
  return min(a.tl.tile, a.n - b * a.tl.tile);
}

// Phase 0, per thread: this thread's tile slot takes its batch row
// (perm[slot], or the slot itself), noted in the tile's row indices; is
// that instance RUNNING at entry? A block none of whose instances is stages
// nothing.
__device__ __forceinline__ bool running_at_entry(const Args& a, int b, int t,
                                                 uint8_t* sm) {
  if (t >= tile_rows(a, b)) return false;
  const int slot = b * a.tl.tile + t;
  const int i = a.perm ? a.perm[slot] : slot;
  reinterpret_cast<int*>(sm + a.tl.idx_off)[t] = i;
  return a.regs[(size_t)i * a.regw + C_STATUS] == RUNNING;
}

// Phase 1, block-wide: thread 0 parses the header once for the block into
// the Prog at 0 (its tables point into shared memory); every thread copies
// its share of the tables and of the tile's state.
__device__ __forceinline__ void stage_in(const Args& a, int b, int t, int nt,
                                         uint8_t* sm) {
  const Tile& tl = a.tl;
  if (t == 0) {
    const int* h = a.flat;
    const int* f = reinterpret_cast<const int*>(sm + tl.flat_off);
    Prog g;
    g.P = h[0];
    g.E = h[3];
    g.ew = h[4];
    g.pack = h[5];
    g.nt = h[6];
    g.ins = f + h[OFF0 + 0];
    g.segs = f + h[OFF0 + 1];
    g.ents = f + h[OFF0 + 2];
    g.rpn = f + h[OFF0 + 3];
    g.ints = f + h[OFF0 + 4];
    g.pairs = f + h[OFF0 + 5];
    g.elems = f + h[OFF0 + 6];
    g.slots = f + h[OFF0 + 7];
    g.lit_len = f + h[OFF0 + 8];
    g.items = f + h[OFF0 + 9];
    g.dpairs = f + h[OFF0 + 10];
    g.lits = tl.lits_off >= 0 ? sm + tl.lits_off : a.lits;
    g.W = a.W;
    *reinterpret_cast<Prog*>(sm) = g;
  }
  stage<true>(sm + tl.flat_off,
              reinterpret_cast<uint8_t*>(const_cast<int*>(a.flat)), 1, 0,
              nullptr, 1, tl.flat_bytes, 0, 0, t, nt);
  if (tl.lits_off >= 0)
    stage<true>(sm + tl.lits_off, const_cast<uint8_t*>(a.lits), 1, 0,
                nullptr, 1, tl.lits_bytes, 0, 0, t, nt);
  stage_state<true>(a, tile_rows(a, b), t, nt, sm);
  copy_async_wait();
}

// Phase 2, per lane group: up to K steps of tile slot t / G's instance, on
// shared memory. Returning early is stopping: no block barrier inside, and
// a group's lanes stop together.
template <int G>
__device__ __forceinline__ void run(const Args& a, int b, int t,
                                    uint8_t* sm) {
  const Tile& tl = a.tl;
  if (t / G >= tile_rows(a, b)) return;
  const Prog g = *reinterpret_cast<const Prog*>(sm);
  const size_t at = t / G;
  const Lane L{reinterpret_cast<int*>(sm + tl.regs_off + at * tl.regs_is),
               sm + tl.sbuf_off + at * tl.sbuf_is, (size_t)tl.sbuf_ps,
               sm + tl.out_off + at * tl.out_is,
               reinterpret_cast<int*>(sm + tl.meta_off + at * tl.meta_is),
               (size_t)tl.meta_ps / 4, sm + tl.scr_off + at * tl.scr_is};
  uint8_t* buf = sm + tl.buf_off + at * tl.buf_is;
  for (int k = 0; k < a.K; ++k) {
    if (L.regs[C_STATUS] != RUNNING) return;
    const int pc = L.regs[C_PC];
    if (pc < 0 || pc >= g.P) return;
    step<G>(g, L, pc, buf, a.OW);
    lane_yield(g, L);
  }
}

// Phase 3, block-wide: the tile back to the batch, once.
__device__ __forceinline__ void stage_out(const Args& a, int b, int t, int nt,
                                          uint8_t* sm) {
  stage_state<false>(a, tile_rows(a, b), t, nt, sm);
}

// The kernel's arguments from the launch's; false when out of range.
bool make_args(Args* a, const int* flat, const uint8_t* lits, int* regs,
               uint8_t* sbuf, uint8_t* out, int* meta, const int* perm, int n,
               int regw, int width, int out_width, int k_steps,
               const int* plan, int plan_len) {
  if (plan_len != TILE_FIELDS || width <= 0 || width > MAX_W) return false;
  *a = Args{flat, lits, regs, sbuf, out, meta, perm, n, regw, width,
            out_width, k_steps, Tile{}};
  memcpy(&a->tl, plan, sizeof(Tile));
  const bool lanes = a->tl.lanes == 1 ||
                     (a->tl.lanes == WARP && a->tl.tile * WARP <= MAX_TILE);
  return lanes && a->tl.tile > 0 && a->tl.tile <= MAX_TILE &&
         a->tl.smem >= PROG_BYTES && a->tl.idx_off >= PROG_BYTES &&
         a->tl.idx_off % 4 == 0;
}

#ifdef __CUDACC__
// One block of MAX_TILE threads per tile of T instances: all of them stage,
// then the first T lane groups of G step one instance each (more warps than
// instances keep more copies in flight). Every thread reaches every
// barrier: a thread with nothing to step skips `run` only.
template <int G>
__global__ void __launch_bounds__(MAX_TILE)
    turbo_step_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  if (!__syncthreads_or(running_at_entry(a, b, t, smem))) return;
  stage_in(a, b, t, nt, smem);
  __syncthreads();
  run<G>(a, b, t, smem);
  __syncthreads();
  stage_out(a, b, t, nt, smem);
}
#endif

}  // namespace

static_assert(HEADER == 32 && OFF0 + 11 <= HEADER, "flat header size");

#ifdef __CUDACC__
constexpr int MAX_DEVICES = 64;

// Launch on `stream` with the tile plan `plan` (TILE_FIELDS ints, host
// memory), tile slot s stepping row perm[s] (perm: n ints in device memory,
// a permutation of the rows; null: row s), each row stepped by a lane group
// of the plan's `lanes`: one kernel, turbo_step_kernel<1> or <WARP>.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// plan the kernel cannot take (`lanes` neither 1 nor WARP, or WARP where
// the tile's groups pass MAX_TILE threads).
extern "C" int turbo_step_launch(const int* flat, const uint8_t* lits,
                                 int* regs, uint8_t* sbuf, uint8_t* out,
                                 int* meta, const int* perm, int n, int regw,
                                 int width, int out_width, int k_steps,
                                 const int* plan, int plan_len,
                                 void* stream) {
  if (n <= 0 || k_steps <= 0) return 0;
  Args a;
  if (!make_args(&a, flat, lits, regs, sbuf, out, meta, perm, n, regw, width,
                 out_width, k_steps, plan, plan_len))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  // dynamic shared memory above 48 KB needs the opt-in, once per device and
  // kernel function
  static bool opted[MAX_DEVICES];
  if (!opted[dev]) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(turbo_step_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(turbo_step_kernel<WARP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const int grid = (n + a.tl.tile - 1) / a.tl.tile;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.tl.lanes == WARP)
    turbo_step_kernel<WARP><<<grid, MAX_TILE, a.tl.smem, st>>>(a);
  else
    turbo_step_kernel<1><<<grid, MAX_TILE, a.tl.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The attributes of the compiled kernel for lane groups of `lanes` (1 or
// WARP) on the current device: registers per thread, local (stack) bytes
// per thread, static shared bytes, the most threads a block may have and
// the dynamic shared bytes allowed now.
extern "C" int turbo_step_attributes(int lanes, int* out5) {
  if (lanes != 1 && lanes != WARP) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e =
      lanes == WARP ? cudaFuncGetAttributes(&fa, turbo_step_kernel<WARP>)
                    : cudaFuncGetAttributes(&fa, turbo_step_kernel<1>);
  if (e != cudaSuccess) return (int)e;
  out5[0] = fa.numRegs;
  out5[1] = (int)fa.localSizeBytes;
  out5[2] = (int)fa.sharedSizeBytes;
  out5[3] = fa.maxThreadsPerBlock;
  out5[4] = fa.maxDynamicSharedSizeBytes;
  return 0;
}

// The current device's shared memory in bytes: on each SM, the most one
// block may take (the opt-in), and what stays reserved for each resident
// block (ops/turbo_step.py SharedMemory).
extern "C" int turbo_shared_memory(int* out3) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out3[0],
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out3[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out3[2],
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return (int)e;
}

extern "C" const char* turbo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
