// Chat stream filter kernel for Hopper (sm_90a): per stream, the outputs
// table and the visual text that the host filters give when they are fed
// one character at a time.
//
// Replaces interpolation_engine_tpu/ops/filter_kernel.py, `filter_chat_text`
// (:155), which the JAX package runs under vmap as XLA (no pallas_call): a
// lax.scan state machine over byte positions for each of its two passes,
// vectorized match masks, a hold-back mask and a scatter compaction.
//
// For stream r of bufs (N, L) uint8 with lengths (N,) int32 it writes
//   ext[r]    (L bytes)  the bytes kept by the extract pass, zero-padded;
//   vis[r]    (W bytes)  the visual text, zero-padded (W >= L + 85 holds
//                        every stream: the markers of 16 spans take 85);
//   table[r]  (TABLE int32) span_off[16], span_len[16], n_spans (clipped to
//                        MAX_SPANS), raw_n_spans, visual_len.
// A length below 0 counts as 0, one above L as L.
//
// Semantics (the JAX function's, line numbers of ops/filter_kernel.py):
//   * extract (:53): alternating start/stop spans. A delimiter matches only
//     entirely within the length (:49-50) and only at a byte no matched
//     delimiter has consumed (the skip countdown, :62-73). Either delimiter
//     empty: passthrough, one output, none for an empty stream (:174-186).
//   * hold-back (:105-122): at the end, while the filter is shown, the
//     longest trailing proper prefix of the pending delimiter (stop here,
//     hide_start in the hide pass) that has no consumed byte never flushes.
//   * the intermediate stream (:204-231): when enumerating (and not in
//     passthrough) marker k ("1. ", "\n\n2. ", ...) opens span k, for the
//     first MAX_SPANS spans; else the extracted bytes as they are.
//   * hide (:84, :233-244): hide_start..hide_stop spans removed from that
//     stream, only when both hide delimiters are non-empty.
// Delimiters are data of any length (no cap here).
//
// What bounds it on this card: device-memory bytes. A call must read each
// stream's bytes within its length and write ext, vis and the table once,
// with a few integer operations a byte; the padded writes are most of it.
//
// The first design gave each stream one thread: rows L bytes apart read a
// byte at a time did not coalesce, a warp waited for its longest stream,
// the card held about 4 warps an SM, and one stream (the chat service's
// call) ran on one thread. This design gives each stream a block of BLOCK
// threads that walks it in tiles of 16 BLOCK bytes, so the chat service's
// one stream runs on a whole block. Blocks are scheduled as they finish,
// so a long stream holds up no other. Per tile, with the block's barrier
// between the phases:
//   1. stage_tile: each thread copies its 16-byte units of the tile (the
//      stream's aligned units; the ragged ends byte by byte) into shared
//      memory with one 16-byte load, and marks where either delimiter
//      matches in them: a compare of four bytes at a time against the first
//      bytes, then the whole delimiter from device memory (its bytes may lie
//      in other units or past the tile; the tile's loads put them in L1),
//      into the unit's bucket of the candidate list, with the unit's bit in
//      a mask;
//   2. resolve (thread 0): the alternating machine over the matches only,
//      in order: the state changes only at a match, and one inside a
//      consumed delimiter is skipped. It carries the state across tiles
//      (shown, the end of the last consumed delimiter, the spans) and turns
//      the tile into kept runs with their positions in the outputs, so no
//      scan of the bytes is needed; it writes the enumeration markers;
//   3. compact: each thread copies its units' kept bytes into the outputs'
//      rings in shared memory;
//   and, in phase 1 of the next tile, while its loads are in flight,
//   flush: the ringed bytes up to the last 16-byte boundary of each output
//   row go to device memory as aligned 16-byte stores; the rest waits in
//   the ring.
// After the last tile, thread 0 applies the hold-back to the lengths (the
// held bytes are the outputs' tail: the padding then overwrites any that
// were stored), and the block stores the ringed tail and the zero padding,
// 16 bytes a store. The hide pass runs the same tiles over the visual row
// in place (its output never overtakes its input, and the intermediate
// stream is still in L2), then the block writes the table.
//
// nvcc -Xptxas -v (sm_90a): 50 registers, 27,040 static shared bytes, a
// 16-byte stack frame, no spill; eight blocks fit an SM. What still holds
// it is latency, not bytes: each tile's serial resolve and barriers, the
// hide pass's second walk, and at large batches eight streams in flight
// on an SM (PERF.md has the times, by part).
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__: a host compiler builds a stream's block (`filter_block`) with
// EACH running each phase for every thread in turn, as the barriers order
// them; the CPU tests (tests/test_torch_filter_tile.py) run it that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_SPANS = 16;             // outputs a stream's table holds
constexpr int TABLE = 2 * MAX_SPANS + 3;  // int32 a stream in `table`
constexpr int BLOCK = 128;                // threads a block, one stream
constexpr int FIRST = 1, SECOND = 2;  // which delimiter a candidate starts

// The tile, 16 bytes a thread.
constexpr int TILE = 16 * BLOCK;           // bytes of a stream a tile
constexpr int UNITS = TILE / 16 + 1;       // 16-byte units it touches
constexpr int MASK_WORDS = (UNITS + 31) / 32;
// an output's ring: what a tile adds (TILE bytes and the markers, 85)
// beside what waits from the tile before (under 16 bytes)
constexpr int RING = 2 * TILE;
constexpr int RMASK = RING - 1;
// kept runs a tile: two runs are at least one consumed byte apart
constexpr int MAX_RUNS = TILE / 2 + 1;
static_assert((RING & RMASK) == 0 && RING >= TILE + 128, "ring");

#ifdef __CUDACC__
// A phase: this thread's part, then the block's barrier.
#define EACH(t)                                                        \
  for (int t = threadIdx.x, once_ = 1; once_; once_ = 0, __syncthreads())
#else
#define EACH(t) for (int t = 0; t < BLOCK; ++t)
#endif

struct Delim {
  const uint8_t* p;
  int n;
};

struct FilterArgs {
  const uint8_t* bufs;
  const int* lengths;
  int n, L, W;
  Delim start, stop, hide_start, hide_stop;
  int enumerate;
  uint8_t* ext;
  uint8_t* vis;
  int* table;
};

// An output row being written: positions [0, have) are produced; those
// below `done` are in device memory, [done, have) in the output's ring at
// index (pos + skew) & RMASK. dst - skew is the row's last 16-byte boundary
// at or before it, and done starts at -skew, so a flush stores whole
// aligned units: [done, end).
struct Out {
  uint8_t* dst;
  int skew, done, end, have;
};

// A kept run [t0 + lo, t0 + hi) of the tile from t0, and the positions of
// its first byte in output 0 and output 1 (-1: not in output 1).
struct Run {
  uint16_t lo, hi;
  int off0, off1;
};

// One pass of the alternating machine over src[0, n): `first` toggles from
// the initial state, `second` back; a byte is kept while shown (shown0 xor
// toggled) and not consumed by a matched delimiter. The extract pass counts
// spans and writes two outputs (ext, and the intermediate stream with its
// markers when enumerating); the hide pass writes one.
struct Pass {
  const uint8_t* src;
  int n;
  Delim first, second;
  int shown0, extract, enumerate, outs;
};

// A stream's shared memory.
struct alignas(16) Block {
  uint8_t in[16 * UNITS];  // the tile: position pos at pos - (t0 - skew)
  uint8_t ring[2][RING];
  Run runs[MAX_RUNS];
  uint16_t cand[16 * UNITS];  // unit u's at 16 u: (pos - base) << 2 | flags
  uint8_t cnt[UNITS];
  uint32_t mask[MASK_WORDS];  // units with a candidate
  Pass p;
  Out out[2];
  int span_len[MAX_SPANS];
  int toggled, free_at, spans, nruns, skew;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// floor(x / 16) for any sign
__device__ __forceinline__ int floor16(int x) {
  return x >= 0 ? x / 16 : -((15 - x) / 16);
}

// The top bit of each byte of w that equals the byte of `pattern` (four
// copies of one byte), exactly (csrc/brace_scan.cu's compare).
__device__ __forceinline__ uint32_t byte_eq(uint32_t w, uint32_t pattern) {
  const uint32_t y = w ^ pattern;
  return ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
}

// The top bits of bytes [a, b) of a word, a and b clamped to [0, 4].
__device__ __forceinline__ uint32_t byte_range(int a, int b) {
  a = imin(imax(a, 0), 4);
  b = imin(imax(b, 0), 4);
  return (uint32_t)(((1ull << (8 * b)) - (1ull << (8 * a))) & 0x80808080u);
}

__device__ __forceinline__ void out_begin(Out& o, uint8_t* dst) {
  o.dst = dst;
  o.skew = (int)((uintptr_t)dst & 15);
  o.done = o.end = -o.skew;
  o.have = 0;
}

// Marker k (0-based, k < MAX_SPANS): "1. ", then "\n\n2. ", "\n\n3. ", ...
__device__ __forceinline__ int put_marker(uint8_t* out, int k) {
  int m = 0;
  if (k > 0) {
    out[m++] = '\n';
    out[m++] = '\n';
  }
  const int v = k + 1;
  if (v >= 10) out[m++] = (uint8_t)('0' + v / 10);
  out[m++] = (uint8_t)('0' + v % 10);
  out[m++] = '.';
  out[m++] = ' ';
  return m;
}

__device__ __forceinline__ void machine_begin(Block& s) {
  s.toggled = 0;
  s.free_at = 0;
  s.skew = (int)((uintptr_t)s.p.src & 15);
  for (int w = 0; w < MASK_WORDS; ++w) s.mask[w] = 0;
}

// Thread 0: the stream's length and the extract pass's state.
__device__ __forceinline__ void stream_begin(const FilterArgs& a, int r,
                                             Block& s) {
  const int len = a.lengths[r];
  const int n = len < 0 ? 0 : (len > a.L ? a.L : len);
  const bool passthrough = a.start.n == 0 || a.stop.n == 0;
  Pass& p = s.p;
  p.src = a.bufs + (size_t)r * a.L;
  p.n = n;
  p.first = Delim{a.start.p, passthrough ? 0 : a.start.n};
  p.second = Delim{a.stop.p, passthrough ? 0 : a.stop.n};
  p.shown0 = passthrough;  // passthrough: shown throughout, one span
  p.extract = 1;
  p.enumerate = a.enumerate && !passthrough;
  p.outs = 2;
  out_begin(s.out[0], a.ext + (size_t)r * a.L);
  out_begin(s.out[1], a.vis + (size_t)r * a.W);
  machine_begin(s);
  s.spans = passthrough && n > 0;
  for (int k = 0; k < MAX_SPANS; ++k) s.span_len[k] = 0;
}

// Thread 0: the hide pass over the intermediate stream, in place in vis.
__device__ __forceinline__ void hide_begin(const FilterArgs& a,
                                           Block& s) {
  Pass& p = s.p;
  p.src = s.out[1].dst;
  p.n = s.out[1].have;
  p.first = a.hide_start;
  p.second = a.hide_stop;
  p.shown0 = 1;
  p.extract = 0;
  p.enumerate = 0;
  p.outs = 1;
  out_begin(s.out[0], s.out[1].dst);
  machine_begin(s);
}

// d occurs at pos of src[0, n), whose first byte is d's first.
__device__ __forceinline__ bool rest_matches(const uint8_t* src, int n,
                                             int pos, const Delim& d) {
  if (d.n > n - pos) return false;
  for (int j = 1; j < d.n; ++j)
    if (src[pos + j] != d.p[j]) return false;
  return true;
}

// Phase 1: this thread's units of the tile [t0, t1) into shared memory
// (unit u holds the stream's aligned 16 bytes from base + 16 u), and their
// matches in their buckets.
__device__ __forceinline__ void stage_tile(Block& s, int t0, int t) {
  const uint8_t* src = s.p.src;
  const int n = s.p.n, t1 = imin(t0 + TILE, n), base = t0 - s.skew;
  const Delim first = s.p.first, second = s.p.second;
  const uint32_t f4 = first.n ? 0x01010101u * first.p[0] : 0;
  const uint32_t s4 = second.n ? 0x01010101u * second.p[0] : 0;
  for (int u = t; u < UNITS; u += BLOCK) {
    const int at = base + 16 * u;
    const int lo = imax(t0, at), hi = imin(t1, at + 16);
    if (lo >= hi) continue;
    uint4* unit = reinterpret_cast<uint4*>(s.in + 16 * u);
    uint4 v;
    if (hi - lo == 16) {
      v = *reinterpret_cast<const uint4*>(src + lo);
      *unit = v;
    } else {
      for (int q = lo; q < hi; ++q) s.in[q - base] = src[q];
      v = *unit;  // this thread's own bytes; the rest are masked off
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t valid = byte_range(lo - at - 4 * k, hi - at - 4 * k);
      const uint32_t fh = first.n ? byte_eq(w[k], f4) & valid : 0;
      const uint32_t sh = second.n ? byte_eq(w[k], s4) & valid : 0;
      for (uint32_t hits = fh | sh; hits; hits &= hits - 1) {
        const int bit = __ffs((int)hits) - 1;
        const int pos = at + 4 * k + (bit >> 3);
        int f = 0;
        if ((fh >> bit) & 1 && rest_matches(src, n, pos, first)) f |= FIRST;
        if ((sh >> bit) & 1 && rest_matches(src, n, pos, second)) f |= SECOND;
        if (f) s.cand[16 * u + c++] = (uint16_t)(((pos - base) << 2) | f);
      }
    }
    s.cnt[u] = (uint8_t)c;
    if (c) atomicOr(&s.mask[u >> 5], 1u << (u & 31));
  }
}

// Phase 2, thread 0: the machine over the tile's matches, in order, with
// the state in registers; the tile's kept runs, their places in the
// outputs, the markers; what each output's flush stores.
__device__ __forceinline__ void resolve(Block& s, int t0) {
  const int n = s.p.n, t1 = imin(t0 + TILE, n), base = t0 - s.skew;
  const int shown0 = s.p.shown0, extract = s.p.extract, outs = s.p.outs;
  const int enumerate = s.p.enumerate;
  const int len1 = s.p.first.n, len2 = s.p.second.n;
  const int skew1 = s.out[1].skew;
  int toggled = s.toggled, free_at = s.free_at, spans = s.spans, nruns = 0;
  int have0 = s.out[0].have, have1 = s.out[1].have;
  // the open span's length so far (extract, the first MAX_SPANS spans)
  int cur = extract && spans >= 1 && spans <= MAX_SPANS
                ? s.span_len[spans - 1] : 0;
  auto keep = [&](int lo, int hi) {
    if (hi <= lo) return;
    Run run;
    run.lo = (uint16_t)(lo - t0);
    run.hi = (uint16_t)(hi - t0);
    run.off0 = have0;
    have0 += hi - lo;
    run.off1 = -1;
    if (outs > 1 && (!enumerate || spans <= MAX_SPANS)) {
      run.off1 = have1;
      have1 += hi - lo;
    }
    s.runs[nruns++] = run;
    cur += hi - lo;
  };
  uint32_t words[MASK_WORDS];
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) {
    words[w] = s.mask[w];
    s.mask[w] = 0;
  }
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) {
    for (uint32_t bits = words[w]; bits; bits &= bits - 1) {
      const int u = 32 * w + __ffs((int)bits) - 1;
      const int cnt = s.cnt[u];
      for (int k = 0; k < cnt; ++k) {
        const int c = s.cand[16 * u + k];
        const int pos = base + (c >> 2);
        if (pos < free_at || !(c & (toggled ? SECOND : FIRST))) continue;
        if (toggled ^ shown0) keep(imax(t0, free_at), pos);
        free_at = pos + (toggled ? len2 : len1);
        toggled ^= 1;
        if (extract && toggled) {  // a span opens
          if (spans >= 1 && spans <= MAX_SPANS) s.span_len[spans - 1] = cur;
          ++spans;
          cur = 0;
          if (enumerate && spans <= MAX_SPANS) {
            uint8_t mark[8];
            const int m = put_marker(mark, spans - 1);
            for (int j = 0; j < m; ++j)
              s.ring[1][(have1 + j + skew1) & RMASK] = mark[j];
            have1 += m;
          }
        }
      }
    }
  }
  if (toggled ^ shown0) keep(imax(t0, free_at), t1);
  if (extract && spans >= 1 && spans <= MAX_SPANS) s.span_len[spans - 1] = cur;
  s.toggled = toggled;
  s.free_at = free_at;
  s.spans = spans;
  s.nruns = nruns;
  const int have[2] = {have0, have1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= outs) break;
    Out& o = s.out[k];
    const int done = o.end;  // the tile before's flush stored up to it
    o.done = done;
    o.have = have[k];
    o.end = done + ((have[k] - done) & ~15);
  }
}

// Phase 3: this thread's units' kept bytes into the outputs' rings.
__device__ __forceinline__ void compact(Block& s, int t0, int t) {
  const int t1 = imin(t0 + TILE, s.p.n), base = t0 - s.skew;
  const int nruns = s.nruns, skew0 = s.out[0].skew, skew1 = s.out[1].skew;
  for (int u = t; u < UNITS; u += BLOCK) {
    const int lo = imax(t0, base + 16 * u), hi = imin(t1, base + 16 * u + 16);
    if (lo >= hi) continue;
    int a = 0, b = nruns;  // the first run that ends past lo
    while (a < b) {
      const int m = (a + b) / 2;
      if (t0 + s.runs[m].hi <= lo)
        a = m + 1;
      else
        b = m;
    }
    for (; a < nruns; ++a) {
      const Run run = s.runs[a];
      const int rlo = t0 + run.lo;
      if (rlo >= hi) break;
      const int from = imax(lo, rlo), to = imin(hi, t0 + run.hi);
      const uint8_t* in = s.in + (from - base);
      const int d0 = run.off0 + (from - rlo) + skew0;
      for (int j = 0; j < to - from; ++j)
        s.ring[0][(d0 + j) & RMASK] = in[j];
      if (run.off1 >= 0) {
        const int d1 = run.off1 + (from - rlo) + skew1;
        for (int j = 0; j < to - from; ++j)
          s.ring[1][(d1 + j) & RMASK] = in[j];
      }
    }
  }
}

// The ringed units [done, end) to device memory (the tile before's, in
// phase 1).
__device__ __forceinline__ void flush(Block& s, int t) {
  for (int k = 0; k < s.p.outs; ++k) {
    const Out o = s.out[k];
    for (int u = t; u < (o.end - o.done) >> 4; u += BLOCK) {
      const int pos = o.done + 16 * u;
      const uint8_t* src = s.ring[k] + ((pos + o.skew) & RMASK);
      if (pos >= 0)
        *reinterpret_cast<uint4*>(o.dst + pos) =
            *reinterpret_cast<const uint4*>(src);
      else  // the unit before the row's first byte: its part in the row
        for (int j = -pos; j < 16; ++j) o.dst[pos + j] = src[j];
    }
  }
}

// Byte q of output k, ringed or already stored.
__device__ __forceinline__ uint8_t out_byte(const Block& s, int k,
                                            int q) {
  const Out& o = s.out[k];
  return q >= o.done ? s.ring[k][(q + o.skew) & RMASK] : o.dst[q];
}

// Thread 0, after the last tile (whose bytes finish stores, from `done`):
// the hold-back while shown. The held bytes are the tail of output 0: the
// longest s < d.n, at most `free` (the trailing bytes no match consumed,
// all kept), whose last s bytes are d's first s.
__device__ __forceinline__ void pass_end(Block& s) {
  const Pass& p = s.p;
  if (!(s.toggled ^ p.shown0)) return;
  const Delim& d = s.toggled ? p.second : p.first;
  const int have = s.out[0].have;
  int best = 0;
  for (int n = imin(d.n - 1, p.n - s.free_at); n >= 1 && !best; --n) {
    int j = 0;
    while (j < n && out_byte(s, 0, have - n + j) == d.p[j]) ++j;
    if (j == n) best = n;
  }
  s.out[0].have -= best;
  if (p.extract) {
    if (s.spans >= 1 && s.spans <= MAX_SPANS) s.span_len[s.spans - 1] -= best;
    if (!p.enumerate || s.spans <= MAX_SPANS) s.out[1].have -= best;
  }
}

// Output k's bytes from min(done, have) to cap: the ringed ones below
// have, zeros from have on (over any held-back bytes a flush stored); whole
// aligned units as 16-byte stores, those wholly past have (the padding) in
// a loop of their own.
__device__ __forceinline__ void finish(const Block& s, int k, int cap,
                                       int t) {
  const Out o = s.out[k];
  const uint8_t* ring = s.ring[k];
  const int F = o.have, lo = imax(0, imin(o.done, F));
  if (lo >= cap) return;
  // the first unit wholly at or past F, and the last whole unit's end
  const int zf = o.done + 16 * floor16(F - o.done + 15);
  const int zl = imax(zf, o.done + 16 * floor16(cap - o.done));
  for (int at = zf + 16 * t; at + 16 <= cap; at += 16 * BLOCK)
    *reinterpret_cast<uint4*>(o.dst + at) = make_uint4(0, 0, 0, 0);
  for (int q = zl + t; q < cap; q += BLOCK) o.dst[q] = 0;
  const int u0 = floor16(lo - o.done);
  const int u1 = floor16(imin(zf, cap) - o.done + 15);
  for (int u = u0 + t; u < u1; u += BLOCK) {
    const int at = o.done + 16 * u;
    const int from = imax(at, lo), to = imin(at + 16, cap);
    if (from == at && to == at + 16) {
      uint4 v;
      if (at >= o.done && at + 16 <= F) {
        v = *reinterpret_cast<const uint4*>(ring + ((at + o.skew) & RMASK));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int j = 0; j < 16 && at + j < F; ++j)
          w[j >> 2] |= (uint32_t)ring[(at + j + o.skew) & RMASK]
                       << (8 * (j & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(o.dst + at) = v;
    } else {
      for (int q = from; q < to; ++q)
        o.dst[q] = q < F ? ring[(q + o.skew) & RMASK] : 0;
    }
  }
}

// The table, an int at a time.
__device__ __forceinline__ void write_table(const FilterArgs& a, int r,
                                            const Block& s, bool hid,
                                            int t) {
  for (int i = t; i < TABLE; i += BLOCK) {
    int v;
    if (i < MAX_SPANS) {  // span_off (JAX's passthrough offsets are 0)
      v = 0;
      if (a.start.n && a.stop.n)
        for (int k = 0; k < i; ++k) v += s.span_len[k];
    } else if (i < 2 * MAX_SPANS) {
      v = s.span_len[i - MAX_SPANS];
    } else if (i == 2 * MAX_SPANS) {
      v = s.spans < MAX_SPANS ? s.spans : MAX_SPANS;
    } else if (i == 2 * MAX_SPANS + 1) {
      v = s.spans;
    } else {
      v = s.out[hid ? 0 : 1].have;
    }
    a.table[(size_t)r * TABLE + i] = v;
  }
}

// The tiles of the current pass, and its end.
__device__ __forceinline__ void run_pass(Block& s) {
  for (int t0 = 0; t0 < s.p.n; t0 += TILE) {
    EACH(t) {
      flush(s, t);  // the tile before's, while this one loads
      stage_tile(s, t0, t);
    }
    EACH(t) if (t == 0) resolve(s, t0);
    EACH(t) compact(s, t0, t);
  }
  EACH(t) if (t == 0) pass_end(s);
}

// Stream r, the whole block.
__device__ __forceinline__ void filter_block(const FilterArgs& a, int r,
                                             Block& s) {
  const bool hid = a.hide_start.n && a.hide_stop.n;
  EACH(t) if (t == 0) stream_begin(a, r, s);
  run_pass(s);
  EACH(t) {
    finish(s, 0, a.L, t);
    finish(s, 1, hid ? s.out[1].have : a.W, t);  // the hide pass reads it
    if (!hid) write_table(a, r, s, hid, t);
  }
  if (hid) {
    EACH(t) if (t == 0) hide_begin(a, s);
    run_pass(s);
    EACH(t) {
      finish(s, 0, a.W, t);
      write_table(a, r, s, hid, t);
    }
  }
}

#ifdef __CUDACC__
// Stream blockIdx.x.
__global__ void __launch_bounds__(BLOCK) chat_filter_kernel(
    const FilterArgs a) {
  __shared__ Block s;
  filter_block(a, blockIdx.x, s);
}
#endif

}  // namespace

// MAX_SPANS, TABLE and the tile, for the wrapper and the tests.
extern "C" int chat_filter_layout(int* out3) {
  out3[0] = MAX_SPANS;
  out3[1] = TABLE;
  out3[2] = TILE;
  return 0;
}

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success). The four
// delimiters lie back to back at `delims` (start, stop, hide_start,
// hide_stop), their lengths in `dlen`. W must be at least L + 85.
extern "C" int chat_filter_launch(const uint8_t* bufs, const int* lengths,
                                  int n, int L, int W, const uint8_t* delims,
                                  int start_len, int stop_len, int hs_len,
                                  int he_len, int enumerate, uint8_t* ext,
                                  uint8_t* vis, int* table, void* stream) {
  if (n <= 0) return 0;
  if (L < 0 || W < L + 85 || start_len < 0 || stop_len < 0 || hs_len < 0 ||
      he_len < 0)
    return (int)cudaErrorInvalidValue;
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
  const cudaStream_t st = (cudaStream_t)stream;
  chat_filter_kernel<<<(unsigned)n, BLOCK, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's attributes: registers, local bytes a thread, static shared
// bytes and threads a block (cudaFuncGetAttributes).
extern "C" int chat_filter_attributes(int* out4) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, chat_filter_kernel);
  if (e != cudaSuccess) return (int)e;
  out4[0] = fa.numRegs;
  out4[1] = (int)fa.localSizeBytes;
  out4[2] = (int)fa.sharedSizeBytes;
  out4[3] = fa.maxThreadsPerBlock;
  return 0;
}
#endif
