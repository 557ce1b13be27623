// Brace scan kernel for Hopper (sm_90a): per string, the four numbers one
// step of the interpolation loop needs.
//
// Replaces the TPU brace scan of interpolation_engine_tpu/ops/pallas_scan.py,
// `_scan_kernel` (:87), in both of its calls: `_scan_call_one` (one string
// per call under vmap, pl.pallas_call at :79) and `brace_scan_pallas` (256
// strings per grid step, pl.pallas_call at :134). In a batched port the
// per-lane call is the batched one, so one kernel serves both.
//
// For row r of bufs (N, MS) uint8 and lengths (N,) int32 it writes
// out[r] = (n_open, n_close, outer_from, inner_to):
//   n_open / n_close  visible '{' / '}' in [0, length);
//   outer_from        the rightmost visible '{', or -1;
//   inner_to          the first visible '}' strictly after outer_from
//                     (anywhere when outer_from is -1), or -1.
// A brace is hidden when the byte before it is a backslash; at position 0
// there is no byte before it. Bytes at or past length count for nothing;
// a length below 0 counts as 0 and one above MS as MS.
//
// What bounds it on this card: device-memory bytes. A call reads each row's
// MS bytes and its length once and writes 16 bytes a row, and does a few
// integer operations per byte. The first design (one warp per row, one byte
// a lane, warp reductions, a second pass after outer_from, the byte before
// each brace read again) reached 12-13 % of that bound.
//
// Design. One block of ROWS threads takes a tile of ROWS consecutive rows,
// one thread a row:
//   1. copy: the tile's rows (a slice of CHUNK bytes of each row at a time
//      when MS is wider) go to shared memory in 16-byte loads, BATCH in
//      flight a thread, neighbouring threads on neighbouring addresses. When
//      the slice is the whole row the tile is one contiguous range of device
//      memory, copied by the whole block; a slice of a wider row is a
//      contiguous range per row, copied by a group of CHUNK / 16 threads. A
//      range's ragged head (before its first 16-byte aligned address) and
//      tail go byte by byte, so neither the base pointer nor MS need be
//      aligned. In shared memory the rows lie an odd number of words apart,
//      so 32 threads reading word j of 32 rows hit 32 banks;
//   2. scan: each thread reads its row a word at a time, in one pass, and
//      keeps in registers the counts, the word that holds the rightmost
//      visible '{' so far and the '}' after it: a word with a '{' restarts
//      the '}' mask with the '}' above its last '{', and a word without one
//      sets it only while it is empty. Four bytes at a time: an exact SWAR
//      compare against '{', '}' and '\\' gives the top bit of each matching
//      byte; "after a '\\'" is the backslash mask shifted up a byte with the
//      previous word's top byte carried in; __popc counts, __clz finds a
//      word's last '{' and __ffs the first '}' of the kept mask;
//   3. each thread writes its row's four values as one 16-byte store.
// The lengths are read one int a thread, coalesced. A barrier sits between
// copy and scan, and before each further slice; a slice no row of the tile
// reaches is not copied.
//
// Measured on an H100 (PERF.md): the copy and the scan take about
// the same time, and in a wave every block copies, then scans, so the two
// add up rather than overlap. The SWAR compare is a few instructions fewer
// a word than __vcmpeq4, and four loads in flight did better than eight
// (registers).
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the phase functions: the
// CPU tests (tests/test_torch_scan_tile.py) run them that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int ROWS = 128;   // threads a block and rows a tile
constexpr int CHUNK = 256;  // the widest slice of a row a tile holds
constexpr int BATCH = 4;    // 16-byte loads in flight a thread

// A tile's layout for rows of `ms` bytes: the slice width, the row stride
// in shared memory (an odd number of words), the slices and the shared
// bytes a block.
struct ScanTile {
  int chunk, stride, chunks, smem;
};

__host__ __device__ inline ScanTile scan_tile(int ms) {
  ScanTile tl;
  tl.chunk = ms < CHUNK ? ms : CHUNK;
  tl.stride = 4 * (((tl.chunk + 3) / 4) | 1);
  tl.chunks = (ms + CHUNK - 1) / CHUNK;
  tl.smem = ROWS * tl.stride;
  return tl;
}

struct Args {
  const uint8_t* bufs;
  const int* lengths;
  int* out;
  int n, ms;
  ScanTile tl;
};

// One row's scan so far: the counts, the word (its first position and its
// byte mask) that holds the rightmost '{', and the word and mask of the '}'
// that come after that '{' in the first word that has any (mask 0 while
// none has come). Byte masks have the top bit of each byte that matches.
struct Row {
  int len, n_open, n_close;
  int open_at, close_at;
  uint32_t open_mask, close_mask;
  uint32_t carry;  // 0x80 when the byte before the next word is a '\\'
};

__device__ __forceinline__ int tile_rows(const Args& a, int b) {
  const long long left = (long long)a.n - (long long)b * ROWS;
  return left < ROWS ? (int)left : ROWS;
}

// The top bit of each byte of w that equals the byte of `pattern` (four
// copies of one byte), exactly: y's low seven bits plus 0x7f carry into the
// top bit unless they are all zero.
__device__ __forceinline__ uint32_t byte_eq(uint32_t w, uint32_t pattern) {
  const uint32_t y = w ^ pattern;
  return ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
}

// Byte x of a range of rows `cols` bytes wide, at its place in shared
// memory where the rows lie `sb` bytes apart.
__device__ __forceinline__ uint8_t* place(uint8_t* s, int sb, int cols,
                                          int x) {
  const int r = x / cols;
  return s + r * sb + (x - r * cols);
}

// One 16-byte unit that starts at column col of row `row`, as four words
// when every column it lands on is a multiple of 4, else as bytes. A unit
// may run on into the next rows.
__device__ __forceinline__ void store_unit(uint8_t* s, int sb, int cols,
                                           int row, int col, const uint4& v,
                                           bool words) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (words) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int r = row, c = col + 4 * k;
      while (c >= cols) {
        c -= cols;
        ++r;
      }
      *reinterpret_cast<uint32_t*>(s + r * sb + c) = w[k];
    }
  } else {
    for (int k = 0; k < 16; ++k) {
      int r = row, c = col + k;
      while (c >= cols) {
        c -= cols;
        ++r;
      }
      s[r * sb + c] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// Copy g[0, len), rows of `cols` bytes back to back, into shared memory at s
// with the rows sb bytes apart; thread t of nt. The 16-byte aligned units
// go as uint4 loads, BATCH in flight a thread, neighbouring threads on
// neighbouring units; the ragged head and tail byte by byte.
__device__ __forceinline__ void copy_range(uint8_t* s, int sb,
                                           const uint8_t* g, int len,
                                           int cols, int t, int nt) {
  if (len <= 0) return;
  const int skew = (int)((0 - (uintptr_t)g) & 15);
  const int head = skew < len ? skew : len;
  const int units = (len - head) >> 4;
  for (int x = t; x < head; x += nt) *place(s, sb, cols, x) = g[x];
  for (int x = head + 16 * units + t; x < len; x += nt)
    *place(s, sb, cols, x) = g[x];
  if (t >= units) return;
  const bool words = ((head | cols) & 3) == 0;
  const int step = 16 * nt, drow = step / cols, dcol = step - drow * cols;
  int x = head + 16 * t;
  int row = x / cols, col = x - row * cols;
  for (int u = t; u < units; u += BATCH * nt, x += BATCH * step) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (u + k * nt < units)
        v[k] = *reinterpret_cast<const uint4*>(g + x + k * step);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (u + k * nt < units) store_unit(s, sb, cols, row, col, v[k], words);
      col += dcol;
      row += drow;
      if (col >= cols) {
        col -= cols;
        ++row;
      }
    }
  }
}

// Copy slices of `cols` <= CHUNK bytes, one at g + r * ms for each row
// r < rows, into shared memory rows sb bytes apart; thread t of nt, with
// CHUNK / 16 threads a slice: lane l takes the slice's aligned 16-byte unit
// l and byte l of its ragged head and of its tail. A thread has the units
// of BATCH rows in flight.
__device__ __forceinline__ void copy_slices(uint8_t* s, int sb,
                                            const uint8_t* g, size_t ms,
                                            int rows, int cols, int t,
                                            int nt) {
  constexpr int lanes = CHUNK / 16;
  const int lane = t % lanes, groups = nt / lanes;
  for (int r0 = t / lanes; r0 < rows; r0 += BATCH * groups) {
    uint4 v[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * groups;
      const uint8_t* gr = g + (size_t)r * ms;
      const int skew = (int)((0 - (uintptr_t)gr) & 15);
      const int head = skew < cols ? skew : cols;
      if (r < rows && lane < (cols - head) >> 4)
        v[i] = *reinterpret_cast<const uint4*>(gr + head + 16 * lane);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * groups;
      if (r >= rows) break;
      const uint8_t* gr = g + (size_t)r * ms;
      uint8_t* sr = s + r * sb;
      const int skew = (int)((0 - (uintptr_t)gr) & 15);
      const int head = skew < cols ? skew : cols;
      const int units = (cols - head) >> 4, tail = head + 16 * units + lane;
      if (lane < units)
        store_unit(sr, sb, cols, 0, head + 16 * lane, v[i],
                   ((head | cols) & 3) == 0);
      if (lane < head) sr[lane] = gr[lane];
      if (tail < cols) sr[tail] = gr[tail];
    }
  }
}

// Phase 0, per thread: its row's length, clamped to [0, MS] (one coalesced
// read a thread; 0 past the last row), and an empty scan.
__device__ __forceinline__ Row row_begin(const Args& a, int b, int t) {
  Row r{0, 0, 0, 0, 0, 0, 0, 0};
  if (t < tile_rows(a, b)) {
    const int len = a.lengths[(long long)b * ROWS + t];
    r.len = len < 0 ? 0 : (len > a.ms ? a.ms : len);
  }
  return r;
}

// Phase 1, block-wide: slice k of the tile's rows into shared memory.
__device__ __forceinline__ void copy_chunk(const Args& a, int b, int k, int t,
                                           int nt, uint8_t* sm) {
  const int rows = tile_rows(a, b), c0 = k * CHUNK;
  const int cols = a.ms - c0 < a.tl.chunk ? a.ms - c0 : a.tl.chunk;
  const uint8_t* g = a.bufs + (size_t)b * ROWS * (size_t)a.ms + c0;
  if (cols == a.ms)  // whole rows: the tile is one contiguous range
    copy_range(sm, a.tl.stride, g, rows * cols, cols, t, nt);
  else
    copy_slices(sm, a.tl.stride, g, (size_t)a.ms, rows, cols, t, nt);
}

// One word of a row: bytes p .. p+3, those outside `keep` past the length.
__device__ __forceinline__ void scan_word(Row& r, uint32_t w, uint32_t keep,
                                          int p) {
  const uint32_t bs = byte_eq(w, 0x5c5c5c5cu);  // '\\'
  const uint32_t vis = ~((bs << 8) | r.carry) & keep;
  r.carry = bs >> 24;
  const uint32_t op = byte_eq(w, 0x7b7b7b7bu) & vis;  // '{'
  const uint32_t cl = byte_eq(w, 0x7d7d7d7du) & vis;  // '}'
  r.n_open += __popc(op);
  r.n_close += __popc(cl);
  // the '}' above the word's last '{' (every '}' when there is no '{': the
  // count of leading zeros is then 32, so the mask shifts in 64 bits)
  const uint32_t after = cl & ~(uint32_t)(0xffffffffull >> __clz((int)op));
  if (op) {
    r.open_at = p;
    r.open_mask = op;
  }
  if (op || r.close_mask == 0) {
    r.close_at = p;
    r.close_mask = after;
  }
}

// Phase 2, per thread: its row's part of slice k, from shared memory.
__device__ __forceinline__ void scan_chunk(const Args& a, int k, int t,
                                           const uint8_t* sm, Row& r) {
  const int c0 = k * CHUNK;
  const int end = r.len - c0 < a.tl.chunk ? r.len - c0 : a.tl.chunk;
  if (end <= 0) return;
  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(sm + (size_t)t * a.tl.stride);
  const int full = end >> 2;
#pragma unroll 4
  for (int j = 0; j < full; ++j) scan_word(r, w[j], 0xffffffffu, c0 + 4 * j);
  if (end & 3)
    scan_word(r, w[full], (1u << (8 * (end & 3))) - 1, c0 + 4 * full);
}

// Phase 3, per thread: the row's four values in one 16-byte store.
__device__ __forceinline__ void row_end(const Args& a, int b, int t,
                                        const Row& r) {
  if (t >= tile_rows(a, b)) return;
  const int outer =
      r.open_mask ? r.open_at + ((31 - __clz((int)r.open_mask)) >> 3) : -1;
  const int inner =
      r.close_mask ? r.close_at + ((__ffs((int)r.close_mask) - 1) >> 3) : -1;
  reinterpret_cast<int4*>(a.out)[(long long)b * ROWS + t] =
      make_int4(r.n_open, r.n_close, outer, inner);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(ROWS) brace_scan_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, t = threadIdx.x;
  Row r = row_begin(a, b, t);
  for (int k = 0; k < a.tl.chunks; ++k) {
    // slice k - 1's scan ahead of slice k's copy, which no row may need
    if (k > 0 && !__syncthreads_or(r.len > k * CHUNK)) break;
    copy_chunk(a, b, k, t, ROWS, smem);
    __syncthreads();
    scan_chunk(a, k, t, smem, r);
  }
  row_end(a, b, t, r);
}
#endif

}  // namespace

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success). `out` must
// be 16-byte aligned (each row is one int4 store).
extern "C" int brace_scan_launch(const uint8_t* bufs, const int* lengths,
                                 int* out, int n, int ms, void* stream) {
  if (n <= 0) return 0;
  if (ms < 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{bufs, lengths, out, n, ms, scan_tile(ms)};
  const long long grid = ((long long)n + ROWS - 1) / ROWS;
  brace_scan_kernel<<<(unsigned)grid, ROWS, a.tl.smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The tile for rows of `ms` bytes: rows a block, shared bytes a block, and
// the blocks the current device keeps on one SM at once.
extern "C" int brace_scan_plan(int ms, int* out3) {
  const ScanTile tl = scan_tile(ms < 0 ? 0 : ms);
  out3[0] = ROWS;
  out3[1] = tl.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out3[2], brace_scan_kernel, ROWS, tl.smem);
}
#endif
