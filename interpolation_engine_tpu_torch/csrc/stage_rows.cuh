// Rows staged in shared memory, for the kernels that give a thread a row
// (csrc/math_eval.cu, csrc/wildcard_match.cu).
//
// A block of ROWS threads takes 4 * rpw consecutive rows, rpw a warp
// (rows_a_warp). Its rows' bytes
// within their lengths (at most the first `cap` bytes of a row) are copied
// to shared memory by the whole block, neighbouring threads on neighbouring
// addresses, BATCH loads in flight a thread: 16-byte loads where the rows
// start 16-byte aligned, 4-byte loads where they start 4-byte aligned, else
// bytes. In shared memory the rows lie an odd number of words apart, so 32
// threads reading word j of 32 rows hit 32 banks. A thread then reads its
// own row through a RowView: a word at a time from shared memory, and past
// `cap` (a row longer than the stage holds) from device memory in place.
//
// Every function is a per-thread phase: a kernel calls stage_rows for every
// thread, a barrier, then the per-row work, so that a host compiler can run
// the phases thread by thread (the CPU rehearsals in tests/).

#pragma once
#include <stdint.h>

namespace stage {

constexpr int ROWS = 128;  // threads a block, and the most rows a tile
constexpr int CAP = 256;   // the most bytes of a row a tile holds
constexpr int BATCH = 4;   // loads in flight a thread

// Rows a warp for a call of n rows on a card of `sms` SMs: 32, halved
// (down to 1, the other lanes idle) while the call would give fewer than
// `want` warps an SM. A thread's walk over its row is serial and the rows
// of a warp wait on each other, so a small call is bound by its warps'
// chains, which fewer rows a warp shorten and more warps overlap; a large
// one by the instructions issued, which full warps share. Each kernel
// names the warps an SM it wants.
__host__ __device__ inline int rows_a_warp(long long n, int sms, int want) {
  int rpw = 32;
  while (rpw > 1 && (n + rpw - 1) / rpw < (long long)want * sms) rpw /= 2;
  return rpw;
}

// The staged bytes a row of `width` bytes may have, and the row stride in
// shared memory: an odd number of words that holds them.
__host__ __device__ inline int row_cap(int width) {
  return width < CAP ? (width < 0 ? 0 : width) : CAP;
}

__host__ __device__ inline int row_stride(int cap) {
  return 4 * (((cap + 3) / 4) | 1);
}

// The bytes of a row that its reader needs: those within its length and
// its width.
__device__ __forceinline__ int needed(int len, int width) {
  return len < 0 ? 0 : (len < width ? len : width);
}

// A row as its thread reads it: the first `cap` bytes staged at `s` (word
// aligned; those at or past the row's length are garbage), all of it at
// `g` in device memory, zero at and past `width`.
struct RowView {
  const uint8_t* s;
  const uint8_t* g;
  int cap;
  int width;
};

__device__ __forceinline__ int byte_at(const RowView& v, int j) {
  return j < v.cap ? v.s[j] : (j < v.width ? v.g[j] : 0);
}

// The four bytes at j (a multiple of 4), the byte at j in the low bits.
__device__ __forceinline__ uint32_t word_at(const RowView& v, int j) {
  if (j + 4 <= v.cap) return *reinterpret_cast<const uint32_t*>(v.s + j);
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k) w |= (uint32_t)byte_at(v, j + k) << (8 * k);
  return w;
}

// The top bit of each byte of w that equals the byte of `pattern` (four
// copies of one byte), exactly: y's low seven bits plus 0x7f carry into the
// top bit unless they are all zero.
__device__ __forceinline__ uint32_t byte_eq(uint32_t w, uint32_t pattern) {
  const uint32_t y = w ^ pattern;
  return ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
}

// Thread t's row in a tile of rpw rows a warp, or -1 for an idle lane.
__device__ __forceinline__ int tile_row(int t, int rpw) {
  return t % 32 < rpw ? t / 32 * rpw + t % 32 : -1;
}

// The rows of one tile in device memory: row r (r < rows) at g + r * ms,
// its length at lens[r] (one length for all when rows is 1).
struct Tile {
  const uint8_t* g;
  const int* lens;
  long long ms;
  int rows;
  int width;  // bytes a row
};

// One unit into shared memory at d (word aligned: the stride is a multiple
// of 4, not of 16), its words from the value's members, so that the loaded
// units stay in registers.
__device__ __forceinline__ void put(uint8_t* d, const uint4& v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(d);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void put(uint8_t* d, uint32_t v) {
  *reinterpret_cast<uint32_t*>(d) = v;
}

__device__ __forceinline__ void put(uint8_t* d, uint8_t v) { *d = v; }

template <typename T>
__device__ __forceinline__ void stage_units(uint8_t* s, int stride, int cap,
                                            const Tile& tl, int t, int nt) {
  constexpr int B = (int)sizeof(T);
  const int units = (cap + B - 1) / B, total = tl.rows * units;
  for (int u0 = t; u0 < total; u0 += BATCH * nt) {
    T v[BATCH];
    int at[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int u = u0 + k * nt, r = u / units, c = B * (u - r * units);
      at[k] = -1;
      if (u < total && c < needed(tl.lens[r], tl.width)) {
        v[k] = *reinterpret_cast<const T*>(tl.g + r * tl.ms + c);
        at[k] = r * stride + c;
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (at[k] >= 0) put(s + at[k], v[k]);
  }
}

// Phase, block-wide (thread t of nt): stage the tile's rows, row r's
// needed bytes (at most cap) to s + r * stride. A unit is a 16-byte load
// when every row starts 16-byte aligned and the width is a multiple of 16
// (so a unit never runs past its row, nor past cap), else a 4-byte or a
// 1-byte load on the same terms; a unit wholly past a row's length is not
// read.
__device__ __forceinline__ void stage_rows(uint8_t* s, int stride, int cap,
                                           const Tile& tl, int t, int nt) {
  const uintptr_t step = tl.rows > 1 ? (uintptr_t)tl.ms : 0;
  const uintptr_t bits = (uintptr_t)tl.g | step | (uintptr_t)tl.width;
  if ((bits & 15) == 0)
    stage_units<uint4>(s, stride, cap, tl, t, nt);
  else if ((bits & 3) == 0)
    stage_units<uint32_t>(s, stride, cap, tl, t, nt);
  else
    stage_units<uint8_t>(s, stride, cap, tl, t, nt);
}

}  // namespace stage
