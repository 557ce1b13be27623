// Wildcard matcher kernel for Hopper (sm_90a): each subject row against its
// pattern row (or one pattern shared by all rows), with greedy captures.
//
// Replaces interpolation_engine_tpu/ops/match_kernel.py,
// `_wildcard_match_impl` (:188, jitted at :177), which the JAX package runs
// as XLA (no pallas_call): `_segment_spans` (:40, fori_loop :68) splits the
// pattern, `_occurrences` builds window-compare masks, and `_match_at_cut`
// (:101) runs fori_loops of right-to-left feasibility vectors (:143) and of
// greedy captures (:168), once at the subject's length and once before a
// trailing newline.
//
// For row r it writes ok[r] and supported[r] (bool, one byte), n_caps[r]
// (int32) and cap_off[r], cap_len[r] (max_stars int32 each), equal to the
// plain version (wildcard_match_reference) on every row, unsupported rows
// included:
//   * the pattern splits at '*' (stars within min(plen, pattern width));
//     more than max_stars stars, or a literal segment longer than
//     MAX_LIT = 32, is supported = false (the caller defers to the host);
//     past max_stars the rest of the pattern is one literal;
//   * anchored at both ends; every byte but '*' is literal; a segment is
//     compared over its first MAX_LIT bytes and must fit before the cut;
//   * each star takes the largest feasible literal position, left to right
//     (regex greediness); captures are written for every row, matched or
//     not, and zero past n_caps;
//   * the end-anchor quirk: if the match at slen fails and the subject ends
//     in '\n', the match at slen - 1 counts, with its captures.
// Reads past a row's width read zero, as the JAX padding gives them. Every
// byte the match reads lies within its row's length and width (a literal
// ends before the cut), so the bytes past a length never count.
//
// What bounds it on this card: device-memory bytes. A call must read each
// subject row within slen (and each pattern row, or the one shared row,
// within plen) and the lengths once, and write 2 bytes and
// 1 + 2 * max_stars int32 a row. The first design (one thread a row reading
// its rows in place a byte at a time, a backward search that tried every
// position, its scratch in local memory) reached 9-10 % of that bound.
//
// Design. A block of ROWS = 128 threads takes 4 * rpw rows, one thread a
// row: rpw = 32 rows a warp, or fewer (the other lanes idle) for a call
// too small to give each of the card's schedulers a warp
// (stage::rows_a_warp), where each warp's serial chain is the time:
//   1. stage: the block's subject rows within slen, and its pattern rows
//      within plen (the one shared pattern once a block), go to shared
//      memory in coalesced 16-byte loads (csrc/stage_rows.cuh), rows an odd
//      number of words apart;
//   2. match: each thread reads its rows a word at a time. The JAX
//      feasibility vector T_j (can "* L_j * ... * L_K" match the subject
//      from position i to the cut?) is a suffix OR, so it is true exactly up
//      to the last position at which literal j may sit; the right-to-left
//      pass is one integer a star: last_K is the one position that ends the
//      last literal at the cut, and last_j the rightmost occurrence of
//      literal j that ends at or before last_{j+1}. The backward search for
//      it takes a word of the subject at a time and holds its four
//      windows of four bytes (funnel shifts of that word and the next)
//      against the literal's first four bytes; only a window that agrees
//      has the rest compared, from the right (__clz). A literal is
//      compared four bytes at a time, funnel shifts aligning subject and
//      pattern words. The greedy capture for star j is last_j when that
//      lies at or past the cursor, else an empty capture at the cursor, as
//      the JAX argmax over h_j picks it; the captures go to device memory
//      as soon as the match at slen is known, and again if the match
//      before a trailing newline holds. The star positions and the last_j
//      live in shared memory, entry k of thread t at word k * ROWS + t (no
//      bank conflicts, no local memory).
// What holds it is each thread's serial search, a word of its subject a
// step, and the 32 rows of a warp, which take different numbers of steps
// (a subject that does not match is searched to its start). Rows longer
// than stage::CAP bytes (wider configs) read their tail in place.
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the phase functions
// (`stage_block`, then after a barrier `match_thread`): the CPU tests
// (tests/test_torch_match_tile.py) run them block by block.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "stage_rows.cuh"

namespace {

using stage::ROWS;
using stage::RowView;

constexpr int MAX_LIT = 32;
// The largest max_stars: the shared scratch holds 2 * max_stars words a
// thread.
constexpr int MAX_STARS = 64;
constexpr int STAR = 42, NEWLINE = 10;
// Warps an SM a call should give (stage::rows_a_warp): one a scheduler; on
// an H100 four a scheduler was slower for the shared pattern (0.0080
// against 0.0067 ms at 4,096 rows).
constexpr int WARPS_AN_SM = 4;

struct MatchArgs {
  const uint8_t* pat;
  const int* plen;
  const uint8_t* subj;
  const int* slen;
  int n, pms, ms, shared, max_stars;
  int rpw;  // rows a warp (stage::rows_a_warp); a block takes 4 * rpw
  uint8_t* ok;
  uint8_t* supported;
  int* n_caps;
  int* cap_off;
  int* cap_len;
};

// A block's shared memory: the subject rows, the pattern rows (one row when
// shared), then the scratch (2 * max_stars words a thread), in bytes.
struct MatchLayout {
  int s_cap, s_stride, p_cap, p_stride, pat, scratch, bytes;
};

__host__ __device__ inline MatchLayout match_layout(int ms, int pms,
                                                    int shared,
                                                    int max_stars) {
  MatchLayout l;
  l.s_cap = stage::row_cap(ms);
  l.s_stride = stage::row_stride(l.s_cap);
  l.p_cap = stage::row_cap(pms);
  l.p_stride = stage::row_stride(l.p_cap);
  l.pat = ROWS * l.s_stride;
  l.scratch = l.pat + (shared ? 1 : ROWS) * l.p_stride;
  l.bytes = l.scratch + 2 * max_stars * ROWS * 4;
  return l;
}

// A thread's column of the scratch: entry k at p[k * ROWS].
struct Column {
  int* p;
  __device__ __forceinline__ int& operator[](int k) const {
    return p[k * ROWS];
  }
};

struct Pattern {
  RowView v;
  int plen;
  int K;         // stars used: min(n_stars, max_stars)
  Column stars;  // the first K star positions
};

// Literal j: its offset in the pattern and its length.
__device__ __forceinline__ int seg_off(const Pattern& p, int j) {
  return j == 0 ? 0 : p.stars[j - 1] + 1;
}

__device__ __forceinline__ int seg_len(const Pattern& p, int j) {
  const int end = j < p.K ? p.stars[j] : p.plen;
  const int len = end - seg_off(p, j);
  return len < 0 ? 0 : len;
}

// The m (1..MAX_LIT) bytes of the subject at pos equal those of the
// pattern at off: four bytes a compare, each side's words aligned by a
// funnel shift.
__device__ __forceinline__ bool literal_at(const RowView& s, int pos,
                                           const RowView& p, int off,
                                           int m) {
  int sa = pos & ~3, pa = off & ~3;
  const int ss = 8 * (pos & 3), ps = 8 * (off & 3);
  uint32_t s0 = stage::word_at(s, sa), p0 = stage::word_at(p, pa);
  for (int q = 0; q < m; q += 4) {
    uint32_t sw = s0, pw = p0;
    if (ss) {
      const uint32_t s1 = stage::word_at(s, sa + 4);
      sw = __funnelshift_r(s0, s1, ss);
      s0 = s1;
    } else if (q + 4 < m) {
      s0 = stage::word_at(s, sa + 4);
    }
    if (ps) {
      const uint32_t p1 = stage::word_at(p, pa + 4);
      pw = __funnelshift_r(p0, p1, ps);
      p0 = p1;
    } else if (q + 4 < m) {
      p0 = stage::word_at(p, pa + 4);
    }
    uint32_t diff = sw ^ pw;
    if (m - q < 4) diff &= (1u << (8 * (m - q))) - 1;
    if (diff) return false;
    sa += 4;
    pa += 4;
  }
  return true;
}

// Literal j occurs at subject position pos (0 <= pos) and ends at or
// before the cut.
__device__ __forceinline__ bool occurs(const Pattern& p, int j,
                                       const RowView& s, int n, int pos,
                                       int cut) {
  const int m = seg_len(p, j);
  if (m == 0) return pos <= cut;
  if (pos >= n || pos + m > cut) return false;
  return literal_at(s, pos, p.v, seg_off(p, j), m < MAX_LIT ? m : MAX_LIT);
}

// The rightmost position in [0, top] where literal j (m >= 1 bytes)
// occurs, or -1: a word of the subject at a time, its four windows of four
// bytes (funnel shifts of the word and the one after it) held against the
// literal's first four bytes at once; a window that agrees has the rest
// of the literal compared, from the right.
__device__ __forceinline__ int search_back(const Pattern& p, int j, int m,
                                           const RowView& s, int top) {
  if (top < 0) return -1;
  const int off = seg_off(p, j), mm = m < MAX_LIT ? m : MAX_LIT;
  const int pa = off & ~3, ps = 8 * (off & 3);
  uint32_t first = stage::word_at(p.v, pa);
  if (ps) first = __funnelshift_r(first, stage::word_at(p.v, pa + 4), ps);
  const uint32_t keep = mm >= 4 ? 0xffffffffu : (1u << (8 * mm)) - 1;
  first &= keep;
  int a = top & ~3;
  uint32_t hits = 0xfu >> (3 - (top - a)), next = stage::word_at(s, a + 4);
  for (; a >= 0; a -= 4, hits = 0xfu) {
    const uint32_t w = stage::word_at(s, a);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((__funnelshift_r(w, next, 8 * k) ^ first) & keep) hits &= ~(1u << k);
    while (hits) {
      const int k = 31 - __clz((int)hits);
      if (mm <= 4 || literal_at(s, a + k + 4, p.v, off + 4, mm - 4))
        return a + k;
      hits &= ~(1u << k);
    }
    next = w;
  }
  return -1;
}

// The anchored match against subj[0:cut]: fills last (entry j - 1 for star
// j = 1..K) and returns ok.
__device__ __forceinline__ bool match_at_cut(const Pattern& p,
                                             const RowView& s, int n,
                                             int cut, Column last) {
  const int K = p.K;
  if (K >= 1) {
    const int mK = seg_len(p, K), at = cut - mK;
    int next = (at >= 0 && at <= n && occurs(p, K, s, n, at, cut)) ? at : -1;
    last[K - 1] = next;
    for (int j = K - 1; j >= 1; --j) {
      const int m = seg_len(p, j);
      int hi = next - m;
      if (hi > n) hi = n;
      if (m == 0) {
        next = hi < cut ? hi : cut;
        if (next < 0) next = -1;
      } else {
        if (hi > n - 1) hi = n - 1;
        if (hi > cut - m) hi = cut - m;
        next = search_back(p, j, m, s, hi);
      }
      last[j - 1] = next;
    }
  }
  const int m0 = seg_len(p, 0);
  const bool prefix = occurs(p, 0, s, n, 0, cut);
  return K == 0 ? prefix && m0 == cut
                : prefix && (m0 < n ? m0 : n) <= last[0];
}

// The greedy captures from a match's last positions: star t + 1 takes
// last[t] when that lies at or past the cursor, else an empty capture at
// the cursor; zero past K.
__device__ __forceinline__ void captures(const Pattern& p, Column last,
                                         int max_stars, int* cap_off,
                                         int* cap_len) {
  int cursor = seg_len(p, 0);
  for (int t = 0; t < max_stars; ++t) {
    if (t < p.K) {
      const int at = last[t] >= cursor ? last[t] : cursor;
      cap_off[t] = cursor;
      cap_len[t] = at - cursor;
      cursor = at + seg_len(p, t + 1);
    } else {
      cap_off[t] = 0;
      cap_len[t] = 0;
    }
  }
}

// One row: split the pattern, match at slen, and before a trailing
// newline when that fails; write the fields (the captures again when the
// match before the newline holds).
__device__ __forceinline__ void match_row(const RowView& pv, int plen,
                                          const RowView& s, int slen,
                                          int max_stars, Column stars,
                                          Column last, uint8_t* ok,
                                          uint8_t* supported, int* n_caps,
                                          int* cap_off, int* cap_len) {
  const int n = s.width;
  int n_stars = 0;
  const int scan = plen < pv.width ? plen : pv.width;
  for (int a = 0; a < scan; a += 4) {
    uint32_t m = stage::byte_eq(stage::word_at(pv, a), 0x01010101u * STAR);
    if (scan - a < 4) m &= (1u << (8 * (scan - a))) - 1;
    for (; m && n_stars < max_stars; m &= m - 1)
      stars[n_stars++] = a + ((__ffs((int)m) - 1) >> 3);
    n_stars += __popc(m);
  }
  const int K = n_stars < max_stars ? n_stars : max_stars;
  const Pattern p{pv, plen, K, stars};
  bool fits = true;
  for (int j = 0; j <= K; ++j) fits = fits && seg_len(p, j) <= MAX_LIT;
  *supported = n_stars <= max_stars && fits;
  *n_caps = K;
  const bool newline =
      slen > 0 && n > 0 &&
      stage::byte_at(s, slen - 1 < n ? slen - 1 : n - 1) == NEWLINE;
  bool matched = false;
  for (int cut = slen; cut >= slen - 1 && !matched; --cut) {
    matched = match_at_cut(p, s, n, cut, last);
    if (cut == slen || matched) captures(p, last, max_stars, cap_off,
                                         cap_len);
    if (!newline) break;
  }
  *ok = matched;
}

// Phase 1, block-wide (thread t of nt): block b's subject rows and pattern
// rows (or the one shared pattern) into shared memory.
__device__ __forceinline__ void stage_block(const MatchArgs& a,
                                            const MatchLayout& l, int b,
                                            int t, int nt, uint8_t* sm) {
  const long long r0 = (long long)b * 4 * a.rpw;
  const int rows = a.n - r0 < 4 * a.rpw ? (int)(a.n - r0) : 4 * a.rpw;
  stage::stage_rows(sm, l.s_stride, l.s_cap,
                    stage::Tile{a.subj + r0 * a.ms, a.slen + r0, a.ms, rows,
                                a.ms},
                    t, nt);
  const long long p0 = a.shared ? 0 : r0;
  stage::stage_rows(sm + l.pat, l.p_stride, l.p_cap,
                    stage::Tile{a.pat + p0 * a.pms, a.plen + p0, a.pms,
                                a.shared ? 1 : rows, a.pms},
                    t, nt);
}

// Phase 2, per thread: the row of thread t of block b (none for an idle
// lane).
__device__ __forceinline__ void match_thread(const MatchArgs& a,
                                             const MatchLayout& l, int b,
                                             int t, uint8_t* sm) {
  const int i = stage::tile_row(t, a.rpw);
  const long long r = (long long)b * 4 * a.rpw + i;
  if (i < 0 || r >= a.n) return;
  const long long pr = a.shared ? 0 : r;
  const RowView s{sm + i * l.s_stride, a.subj + r * a.ms, l.s_cap, a.ms};
  const RowView pv{sm + l.pat + (a.shared ? 0 : i * l.p_stride),
                   a.pat + pr * a.pms, l.p_cap, a.pms};
  int* scratch = reinterpret_cast<int*>(sm + l.scratch) + t;
  const long long c = r * a.max_stars;
  match_row(pv, a.plen[pr], s, a.slen[r], a.max_stars, Column{scratch},
            Column{scratch + a.max_stars * ROWS}, a.ok + r, a.supported + r,
            a.n_caps + r, a.cap_off + c, a.cap_len + c);
}

#ifdef __CUDACC__
constexpr int MAX_DEVICES = 64;

// eight blocks an SM (27,648 shared bytes a block at MS 96 per row): up
// to 64 registers a thread, which ptxas then needs no spill to meet
__global__ void __launch_bounds__(ROWS, 8)
    wildcard_match_kernel(const MatchArgs a, const MatchLayout l) {
  extern __shared__ __align__(16) uint8_t sm[];
  stage_block(a, l, blockIdx.x, threadIdx.x, ROWS, sm);
  __syncthreads();
  match_thread(a, l, blockIdx.x, threadIdx.x, sm);
}
#endif

}  // namespace

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success). With
// `shared` the one pattern row (and its length) serves every subject row.
extern "C" int wildcard_match_launch(const uint8_t* pat, const int* plen,
                                     int pms, int shared,
                                     const uint8_t* subj, const int* slen,
                                     int n, int ms, int max_stars,
                                     uint8_t* ok, uint8_t* supported,
                                     int* n_caps, int* cap_off,
                                     int* cap_len, void* stream) {
  if (n <= 0) return 0;
  if (pms < 0 || ms < 0 || max_stars < 0 || max_stars > MAX_STARS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  // dynamic shared memory above 48 KB (max_stars past 12 at MS 96) needs
  // the opt-in, once per device
  static bool opted[MAX_DEVICES];
  if (!opted[dev]) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wildcard_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const int rpw = stage::rows_a_warp(n, sms, WARPS_AN_SM);
  const MatchArgs a{pat, plen, subj, slen, n, pms, ms, shared, max_stars,
                    rpw, ok, supported, n_caps, cap_off, cap_len};
  const MatchLayout l = match_layout(ms, pms, shared, max_stars);
  const unsigned grid =
      (unsigned)(((long long)n + 4 * rpw - 1) / (4 * rpw));
  wildcard_match_kernel<<<grid, ROWS, l.bytes, (cudaStream_t)stream>>>(a, l);
  return (int)cudaGetLastError();
}

// The kernel's registers, local (stack) bytes and the dynamic shared bytes
// a block at (ms, pms, shared, max_stars): out4.
extern "C" int wildcard_match_attributes(int ms, int pms, int shared,
                                         int max_stars, int* out4) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, wildcard_match_kernel);
  if (e != cudaSuccess) return (int)e;
  out4[0] = fa.numRegs;
  out4[1] = (int)fa.localSizeBytes;
  out4[2] = match_layout(ms, pms, shared, max_stars).bytes;
  out4[3] = ROWS;
  return 0;
}
#endif
