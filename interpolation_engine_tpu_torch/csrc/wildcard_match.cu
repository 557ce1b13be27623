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
// Reads past a row's width read zero, as the JAX padding gives them.
//
// What bounds it on this card: device-memory bytes. A call must read each
// subject row within slen (and each pattern row, or the one shared row,
// within plen) and the lengths once, and write 2 bytes and
// 1 + 2 * max_stars int32 a row.
//
// Design: one thread a row, no vectors. The JAX feasibility vector T_j (can
// "* L_j * ... * L_K" match the subject from position i to the cut?) is a
// suffix OR, so it is true exactly up to the last position at which h_j,
// the positions where literal j may sit, holds. The whole right-to-left
// pass is therefore one integer a star: last_K is the one position that
// ends the last literal at the cut, and last_j is the rightmost occurrence
// of literal j that ends at or before last_{j+1}, found by a backward
// search. The greedy capture for star j is last_j when that lies at or past
// the cursor, else an empty capture at the cursor, as the JAX argmax over
// h_j picks it. No MS-wide state, no host sync (the plain version's
// `lq`, the longest segment, is not needed). The pattern row is read in
// place (a shared pattern is one row every thread reads), the subject a
// byte at a time where a literal is tried.
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the per-row function
// (`match_row`): the CPU tests (tests/test_torch_match_tile.py) run it so.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int MAX_LIT = 32;
// The largest max_stars: each thread's scratch is four arrays of this size.
constexpr int MAX_STARS = 64;
constexpr int STAR = 42, NEWLINE = 10;

struct Pattern {
  const uint8_t* pat;
  int pms;           // the pattern row's width
  int plen;
  int K;             // stars used: min(n_stars, max_stars)
  const int* stars;  // the first K star positions
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

// Literal j occurs at subject position pos (0 <= pos <= n) and ends at or
// before the cut.
__device__ bool occurs(const Pattern& p, int j, const uint8_t* subj, int n,
                       int pos, int cut) {
  const int m = seg_len(p, j);
  if (m == 0) return pos <= cut;
  if (pos >= n || pos + m > cut) return false;
  const int off = seg_off(p, j);  // at most pms: stars lie in the row
  const int q_end = m < MAX_LIT ? m : MAX_LIT;
  for (int q = 0; q < q_end; ++q) {
    const int s = pos + q < n ? subj[pos + q] : 0;
    const int l = off + q < p.pms ? p.pat[off + q] : 0;
    if (s != l) return false;
  }
  return true;
}

// The anchored match against subj[0:cut]; `last` holds K + 1 entries.
// Writes the captures of stars 1..max_stars and returns ok.
__device__ bool match_at_cut(const Pattern& p, const uint8_t* subj, int n,
                             int cut, int max_stars, int* last, int* cap_off,
                             int* cap_len) {
  const int K = p.K;
  if (K >= 1) {
    const int at = cut - seg_len(p, K);
    last[K] = (at >= 0 && at <= n && occurs(p, K, subj, n, at, cut)) ? at
                                                                     : -1;
    for (int j = K - 1; j >= 1; --j) {
      int hi = last[j + 1] - seg_len(p, j);
      if (hi > n) hi = n;
      last[j] = -1;
      for (int pos = hi; pos >= 0; --pos)
        if (occurs(p, j, subj, n, pos, cut)) {
          last[j] = pos;
          break;
        }
    }
  }
  const int m0 = seg_len(p, 0);
  const bool prefix = occurs(p, 0, subj, n, 0, cut);
  const bool ok = K == 0 ? prefix && m0 == cut
                         : prefix && (m0 < n ? m0 : n) <= last[1];
  int cursor = m0;
  for (int t = 0; t < max_stars; ++t) {
    if (t + 1 <= K) {
      const int at = last[t + 1] >= cursor ? last[t + 1] : cursor;
      cap_off[t] = cursor;
      cap_len[t] = at - cursor;
      cursor = at + seg_len(p, t + 1);
    } else {
      cap_off[t] = 0;
      cap_len[t] = 0;
    }
  }
  return ok;
}

// One row. `stars` and `last` are scratch of max_stars and max_stars + 1
// ints; `trim_off` and `trim_len` scratch of max_stars ints each.
__device__ void match_row(const uint8_t* pat, int pms, int plen,
                          const uint8_t* subj, int n, int slen,
                          int max_stars, int* stars, int* last,
                          int* trim_off, int* trim_len, uint8_t* ok,
                          uint8_t* supported, int* n_caps, int* cap_off,
                          int* cap_len) {
  int n_stars = 0;
  const int scan = plen < pms ? plen : pms;
  for (int i = 0; i < scan; ++i)
    if (pat[i] == STAR) {
      if (n_stars < max_stars) stars[n_stars] = i;
      ++n_stars;
    }
  const int K = n_stars < max_stars ? n_stars : max_stars;
  const Pattern p{pat, pms, plen, K, stars};
  bool fits = true;
  for (int j = 0; j <= K; ++j) fits = fits && seg_len(p, j) <= MAX_LIT;
  *supported = n_stars <= max_stars && fits;
  *n_caps = K;
  bool matched =
      match_at_cut(p, subj, n, slen, max_stars, last, cap_off, cap_len);
  if (!matched && slen > 0 && n > 0 &&
      subj[slen - 1 < n ? slen - 1 : n - 1] == NEWLINE &&
      match_at_cut(p, subj, n, slen - 1, max_stars, last, trim_off,
                   trim_len)) {
    matched = true;
    for (int t = 0; t < max_stars; ++t) {
      cap_off[t] = trim_off[t];
      cap_len[t] = trim_len[t];
    }
  }
  *ok = matched;
}

#ifdef __CUDACC__
constexpr int BLOCK = 128;

struct MatchArgs {
  const uint8_t* pat;
  const int* plen;
  const uint8_t* subj;
  const int* slen;
  int n, pms, ms, shared, max_stars;
  uint8_t* ok;
  uint8_t* supported;
  int* n_caps;
  int* cap_off;
  int* cap_len;
};

// The scratch lives in local memory.
__global__ void __launch_bounds__(BLOCK)
    wildcard_match_kernel(const MatchArgs a) {
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n) return;
  int stars[MAX_STARS], last[MAX_STARS + 1], trim_off[MAX_STARS],
      trim_len[MAX_STARS];
  const long long pr = a.shared ? 0 : r;
  const long long c = r * a.max_stars;
  match_row(a.pat + pr * a.pms, a.pms, a.plen[pr], a.subj + r * a.ms, a.ms,
            a.slen[r], a.max_stars, stars, last, trim_off, trim_len,
            a.ok + r, a.supported + r, a.n_caps + r, a.cap_off + c,
            a.cap_len + c);
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
  const MatchArgs a{pat, plen, subj, slen, n, pms, ms, shared, max_stars,
                    ok, supported, n_caps, cap_off, cap_len};
  const unsigned grid = (unsigned)(((long long)n + BLOCK - 1) / BLOCK);
  wildcard_match_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
