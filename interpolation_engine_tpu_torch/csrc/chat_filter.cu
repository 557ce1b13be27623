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
// with a few integer operations a byte.
//
// Design (the first, simple one): one thread a stream walks its bytes once.
// The extract state machine writes each kept byte to ext and, unless it
// belongs to a span past MAX_SPANS of an enumerated stream, to vis, where
// the span's marker went when the span opened; the stop hold-back then
// trims the tail of both. The hide pass runs in place over vis: its
// compaction writes at or before the byte it reads, and a delimiter match
// reads only bytes after it. Then each thread zero-fills its padding.
// Neighbouring threads read rows L bytes apart, so the loads do not
// coalesce, and at 16,384 streams the card holds 512 warps: it is mostly
// idle. PERF.md has its times.
//
// nvcc compiles the whole file. The kernel and its launch sit behind
// __CUDACC__, so that a host compiler can build the per-stream functions:
// the CPU tests (tests/test_torch_filter_tile.py) run them that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_SPANS = 16;            // outputs a stream's table holds
constexpr int TABLE = 2 * MAX_SPANS + 3;  // int32 a stream in `table`
constexpr int THREADS = 32;              // streams a block

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

// d occurs at s[i .. i + d.n), entirely before `len`.
__device__ __forceinline__ bool match_at(const uint8_t* s, int i, int len,
                                         const Delim& d) {
  if (d.n == 0 || d.n > len - i) return false;
  for (int j = 0; j < d.n; ++j)
    if (s[i + j] != d.p[j]) return false;
  return true;
}

// The hold-back at the end of a shown stream: the longest s < d.n, at most
// `free` (the trailing bytes no match consumed, all kept, so they are the
// last `free` bytes of out[0, out_len)), whose last s bytes are d's first s.
__device__ __forceinline__ int holdback(const uint8_t* out, int out_len,
                                        int free, const Delim& d) {
  const int top = d.n - 1 < free ? d.n - 1 : free;
  for (int s = top; s >= 1; --s) {
    int t = 0;
    while (t < s && out[out_len - s + t] == d.p[t]) ++t;
    if (t == s) return s;
  }
  return 0;
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

// Zero p[from, to): bytes up to a 16-byte boundary, then 16 at a time.
__device__ __forceinline__ void zero_fill(uint8_t* p, int from, int to) {
  int i = from;
  while (i < to && ((uintptr_t)(p + i) & 15) != 0) p[i++] = 0;
  for (; i + 16 <= to; i += 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
  for (; i < to; ++i) p[i] = 0;
}

// The extract pass and the intermediate stream. Writes the kept bytes to
// ext, the stream to vis, the span table; returns the stream's length.
__device__ __forceinline__ int extract(const FilterArgs& a,
                                       const uint8_t* buf, int n,
                                       uint8_t* ext, uint8_t* vis, int* tab) {
  int span_len[MAX_SPANS];
  for (int k = 0; k < MAX_SPANS; ++k) span_len[k] = 0;
  int ext_len = 0, m = 0, spans = 0;
  const bool passthrough = a.start.n == 0 || a.stop.n == 0;
  if (passthrough) {
    for (int i = 0; i < n; ++i) ext[i] = vis[i] = buf[i];
    ext_len = m = n;
    spans = n > 0;
    span_len[0] = n;
  } else {
    bool shown = false;
    int skip = 0, cons_end = 0, cur = 0;
    for (int i = 0; i < n; ++i) {
      const uint8_t c = buf[i];
      if (skip == 0) {
        if (!shown) {
          if (c == a.start.p[0] && match_at(buf, i, n, a.start)) {
            if (spans >= 1 && spans <= MAX_SPANS) span_len[spans - 1] = cur;
            if (a.enumerate && spans < MAX_SPANS)
              m += put_marker(vis + m, spans);
            ++spans;
            cur = 0;
            shown = true;
            skip = a.start.n;
          }
        } else if (c == a.stop.p[0] && match_at(buf, i, n, a.stop)) {
          shown = false;
          skip = a.stop.n;
        }
      }
      if (skip > 0) {
        cons_end = i + 1;
        --skip;
      } else if (shown) {
        ext[ext_len++] = c;
        ++cur;
        if (!a.enumerate || spans <= MAX_SPANS) vis[m++] = c;
      }
    }
    if (spans >= 1 && spans <= MAX_SPANS) span_len[spans - 1] = cur;
    if (shown) {
      const int best = holdback(ext, ext_len, n - cons_end, a.stop);
      ext_len -= best;
      if (spans <= MAX_SPANS) span_len[spans - 1] -= best;
      if (!a.enumerate || spans <= MAX_SPANS) m -= best;
    }
  }
  zero_fill(ext, ext_len, a.L);
  int off = 0;
  for (int k = 0; k < MAX_SPANS; ++k) {
    tab[k] = passthrough ? 0 : off;  // JAX's passthrough offsets are 0
    tab[MAX_SPANS + k] = span_len[k];
    off += span_len[k];
  }
  tab[2 * MAX_SPANS] = spans < MAX_SPANS ? spans : MAX_SPANS;
  tab[2 * MAX_SPANS + 1] = spans;
  return m;
}

// The hide pass in place over vis[0, m); returns the visual length.
__device__ __forceinline__ int hide(const FilterArgs& a, uint8_t* vis,
                                    int m) {
  if (a.hide_start.n == 0 || a.hide_stop.n == 0) return m;
  bool shown = true;
  int skip = 0, cons_end = 0, w = 0;
  for (int j = 0; j < m; ++j) {
    const uint8_t c = vis[j];
    if (skip == 0) {
      if (shown) {
        if (c == a.hide_start.p[0] && match_at(vis, j, m, a.hide_start)) {
          shown = false;
          skip = a.hide_start.n;
        }
      } else if (c == a.hide_stop.p[0] && match_at(vis, j, m, a.hide_stop)) {
        shown = true;
        skip = a.hide_stop.n;
      }
    }
    if (skip > 0) {
      cons_end = j + 1;
      --skip;
    } else if (shown) {
      vis[w++] = c;
    }
  }
  if (shown) w -= holdback(vis, w, m - cons_end, a.hide_start);
  return w;
}

// One stream, whole: what a thread of the kernel does.
__device__ __forceinline__ void filter_stream(const FilterArgs& a, int r) {
  const int len = a.lengths[r];
  const int n = len < 0 ? 0 : (len > a.L ? a.L : len);
  const uint8_t* buf = a.bufs + (size_t)r * a.L;
  uint8_t* vis = a.vis + (size_t)r * a.W;
  int* tab = a.table + (size_t)r * TABLE;
  const int m = extract(a, buf, n, a.ext + (size_t)r * a.L, vis, tab);
  const int vis_len = hide(a, vis, m);
  zero_fill(vis, vis_len, a.W);
  tab[2 * MAX_SPANS + 2] = vis_len;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(THREADS) chat_filter_kernel(
    const FilterArgs a) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r < a.n) filter_stream(a, r);
}
#endif

}  // namespace

// MAX_SPANS and TABLE, for the wrapper to check its layout against.
extern "C" int chat_filter_layout(int* out2) {
  out2[0] = MAX_SPANS;
  out2[1] = TABLE;
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
  const long long grid = ((long long)n + THREADS - 1) / THREADS;
  chat_filter_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
