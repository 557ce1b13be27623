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
// Design. One warp per row. The Pallas kernel widened the bytes to int32
// lanes for Mosaic's tiling and reduced over a (256, MS) block in VMEM; here
// the bytes are read as uint8, the 32 lanes stride the row (neighbouring
// lanes read neighbouring bytes), and warp reductions combine the lanes:
// __reduce_add_sync for the counts and __reduce_max_sync for outer_from,
// then a second strided pass from outer_from + 1 in which each lane stops
// at its first visible '}' and __reduce_min_sync picks the first.
//
// What bounds it on this card: device-memory reads, MS bytes per row and
// 16 bytes written, with a few compares per byte. The first design reads a
// byte per lane per iteration (32-byte warp transactions) and rereads the
// byte before each brace; wider loads are the next step if the scan ever
// shows up in a profile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ bool visible(const uint8_t* b, int p) {
  return p == 0 || b[p - 1] != '\\';
}

__global__ void brace_scan_kernel(const uint8_t* __restrict__ bufs,
                                  const int* __restrict__ lengths,
                                  int* __restrict__ out, int n, int ms) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const uint8_t* b = bufs + row * (long long)ms;
  int len = lengths[row];
  len = len < 0 ? 0 : (len > ms ? ms : len);

  int n_open = 0, n_close = 0, outer = -1;
  for (int p = lane; p < len; p += 32) {
    const uint8_t c = b[p];
    if ((c == '{' || c == '}') && visible(b, p)) {
      if (c == '{') {
        ++n_open;
        outer = p;  // p only grows, so this is the lane's rightmost
      } else {
        ++n_close;
      }
    }
  }
  n_open = __reduce_add_sync(FULL, n_open);
  n_close = __reduce_add_sync(FULL, n_close);
  outer = __reduce_max_sync(FULL, outer);

  int inner = NONE;
  for (int p = outer + 1 + lane; p < len; p += 32) {
    if (b[p] == '}' && visible(b, p)) {
      inner = p;  // the lane's first, since p only grows
      break;
    }
  }
  inner = __reduce_min_sync(FULL, inner);

  if (lane < 4) {
    const int v[4] = {n_open, n_close, outer, inner == NONE ? -1 : inner};
    out[row * 4 + lane] = v[lane];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int brace_scan_launch(const uint8_t* bufs, const int* lengths,
                                 int* out, int n, int ms, void* stream) {
  if (n <= 0) return 0;
  if (ms < 0) return (int)cudaErrorInvalidValue;
  const long long grid = ((long long)n + WARPS_PER_BLOCK - 1) /
                         WARPS_PER_BLOCK;
  brace_scan_kernel<<<(unsigned)grid, 32 * WARPS_PER_BLOCK, 0,
                      (cudaStream_t)stream>>>(bufs, lengths, out, n, ms);
  return (int)cudaGetLastError();
}
