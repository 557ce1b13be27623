// Row regrouping for the turbo step kernel (csrc/turbo_step.cu) on Hopper:
// a permutation of a batch's rows grouped by pc.
//
// The step kernel runs one instance a thread and a tile of T instances a
// block. A warp's 32 threads issue one instruction stream, so when the rows
// of a warp sit at different pcs they take their branches one after
// another. Before a launch of more than one wave of blocks the wrapper
// (ops/turbo_step.py launch_order) has this write `perm`, and the step
// kernel's tile slot s steps row perm[s].
//
// For regs (n, regw) int32 it writes perm (n int32): the rows whose status
// is RUNNING and whose pc lies in [0, P), binned by pc in pc order, then
// every other row (DONE, PARKED, or a pc the step kernel does not step) in
// one last bin, P; within a bin the rows keep their index order. The order
// is a function of the status and pc columns alone, equal bit for bit to
// ops/turbo_step.py regroup_reference, a stable sort by that key.
//
// Design: a counting sort in three launches on the caller's stream, with no
// host sync and nothing allocated (the caller keeps keys, counts and perm
// with the batch's shape). The rows are cut into C chunks of `chunk`
// consecutive rows, one block of THREADS threads a chunk:
//   1. regroup_count: reads each row's pc and status (one 32-byte sector a
//      row), writes its key to keys[i], and counts the chunk's rows a bin
//      in shared memory, once a warp for each key its rows share
//      (__match_any_sync); then writes counts[bin * C + c];
//   2. regroup_scan: one block turns counts into exclusive prefix sums in
//      that order (bin-major, chunk-minor), so that counts[bin * C + c] is
//      the first place of chunk c's rows of that bin;
//   3. regroup_scatter: walks its chunk in order, THREADS rows a round; a
//      row's place among its warp's rows of its key is the count of lower
//      lanes with that key, and the warps take their bins' next places one
//      after another, a barrier apart, so every bin keeps the row order.
// Count and scatter load ROUNDS rounds' rows at once, so that a thread's
// loads are in flight together; the scan moves 16 bytes a thread a load
// and loads SCAN_TILES tiles at once (on an H100 a scan of a thread's own
// stretch of entries took half of the regroup's time).
// The caller picks the chunk so that (P + 1) * C stays small for the one
// block of the scan. The bins live in shared memory: P + 1 ints, at most
// 48 KB (a program the step kernel stages in a block has far fewer
// instructions).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUNNING = 0;             // ops/turbo_step.py RUNNING
constexpr int C_PC = 0, C_STATUS = 1;  // ops/turbo_step.py register columns
constexpr int THREADS = 256;           // ops/turbo_step.py REGROUP_THREADS
constexpr int ROUNDS = 4;              // rounds of a chunk loaded at once
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_TILES = 4;          // tiles of the scan loaded at once
constexpr int MAX_BIN_BYTES = 48 * 1024;
constexpr unsigned ALL = 0xffffffffu;

__device__ __forceinline__ int key_of(const int* regs, int regw, int i,
                                      int P) {
  const int* r = regs + (size_t)i * regw;
  const int pc = r[C_PC];
  return (r[C_STATUS] == RUNNING && pc >= 0 && pc < P) ? pc : P;
}

__global__ void __launch_bounds__(THREADS)
    regroup_count(const int* regs, int n, int regw, int P, int chunk, int C,
                  int* keys, int* counts) {
  extern __shared__ int bins[];
  const int c = blockIdx.x, t = threadIdx.x, lane = t & 31;
  for (int k = t; k <= P; k += THREADS) bins[k] = 0;
  __syncthreads();
  const int i0 = c * chunk, i1 = min(n, i0 + chunk);
  // ROUNDS rounds of THREADS rows at a time, their loads in flight at once;
  // a row past the chunk has key -1
  for (int base = i0; base < i1; base += ROUNDS * THREADS) {
    int k[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = base + r * THREADS + t;
      k[r] = i < i1 ? key_of(regs, regw, i, P) : -1;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      if (k[r] >= 0) keys[base + r * THREADS + t] = k[r];
      const unsigned peers = __match_any_sync(ALL, k[r]);
      if (k[r] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&bins[k[r]], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = t; k <= P; k += THREADS) counts[(size_t)k * C + c] = bins[k];
}

// The inclusive sum of x over the lanes up to this one.
__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(ALL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive prefix sums of counts[0 .. m), in place, in tiles of
// 4 * SCAN_THREADS entries: thread t takes entries 4t .. 4t + 3 of a tile
// (one 16-byte load), the block scans the threads' sums, and the tiles'
// totals carry from one tile to the next; SCAN_TILES tiles are loaded
// before the first is scanned. counts is 16-byte aligned.
__global__ void __launch_bounds__(SCAN_THREADS)
    regroup_scan(int* counts, int m) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  constexpr int TILE = 4 * SCAN_THREADS;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += SCAN_TILES * TILE) {
    int v[SCAN_TILES][4];
#pragma unroll
    for (int q = 0; q < SCAN_TILES; ++q) {
      const int j = base + q * TILE + 4 * t;
      if (j + 3 < m) {
        const int4 x = *reinterpret_cast<const int4*>(counts + j);
        v[q][0] = x.x, v[q][1] = x.y, v[q][2] = x.z, v[q][3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[q][e] = j + e < m ? counts[j + e] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_TILES; ++q) {
      const int j = base + q * TILE + 4 * t;
      const int s = v[q][0] + v[q][1] + v[q][2] + v[q][3];
      const int x = warp_inclusive(s, lane);
      if (lane == 31) warp_sums[w] = x;
      __syncthreads();
      if (w == 0) warp_sums[lane] = warp_inclusive(warp_sums[lane], lane);
      __syncthreads();
      int run = carry + x - s + (w ? warp_sums[w - 1] : 0);
      carry += warp_sums[SCAN_THREADS / 32 - 1];
      int out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[e] = run;
        run += v[q][e];
      }
      if (j + 3 < m) {
        *reinterpret_cast<int4*>(counts + j) =
            make_int4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < m) counts[j + e] = out[e];
      }
      __syncthreads();  // warp_sums is the next tile's
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    regroup_scatter(const int* keys, int n, int P, int chunk, int C,
                    const int* counts, int* perm) {
  extern __shared__ int next[];  // each bin's next place
  const int c = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int k = t; k <= P; k += THREADS) next[k] = counts[(size_t)k * C + c];
  __syncthreads();
  const int i0 = c * chunk, i1 = min(n, i0 + chunk);
  for (int base = i0; base < i1; base += ROUNDS * THREADS) {
    int k[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = base + r * THREADS + t;
      k[r] = i < i1 ? keys[i] : -1;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const unsigned peers = __match_any_sync(ALL, k[r]);
      const int leader = __ffs(peers) - 1;
      int first = 0;
      for (int v = 0; v < THREADS / 32; ++v) {
        if (w == v && k[r] >= 0 && lane == leader) {
          first = next[k[r]];
          next[k[r]] = first + __popc(peers);
        }
        __syncthreads();
      }
      first = __shfl_sync(ALL, first, leader);
      if (k[r] >= 0)
        perm[first + __popc(peers & ((1u << lane) - 1u))] =
            base + r * THREADS + t;
    }
  }
}

}  // namespace

// Write perm for regs (n, regw) int32 on `stream`, the program having
// n_instr instructions; keys (n int32) and counts ((n_instr + 1) * C int32,
// C = ceil(n / chunk), 16-byte aligned) are scratch. chunk is a multiple of
// THREADS. Returns
// cudaGetLastError() (0 on success).
extern "C" int regroup_launch(const int* regs, int n, int regw, int n_instr,
                              int chunk, int* keys, int* counts, int* perm,
                              void* stream) {
  if (n <= 0) return 0;
  const long long bins = (long long)n_instr + 1;
  if (n_instr < 0 || regw < 2 || chunk <= 0 || chunk % THREADS != 0 ||
      bins * (long long)sizeof(int) > MAX_BIN_BYTES ||
      (uintptr_t)counts % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int C = (n + chunk - 1) / chunk;
  if (bins * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t shared = (size_t)bins * sizeof(int);
  regroup_count<<<C, THREADS, shared, s>>>(regs, n, regw, n_instr, chunk, C,
                                           keys, counts);
  regroup_scan<<<1, SCAN_THREADS, 0, s>>>(counts, (int)(bins * C));
  regroup_scatter<<<C, THREADS, shared, s>>>(keys, n, n_instr, chunk, C,
                                             counts, perm);
  return (int)cudaGetLastError();
}
