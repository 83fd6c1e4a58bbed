// Inclusive int64 prefix max over a flat vector.
//
// Replaces the TPU kernel bbtools_tpu/ops/scan_pallas.py `_cummax_kernel`
// (reached through `cummax_i64_pallas`). In the sorted join
// (ops/sort_join.py) it carries each index row's (row << 17 | is_idx << 16
// | id) word to the query rows sorted after it.
//
// What bounds it on Hopper: device-memory bytes. The scan reads and
// writes 8 bytes per element and does one compare, so at the join's
// ~1.3M elements it is a few microseconds of HBM traffic plus launch
// latency. The TPU kernel split int64 into int32 halves because Mosaic's
// int64 support is partial; Hopper has native 64-bit compares and 64-bit
// warp shuffles, so the scan works on int64 directly.
//
// Design, three launches on the caller's stream:
//   1. each block scans a tile of TILE elements: every thread takes
//      ITEMS consecutive elements sequentially, the threads' running
//      maxima are scanned with __shfl_up_sync within each warp and
//      through shared memory across warps; the tile's maximum goes to
//      `tile_max`;
//   2. one block scans `tile_max` in place (inclusive);
//   3. every tile but the first takes the max with its predecessor's
//      inclusive tile maximum.
// The identity is INT64_MIN. A single-pass decoupled look-back scan is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int64_t IDENT = INT64_MIN;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t shfl_up(int64_t v, int d) {
  return (int64_t)__shfl_up_sync(FULL, (long long)v, d);
}

__device__ __forceinline__ int64_t warp_inclusive_max(int64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = shfl_up(v, d);
    if (lane >= d) v = imax(v, o);
  }
  return v;
}

// Exclusive prefix max of one value per thread across the block
// (IDENT for thread 0); *total receives the block's maximum. Ends with a
// barrier, so callers may call it again in a loop.
__device__ int64_t block_exclusive_max(int64_t v, int64_t* total) {
  __shared__ int64_t warp_max[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t incl = warp_inclusive_max(v);
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < WARPS ? warp_max[lane] : IDENT;
    w = warp_inclusive_max(w);
    if (lane < WARPS) warp_max[lane] = w;
  }
  __syncthreads();
  int64_t excl = shfl_up(incl, 1);
  if (lane == 0) excl = IDENT;
  if (warp > 0) excl = imax(excl, warp_max[warp - 1]);
  *total = warp_max[WARPS - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(THREADS)
cummax_tile_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   int64_t n, int64_t* __restrict__ tile_max) {
  const int64_t base = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * ITEMS;
  int64_t run[ITEMS];
  int64_t acc = IDENT;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = base + j;
    acc = imax(acc, i < n ? in[i] : IDENT);
    run[j] = acc;
  }
  int64_t total;
  const int64_t excl = block_exclusive_max(acc, &total);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = base + j;
    if (i < n) out[i] = imax(run[j], excl);
  }
  if (threadIdx.x == 0) tile_max[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
cummax_carry_kernel(int64_t* __restrict__ tile_max, int64_t ntiles) {
  int64_t carry = IDENT;
  for (int64_t start = 0; start < ntiles; start += THREADS) {
    const int64_t i = start + threadIdx.x;
    const int64_t x = i < ntiles ? tile_max[i] : IDENT;
    int64_t total;
    const int64_t excl = block_exclusive_max(x, &total);
    if (i < ntiles) tile_max[i] = imax(imax(excl, x), carry);
    carry = imax(carry, total);
  }
}

__global__ void __launch_bounds__(THREADS)
cummax_fixup_kernel(int64_t* __restrict__ out, int64_t n,
                    const int64_t* __restrict__ tile_max) {
  const int64_t tile = (int64_t)blockIdx.x + 1;  // tile 0 has no carry
  const int64_t carry = tile_max[tile - 1];
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int64_t i = tile * TILE + j;
    if (i < n) out[i] = imax(out[i], carry);
  }
}

}  // namespace

// Elements per tile; the caller allocates ceil(n / TILE) int64 of
// `tile_max` scratch.
extern "C" int cummax_i64_tile() { return TILE; }

// out[i] = max(in[0..i]) for n int64 on `stream`; `in` and `out` may not
// overlap. Returns the cudaError_t of the launches.
extern "C" int cummax_i64(const int64_t* in, int64_t* out, int64_t n,
                          int64_t* tile_max, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  cummax_tile_kernel<<<(unsigned)ntiles, THREADS, 0, stream>>>(in, out, n,
                                                               tile_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return (int)err;
  cummax_carry_kernel<<<1, THREADS, 0, stream>>>(tile_max, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cummax_fixup_kernel<<<(unsigned)(ntiles - 1), THREADS, 0, stream>>>(
      out, n, tile_max);
  return (int)cudaGetLastError();
}
