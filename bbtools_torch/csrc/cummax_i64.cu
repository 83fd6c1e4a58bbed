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
// Design: one launch that reads and writes every element once, a
// single-pass scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//   * Each block draws its tile from a counter in the scratch (an atomic
//     ticket), so the tiles before it have always been drawn by blocks
//     that are running or done: waiting on them cannot deadlock.
//   * A warp holds ITEMS / 2 rows of 64 elements; each lane loads two
//     consecutive elements of a row with one 16-byte load (a warp reads
//     512 contiguous bytes), scans the row across lanes with 64-bit
//     shuffles, and carries the row maxima down its rows. Warp maxima are
//     scanned through shared memory.
//   * Warp 0 publishes the tile's maximum (AGGREGATE), looks back over
//     the records of the 32 tiles before it at a time, taking their
//     aggregates until it meets an INCLUSIVE prefix, and publishes its
//     own inclusive prefix. Each record is written value first, then its
//     flag with release semantics; a reader loads the flag with acquire
//     semantics, then the value.
//   * Every flag carries the call's epoch, which sits in the scratch
//     above the ticket counter (one atomic add draws both) and which the
//     block drawing the last ticket advances, resetting the ticket. The
//     records of earlier calls read as not ready, so the scratch is
//     zeroed when it is allocated and not before each call. The wrapper
//     (ops/scan.py) keeps one buffer per stream for eager calls and one
//     per CUDA graph capture: a graph records its buffer's zeroing, once
//     a replay however many calls it holds, so graphs replayed at the
//     same time never share a ticket counter.
// The identity is INT64_MIN.
//
// Kept as the measurement variant "three_pass": the first port's kernel
// (a tile scan, a one-block scan of the tile maxima, and a fix-up pass
// that reads and writes every element but the first tile's a second
// time).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int64_t IDENT = INT64_MIN;
constexpr unsigned FULL = 0xFFFFFFFFu;
// elements per thread of the one-pass kernel, two to a 16-byte load
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
static_assert(ITEMS % 2 == 0, "a lane loads pairs");
// scratch: a header of HEADER words, the first the call's epoch above
// TICKET_BITS bits of ticket, then one record of RECORD words per tile:
// flag, aggregate, inclusive prefix, padding
constexpr int HEADER = 4;
constexpr int RECORD = 4;
constexpr int TICKET_BITS = 24;
constexpr unsigned long long TICKET_MASK = (1ull << TICKET_BITS) - 1;
constexpr unsigned long long AGGREGATE = 1, INCLUSIVE = 2;

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t shfl_up(int64_t v, int d) {
  return (int64_t)__shfl_up_sync(FULL, (long long)v, d);
}

__device__ __forceinline__ int64_t shfl(int64_t v, int src) {
  return (int64_t)__shfl_sync(FULL, (long long)v, src);
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

__device__ __forceinline__ int64_t warp_max(int64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = imax(v, (int64_t)__shfl_xor_sync(FULL, (long long)v, d));
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Publish a tile's value into word `status` of its record (1 the
// aggregate, 2 the inclusive prefix), then its flag.
__device__ __forceinline__ void publish(unsigned long long* rec, unsigned long long epoch,
                                        unsigned long long status, int64_t v) {
  __stcg(reinterpret_cast<long long*>(rec) + status, (long long)v);
  st_release(rec, (epoch << 2) | status);
}

// Warp 0 of tile `tile` (> 0): the max of every element before the tile,
// read from its predecessors' records, 32 at a time.
__device__ int64_t look_back(const unsigned long long* records, int64_t tile,
                             unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  int64_t prefix = IDENT;
  for (int64_t base = tile - 1;; base -= 32) {
    const int64_t p = base - lane;
    const unsigned long long* rec = records + p * RECORD;
    unsigned long long status;
    do {
      // lanes past tile 0 never count: tile 0 is always inclusive
      status = INCLUSIVE;
      if (p >= 0) {
        const unsigned long long f = ld_acquire(rec);
        status = (f >> 2) == epoch ? (f & 3) : 0;
      }
    } while (__any_sync(FULL, status == 0));
    int64_t v = IDENT;
    if (p >= 0) v = (int64_t)__ldcg(reinterpret_cast<const long long*>(rec) + status);
    const unsigned incl = __ballot_sync(FULL, status == INCLUSIVE);
    // the nearest inclusive predecessor ends the walk; those after it
    // contribute their aggregates
    const int last = incl ? __ffs(incl) - 1 : 31;
    prefix = imax(prefix, warp_max(lane <= last ? v : IDENT));
    if (incl) return prefix;
  }
}

__global__ void __launch_bounds__(THREADS)
cummax_one_pass_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                       int64_t n, int64_t ntiles, unsigned long long* __restrict__ scratch) {
  constexpr int ROWS = ITEMS / 2;
  __shared__ unsigned long long s_tile, s_epoch;
  __shared__ int64_t s_warp[WARPS];
  __shared__ int64_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* records = scratch + HEADER;

  if (threadIdx.x == 0) {
    // one atomic gives the call's epoch and the block's ticket; the block
    // that draws the last ticket, after every other block has drawn its
    // own, starts the next call's epoch at ticket 0
    const unsigned long long h = atomicAdd(scratch, 1ull);
    const unsigned long long t = h & TICKET_MASK;
    if (t == (unsigned long long)ntiles - 1)
      atomicExch(scratch, ((h >> TICKET_BITS) + 1) << TICKET_BITS);
    s_tile = t;
    s_epoch = h >> TICKET_BITS;
  }
  __syncthreads();
  const int64_t tile = (int64_t)s_tile;
  const unsigned long long epoch = s_epoch;

  // warp `warp` owns ROWS rows of 64 elements; lane holds a pair per row
  const int64_t base = tile * TILE + (int64_t)warp * 64 * ROWS + 2 * lane;
  const bool vec = tile * TILE + TILE <= n &&
                   ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int64_t x0[ROWS], x1[ROWS];
  if (vec) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(in + base + 64 * r);
      x0[r] = v.x;
      x1[r] = v.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t i = base + 64 * r;
      x0[r] = i < n ? in[i] : IDENT;
      x1[r] = i + 1 < n ? in[i + 1] : IDENT;
    }
  }
  // rows in order: each element's max over the warp's elements up to it
  int64_t carry = IDENT;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t incl = warp_inclusive_max(imax(x0[r], x1[r]));
    int64_t before = shfl_up(incl, 1);
    if (lane == 0) before = IDENT;
    x0[r] = imax(imax(carry, before), x0[r]);
    x1[r] = imax(x0[r], x1[r]);
    carry = imax(carry, shfl(incl, 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int64_t w = warp_inclusive_max(lane < WARPS ? s_warp[lane] : IDENT);
    const int64_t agg = shfl(w, WARPS - 1);
    int64_t before = shfl_up(w, 1);
    if (lane < WARPS) s_warp[lane] = lane == 0 ? IDENT : before;
    unsigned long long* rec = records + tile * RECORD;
    int64_t prefix = IDENT;
    if (tile == 0) {
      if (lane == 0) publish(rec, epoch, INCLUSIVE, agg);
    } else {
      if (lane == 0) publish(rec, epoch, AGGREGATE, agg);
      prefix = look_back(records, tile, epoch);
      if (lane == 0) publish(rec, epoch, INCLUSIVE, imax(prefix, agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int64_t add = imax(s_prefix, s_warp[warp]);
  if (vec) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      longlong2 v;
      v.x = imax(add, x0[r]);
      v.y = imax(add, x1[r]);
      *reinterpret_cast<longlong2*>(out + base + 64 * r) = v;
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t i = base + 64 * r;
      if (i < n) out[i] = imax(add, x0[r]);
      if (i + 1 < n) out[i + 1] = imax(add, x1[r]);
    }
  }
}

// ---- the variant "three_pass": the first port's three-launch kernel ----

constexpr int TP_ITEMS = 8;
constexpr int TP_TILE = THREADS * TP_ITEMS;

// Exclusive prefix max of one value per thread across the block
// (IDENT for thread 0); *total receives the block's maximum. Ends with a
// barrier, so callers may call it again in a loop.
__device__ int64_t block_exclusive_max(int64_t v, int64_t* total) {
  __shared__ int64_t warp_max_s[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t incl = warp_inclusive_max(v);
  if (lane == 31) warp_max_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < WARPS ? warp_max_s[lane] : IDENT;
    w = warp_inclusive_max(w);
    if (lane < WARPS) warp_max_s[lane] = w;
  }
  __syncthreads();
  int64_t excl = shfl_up(incl, 1);
  if (lane == 0) excl = IDENT;
  if (warp > 0) excl = imax(excl, warp_max_s[warp - 1]);
  *total = warp_max_s[WARPS - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(THREADS)
cummax_tile_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   int64_t n, int64_t* __restrict__ tile_max) {
  const int64_t base = (int64_t)blockIdx.x * TP_TILE + (int64_t)threadIdx.x * TP_ITEMS;
  int64_t run[TP_ITEMS];
  int64_t acc = IDENT;
#pragma unroll
  for (int j = 0; j < TP_ITEMS; ++j) {
    const int64_t i = base + j;
    acc = imax(acc, i < n ? in[i] : IDENT);
    run[j] = acc;
  }
  int64_t total;
  const int64_t excl = block_exclusive_max(acc, &total);
#pragma unroll
  for (int j = 0; j < TP_ITEMS; ++j) {
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
  for (int j = threadIdx.x; j < TP_TILE; j += THREADS) {
    const int64_t i = tile * TP_TILE + j;
    if (i < n) out[i] = imax(out[i], carry);
  }
}

int three_pass(const int64_t* in, int64_t* out, int64_t n, int64_t* tile_max,
               cudaStream_t stream) {
  const int64_t ntiles = (n + TP_TILE - 1) / TP_TILE;
  cummax_tile_kernel<<<(unsigned)ntiles, THREADS, 0, stream>>>(in, out, n, tile_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return (int)err;
  cummax_carry_kernel<<<1, THREADS, 0, stream>>>(tile_max, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cummax_fixup_kernel<<<(unsigned)(ntiles - 1), THREADS, 0, stream>>>(out, n, tile_max);
  return (int)cudaGetLastError();
}

int one_pass(const int64_t* in, int64_t* out, int64_t n, unsigned long long* scratch,
             cudaStream_t stream) {
  const int64_t ntiles = (n + TILE - 1) / TILE;
  if (ntiles > (int64_t)TICKET_MASK) return (int)cudaErrorInvalidValue;
  cummax_one_pass_kernel<<<(unsigned)ntiles, THREADS, 0, stream>>>(in, out, n, ntiles,
                                                                    scratch);
  return (int)cudaGetLastError();
}

int run(int variant, const int64_t* in, int64_t* out, int64_t n, int64_t* scratch,
        cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  switch (variant) {
    case 0: return one_pass(in, out, n, reinterpret_cast<unsigned long long*>(scratch), stream);
    case 1: return three_pass(in, out, n, scratch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Elements per tile of the one-pass kernel.
extern "C" int cummax_i64_tile() { return TILE; }

// int64 words of scratch a call of `variant` on n elements needs: the
// one-pass kernel's header and tile records (0), or "three_pass"'s tile
// maxima (1); -1 for an unknown variant.
extern "C" int64_t cummax_i64_scratch(int64_t n, int variant) {
  switch (variant) {
    case 0: return HEADER + RECORD * ((n + TILE - 1) / TILE);
    case 1: return (n + TP_TILE - 1) / TP_TILE;
  }
  return -1;
}

// The id of the CUDA graph capture under way on `stream`, or 0 where none
// is: scratch that a capture allocates belongs to that capture's graph.
extern "C" unsigned long long cummax_i64_capture_id(cudaStream_t stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(stream, &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// out[i] = max(in[0..i]) for n int64 on `stream`; `in` and `out` may not
// overlap; `scratch` holds cummax_i64_scratch(n, 0) int64, zeroed when it
// was allocated, and is used by no call that may run at the same time
// (another stream, or another graph's replay). Returns the cudaError_t of
// the launch.
extern "C" int cummax_i64(const int64_t* in, int64_t* out, int64_t n, int64_t* scratch,
                          cudaStream_t stream) {
  return run(0, in, out, n, scratch, stream);
}

// The same, plus `variant`: 0 the kernel above, 1 "three_pass" (whose
// scratch holds cummax_i64_scratch(n, 1) int64, no zeroing needed).
extern "C" int cummax_i64_variant(const int64_t* in, int64_t* out, int64_t n,
                                  int64_t* scratch, int variant, cudaStream_t stream) {
  return run(variant, in, out, n, scratch, stream);
}
