// Small constant-table lookup: out[i] = table[idx[i]] for a table of at
// most 2,048 32-bit entries (BBMerge's f32 quality and increment tables).
//
// Replaces the TPU kernel bbtools_tpu/ops/lane_table.py `_kernel`
// (reached through `_lookup_pallas`). The TPU has no fast per-element
// gather, so its kernel tiles the table over 128-lane rows and selects
// row by row; that loop is only the TPU's way to a gather. A GPU thread
// can read any shared-memory word, so this kernel copies the table into
// shared memory once per block and reads one entry per index.
//
// What bounds it on Hopper: the index and output streams, 4 bytes in and
// 4 out per element (16.8 MB for one BBMerge batch's 2,097,152 phred
// indices: 5.0 us at 3.35 TB/s); the table reads hit shared memory. A
// stream is only as fast as the bytes it keeps in flight: 3.35 TB/s at
// ~0.6-0.7 us of latency needs >= 2 MB outstanding. So each thread moves
// 16-byte vectors, int4 of indices in and uint4 of words out, UNROLL of
// them issued before the first is used, over a grid of at most 8 blocks
// of 256 threads per SM (full occupancy): 132 x 2,048 threads x 32 bytes
// = 8.6 MB can be in flight. The grid shrinks to the vectors there are,
// so a block exists only where it has work and loads the table (8 KB at
// most) once.
//
// A tail of up to 3 elements runs as scalars in the same kernel; where
// `idx` or `out` is not 16-byte aligned (a view at an element offset),
// every element does.
//
// Entries are copied as 32-bit words, never as values, so an f32 table
// comes out bit for bit. An index outside [0, n_table) reads 0, as the
// TPU kernel's row select gives.
//
// `lane_table_variant` also runs, for measurement only, the original
// kernel: one 4-byte index per thread per iteration over a grid of at
// most 8 blocks of 256 threads per SM, which keeps about 1 MB in flight.
// On an H100 SXM, with the indices past the L2, it takes 0.0090 ms to
// this kernel's 0.0082 ms (PERF.md): the memory system kept more in
// flight than that estimate, so the vectors gain ~10%, not the 2-4x the
// arithmetic above suggests.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ENTRIES = 2048;
constexpr int MAX_BLOCKS = 132 * 8;
constexpr int UNROLL = 2;

__device__ __forceinline__ uint32_t pick(const uint32_t* tab, int32_t j,
                                         int n_table) {
  return (uint32_t)j < (uint32_t)n_table ? tab[j] : 0u;
}

// nvec 16-byte vectors, then elements [4 nvec, n) as scalars.
__global__ void __launch_bounds__(THREADS)
    lane_table_kernel(const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int64_t n, int64_t nvec,
                      const uint32_t* __restrict__ table, int n_table) {
  __shared__ uint32_t tab[MAX_ENTRIES];
  for (int t = threadIdx.x; t < n_table; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  const int4* vi = reinterpret_cast<const int4*>(idx);
  uint4* vo = reinterpret_cast<uint4*>(out);
  for (int64_t v0 = tid; v0 < nvec; v0 += UNROLL * stride) {
    int4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) x[u] = vi[v];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec)
        vo[v] = make_uint4(pick(tab, x[u].x, n_table), pick(tab, x[u].y, n_table),
                           pick(tab, x[u].z, n_table), pick(tab, x[u].w, n_table));
    }
  }
  for (int64_t i = 4 * nvec + tid; i < n; i += stride)
    out[i] = pick(tab, idx[i], n_table);
}

// The original kernel, kept for the before/after timing only.
__global__ void lane_table_scalar_kernel(const int32_t* __restrict__ idx,
                                         uint32_t* __restrict__ out, int64_t n,
                                         const uint32_t* __restrict__ table,
                                         int n_table) {
  __shared__ uint32_t tab[MAX_ENTRIES];
  for (int t = threadIdx.x; t < n_table; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = pick(tab, idx[i], n_table);
}

int run(int variant, const int32_t* idx, uint32_t* out, int64_t n,
        const uint32_t* table, int n_table, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_table < 0 || n_table > MAX_ENTRIES) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    int64_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    lane_table_scalar_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        idx, out, n, table, n_table);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int64_t nvec = aligned ? n / 4 : 0;
  const int64_t work = nvec > 0 ? (nvec + UNROLL - 1) / UNROLL : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  lane_table_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      idx, out, n, nvec, table, n_table);
  return (int)cudaGetLastError();
}

}  // namespace

// idx: n int32 indices -> out: n 32-bit words, on `stream`. `table` holds
// n_table (<= 2048) 32-bit words. Returns the cudaError_t of the launch.
extern "C" int lane_table(const int32_t* idx, uint32_t* out, int64_t n,
                          const uint32_t* table, int n_table,
                          cudaStream_t stream) {
  return run(0, idx, out, n, table, n_table, stream);
}

// The same, plus `variant`: 0 the kernel above, 1 the original kernel.
extern "C" int lane_table_variant(const int32_t* idx, uint32_t* out, int64_t n,
                                  const uint32_t* table, int n_table,
                                  int variant, cudaStream_t stream) {
  return run(variant, idx, out, n, table, n_table, stream);
}
