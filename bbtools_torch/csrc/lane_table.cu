// Small constant-table lookup: out[i] = table[idx[i]] for a table of at
// most 2,048 32-bit entries (BBMerge's f32 quality and increment tables).
//
// Replaces the TPU kernel bbtools_tpu/ops/lane_table.py `_kernel`
// (reached through `_lookup_pallas`). The TPU has no fast per-element
// gather, so its kernel tiles the table over 128-lane rows and selects
// row by row; that loop is only the TPU's way to a gather. A GPU thread
// can read any shared-memory word, so this kernel copies the table into
// shared memory once per block and then does one read per index.
//
// What bounds it on Hopper: the index and output streams (4 bytes in, 4
// out per element); the table reads hit shared memory. Blocks walk the
// index array with a grid stride, so the grid stays a few blocks per SM
// and each block loads the table (8 KB at most) once.
//
// Entries are copied as 32-bit words, never as values, so an f32 table
// comes out bit for bit. An index outside [0, n_table) reads 0, as the
// TPU kernel's row select gives.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ENTRIES = 2048;
constexpr int MAX_BLOCKS = 132 * 8;

__global__ void lane_table_kernel(const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int64_t n,
                                  const uint32_t* __restrict__ table,
                                  int n_table) {
  __shared__ uint32_t tab[MAX_ENTRIES];
  for (int t = threadIdx.x; t < n_table; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t j = idx[i];
    out[i] = (j >= 0 && j < n_table) ? tab[j] : 0u;
  }
}

}  // namespace

// idx: n int32 indices -> out: n 32-bit words, on `stream`. `table` holds
// n_table (<= 2048) 32-bit words. Returns the cudaError_t of the launch.
extern "C" int lane_table(const int32_t* idx, uint32_t* out, int64_t n,
                          const uint32_t* table, int n_table,
                          cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_table < 0 || n_table > MAX_ENTRIES) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  lane_table_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(idx, out, n,
                                                              table, n_table);
  return (int)cudaGetLastError();
}
