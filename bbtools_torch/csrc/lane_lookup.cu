// Lane-table k-mer lookup: canonical int64 k-mer key -> scaffold id.
//
// Replaces the TPU kernel bbtools_tpu/ops/lane_index.py `_lane_kernel`
// (reached through `_lookup_pallas`). The table is the LaneKmerIndex
// layout built on the host: `nb = groups * 128` buckets of `slots`
// entries; entry s of bucket b sits at row (b >> 7) * rows + s, column
// b & 127 of three int32 planes (key low half, key high half, id), or of
// two planes in the packed layout, where the high plane holds hi << 16 | id.
//
// What bounds it on Hopper: random reads of the table. A query reads
// 8 bytes, writes 4, and walks up to `slots` table cells whose addresses
// depend on its hash, so neighbouring threads touch unrelated 128-byte
// lines. The tables of an adapter panel (a few hundred KB at most) stay
// resident in the 50 MB L2, so a lookup costs L2 latency, not HBM bytes.
// This first design is one thread per query with the table read through
// the read-only data cache (__ldg) and an early exit at the first match;
// staging the whole table in shared memory (it fits in 227 KB for the
// panels this index accepts) is left to a later change.
//
// The hash is computed in uint32_t: unsigned wraparound is defined in
// C++, and the logical shift followed by the masks of
// lane_index.py:_hash32_jnp gives the same bits as the TPU's
// arithmetic shift followed by the same masks, because the mask hides
// the sign bits. Stored keys are unique, so the first match (the rule of
// `_lookup_xla`) equals the Pallas kernel's last match.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t C1 = 0x9E3779B9u;  // golden-ratio odd constant
constexpr uint32_t C2 = 0xCC9E2D51u;  // murmur3 c1
constexpr uint32_t C3 = 0x1B873593u;  // murmur3 c2
constexpr int LANES = 128;
constexpr int THREADS = 256;

__global__ void lane_lookup_kernel(const int64_t* __restrict__ query,
                                   int32_t* __restrict__ out, int64_t n,
                                   const int32_t* __restrict__ tlo,
                                   const int32_t* __restrict__ thi,
                                   const int32_t* __restrict__ tid,
                                   int rows, int slots, uint32_t mask,
                                   int shift, uint32_t salt, int packed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t key = (uint64_t)query[i];
  const uint32_t lo = (uint32_t)key;
  const uint32_t hi = (uint32_t)(key >> 32);
  uint32_t h = lo * C1 + hi * C2 + salt;
  h ^= (h >> 15) & 0x1FFFFu;
  h *= C3;
  const uint32_t b = (h >> shift) & mask;
  const int64_t cell0 = (int64_t)(b >> 7) * rows * LANES + (b & (LANES - 1));
  int32_t found = 0;
  for (int s = 0; s < slots; ++s) {
    const int64_t cell = cell0 + (int64_t)s * LANES;
    if ((uint32_t)__ldg(tlo + cell) != lo) continue;
    const int32_t top = __ldg(thi + cell);
    int32_t id;
    if (packed) {
      if ((top >> 16) != (int32_t)hi) continue;
      id = top & 0xFFFF;
    } else {
      if (top != (int32_t)hi) continue;
      id = __ldg(tid + cell);
    }
    if (id != 0) {
      found = id;
      break;
    }
  }
  out[i] = found;
}

}  // namespace

// query/out: n int64 keys -> n int32 ids, on `stream`. The tables are
// int32 [groups * rows, 128] (tid unused when `packed`). Returns the
// cudaError_t of the launch.
extern "C" int lane_lookup(const int64_t* query, int32_t* out, int64_t n,
                           const int32_t* tlo, const int32_t* thi,
                           const int32_t* tid, int rows, int slots, int nb,
                           int shift, unsigned salt, int packed,
                           cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  lane_lookup_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      query, out, n, tlo, thi, tid, rows, slots, (uint32_t)(nb - 1), shift,
      (uint32_t)salt, packed);
  return (int)cudaGetLastError();
}
