// Lane-table k-mer lookup: canonical int64 k-mer key -> scaffold id.
//
// Replaces the TPU kernel bbtools_tpu/ops/lane_index.py `_lane_kernel`
// (reached through `_lookup_pallas`). The table is the LaneKmerIndex
// layout built on the host: `nb = groups * 128` buckets of `slots`
// entries; entry s of bucket b sits at row (b >> 7) * rows + s, column
// b & 127 of three int32 planes (key low half, key high half, id), or of
// two planes in the packed layout, where the high plane holds hi << 16 | id.
//
// What bounds it on Hopper: the key and id streams, 8 bytes in and 4 out
// per query (50 MB for one BBDuk batch's 4,194,304 full-k keys: 15 us at
// 3.35 TB/s). A query also probes up to `slots` table cells whose
// addresses depend on its hash, so neighbouring threads touch unrelated
// words. The original kernel (one thread per query, the probes through the
// read-only cache from L2) made each lookup a chain of dependent L2 round
// trips and reached ~0.7 TB/s of the streams.
//
// The main kernel, `lane_lookup_shared_kernel`, takes tables that fit in
// shared memory (an adapter panel's is a few tens of KB): a persistent
// grid of as many blocks as are resident on the SMs (two of 1,024
// threads an SM), each copying the planes into shared memory once,
// bucket-major (a bucket's slots contiguous), so that every probe is a
// shared-memory read and one 16-byte read takes four slots of a bucket.
// While staging, a block notes for each bucket one past its last slot
// (of the first `slots`) with a nonzero id: no slot after it can match (a
// hit needs id != 0).
// And it sets one bit of a 65,536-bit filter for each stored key with a
// nonzero id, at the low 16 bits of the key's hash (the bucket takes the
// high bits): a query whose bit is clear cannot match and probes no
// slot. For an adapter panel's ~2,000 keys, ~3% of the misses find their
// bit set. Each thread then takes 4 queries an iteration: two 16-byte
// loads of keys, the four lookups, one 16-byte store of ids; a tail of up
// to 3 queries runs as scalars, and so does every query where `query` or
// `out` is not 16-byte aligned (a view at an element offset).
//
// On one H100 (PERF.md) the key and id streams alone, with this access
// pattern, take ~0.019 ms of the kernel; staging ~0.004 ms; the rest is
// the probes of the queries that pass the filter, which hold their warp.
//
// Tables too large for shared memory (up to LaneKmerIndex.MAX_COST x 128
// keys: ~1.5 MB of planes) keep the original kernel, `lane_lookup_l2_kernel`,
// which is also the measurement variant "scalar". The wrapper chooses by
// the table's bytes against the device's opt-in shared-memory limit.
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
constexpr int THREADS = 256;         // the L2-probe kernel
constexpr int SHARED_THREADS = 1024;  // the shared-memory kernel
constexpr int FILTER_WORDS = 2048;    // 65,536 bits

__device__ __forceinline__ uint32_t hash32(uint32_t lo, uint32_t hi, uint32_t salt) {
  uint32_t h = lo * C1 + hi * C2 + salt;
  h ^= (h >> 15) & 0x1FFFFu;
  return h * C3;
}

__device__ __forceinline__ uint32_t bucket_of(uint32_t lo, uint32_t hi, uint32_t salt,
                                              int shift, uint32_t mask) {
  return (hash32(lo, hi, salt) >> shift) & mask;
}

// The original kernel: one query per thread, the table read through __ldg.
__global__ void lane_lookup_l2_kernel(const int64_t* __restrict__ query,
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
  const uint32_t b = bucket_of(lo, hi, salt, shift, mask);
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

// The table in shared memory, bucket-major: bucket b's slots at
// [b * stride, b * stride + rows) of each plane, with `stride` a multiple
// of 4 words and an odd number of 16-byte units, so that the 16-byte
// reads of random buckets by neighbouring lanes spread over the banks;
// the filter; and per bucket the slots up to its last nonzero id.
struct SharedTable {
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* id;
  const uint32_t* filter;
  const int* used;
  int stride;
  uint32_t mask, salt;
  int shift;
};

__host__ __device__ constexpr int bucket_stride(int rows) {
  return 4 * (((rows + 3) / 4) | 1);
}

template <bool PACKED>
__device__ __forceinline__ int32_t probe(const SharedTable& t, int64_t query) {
  const uint64_t key = (uint64_t)query;
  const uint32_t lo = (uint32_t)key;
  const uint32_t hi = (uint32_t)(key >> 32);
  const uint32_t h = hash32(lo, hi, t.salt);
  if (!((t.filter[(h >> 5) & (FILTER_WORDS - 1)] >> (h & 31)) & 1u)) return 0;
  const int b = (int)((h >> t.shift) & t.mask);
  const int base = b * t.stride;
  const int used = t.used[b];
  // four slots a read, in slot order: the first match wins
  for (int s = 0; s < used; s += 4) {
    const int4 l4 = *reinterpret_cast<const int4*>(t.lo + base + s);
    const int32_t los[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((uint32_t)los[j] != lo || s + j >= used) continue;
      const int cell = base + s + j;
      const int32_t top = t.hi[cell];
      int32_t id;
      if (PACKED) {
        if ((top >> 16) != (int32_t)hi) continue;
        id = top & 0xFFFF;
      } else {
        if (top != (int32_t)hi) continue;
        id = t.id[cell];
      }
      if (id != 0) return id;
    }
  }
  return 0;
}

// Global cell i of a plane, (g * rows + s) * 128 + l, holds slot s of
// bucket g * 128 + l: its word in the bucket-major shared plane.
__device__ __forceinline__ int shared_cell(int i, int rows, int stride, int* b, int* s) {
  const int gs = i / LANES;
  const int g = gs / rows;
  *s = gs - g * rows;
  *b = g * LANES + (i & (LANES - 1));
  return *b * stride + *s;
}

// nvec groups of 4 queries as 16-byte vectors, then queries [4 nvec, n)
// as scalars.
template <bool PACKED>
__global__ void __launch_bounds__(SHARED_THREADS)
    lane_lookup_shared_kernel(const int64_t* __restrict__ query,
                              int32_t* __restrict__ out, int64_t n, int64_t nvec,
                              const int32_t* __restrict__ tlo,
                              const int32_t* __restrict__ thi,
                              const int32_t* __restrict__ tid, int rows, int slots,
                              int nb, int shift, uint32_t salt) {
  extern __shared__ int4 smem4[];
  const int stride = bucket_stride(rows);
  const int words = nb * stride;
  const int cells = (nb / LANES) * rows * LANES;
  int32_t* slo = reinterpret_cast<int32_t*>(smem4);
  int32_t* shi = slo + words;
  int32_t* sid = shi + words;  // PACKED: no id plane
  uint32_t* filter = reinterpret_cast<uint32_t*>(PACKED ? sid : sid + words);
  int* used = reinterpret_cast<int*>(filter + FILTER_WORDS);
  for (int i = threadIdx.x; i < FILTER_WORDS; i += blockDim.x) filter[i] = 0u;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    used[b] = 0;
    for (int s = rows; s < stride; ++s) {  // pad slots: id 0, never a hit
      slo[b * stride + s] = shi[b * stride + s] = 0;
      if (!PACKED) sid[b * stride + s] = 0;
    }
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    int b, s;
    const int c = shared_cell(i, rows, stride, &b, &s);
    slo[c] = __ldg(tlo + i);
    shi[c] = __ldg(thi + i);
    if (!PACKED) sid[c] = __ldg(tid + i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    int b, s;
    const int c = shared_cell(i, rows, stride, &b, &s);
    const int32_t top = shi[c];
    if (s >= slots || (PACKED ? (top & 0xFFFF) : sid[c]) == 0) continue;
    atomicMax(used + b, s + 1);
    // the hash a query equal to this key computes: its high half is the
    // stored one (packed: top >> 16, sign-extended as it is compared)
    const uint32_t h = hash32((uint32_t)slo[c], (uint32_t)(PACKED ? top >> 16 : top), salt);
    atomicOr(filter + ((h >> 5) & (FILTER_WORDS - 1)), 1u << (h & 31));
  }
  __syncthreads();

  const SharedTable t{slo, shi, sid, filter, used, stride, (uint32_t)(nb - 1), salt, shift};
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const longlong2* q2 = reinterpret_cast<const longlong2*>(query);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t v = start; v < nvec; v += step) {
    const longlong2 a = q2[2 * v];
    const longlong2 b = q2[2 * v + 1];
    o4[v] = make_int4(probe<PACKED>(t, a.x), probe<PACKED>(t, a.y),
                      probe<PACKED>(t, b.x), probe<PACKED>(t, b.y));
  }
  for (int64_t i = 4 * nvec + start; i < n; i += step)
    out[i] = probe<PACKED>(t, query[i]);
}

size_t shared_bytes(int rows, int nb, int packed) {
  const size_t words = (size_t)nb * bucket_stride(rows);
  return words * 4 * (packed ? 2 : 3) + FILTER_WORDS * 4 + (size_t)nb * 4;
}

int optin_limit(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

template <bool PACKED>
int launch_shared(const int64_t* query, int32_t* out, int64_t n, const int32_t* tlo,
                  const int32_t* thi, const int32_t* tid, int rows, int slots, int nb,
                  int shift, uint32_t salt, cudaStream_t stream) {
  const size_t smem = shared_bytes(rows, nb, PACKED);
  int limit = 0, dev = 0, sms = 0, per_sm = 0;
  int e = optin_limit(&limit);
  if (e) return e;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)lane_lookup_shared_kernel<PACKED>;
  if (smem > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
  }
  e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SHARED_THREADS, smem);
  if (e) return e;
  const bool aligned = ((reinterpret_cast<uintptr_t>(query) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t nvec = aligned ? n / 4 : 0;
  // a block exists only where it has work: it stages the whole table
  const int64_t work = nvec > 0 ? nvec : n;
  int64_t blocks = (work + SHARED_THREADS - 1) / SHARED_THREADS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  lane_lookup_shared_kernel<PACKED><<<(unsigned)blocks, SHARED_THREADS, smem, stream>>>(
      query, out, n, nvec, tlo, thi, tid, rows, slots, nb, shift, salt);
  return (int)cudaGetLastError();
}

}  // namespace

// query/out: n int64 keys -> n int32 ids, on `stream`. The tables are
// int32 [groups * rows, 128] (tid unused when `packed`). variant 0: the
// shared-memory kernel (an error if the table exceeds the opt-in
// shared-memory limit, see lane_lookup_shared_bytes); 1: the original kernel,
// the probes from L2. Returns the cudaError_t of the launch.
extern "C" int lane_lookup(const int64_t* query, int32_t* out, int64_t n,
                           const int32_t* tlo, const int32_t* thi,
                           const int32_t* tid, int rows, int slots, int nb,
                           int shift, unsigned salt, int packed, int variant,
                           cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (variant == 0) {
    return packed ? launch_shared<true>(query, out, n, tlo, thi, tid, rows, slots, nb,
                                        shift, (uint32_t)salt, stream)
                  : launch_shared<false>(query, out, n, tlo, thi, tid, rows, slots, nb,
                                         shift, (uint32_t)salt, stream);
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  lane_lookup_l2_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      query, out, n, tlo, thi, tid, rows, slots, (uint32_t)(nb - 1), shift,
      (uint32_t)salt, packed);
  return (int)cudaGetLastError();
}

// The shared memory the shared-memory kernel needs for a table, and in
// *limit the current device's opt-in limit a block may use. Returns the
// cudaError_t of the query.
extern "C" int lane_lookup_shared_bytes(int rows, int nb, int packed, int64_t* need,
                                        int* limit) {
  *need = (int64_t)shared_bytes(rows, nb, packed);
  return optin_limit(limit);
}
