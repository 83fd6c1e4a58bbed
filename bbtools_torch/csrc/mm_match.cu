// Hamming-ball k-mer matcher: for each int64 canonical key, the id of the
// first-inserted reference key within its length class's hamming distance,
// or 0. Score of query q against column c:
//   s(q, c) = onehot(q) . keymat[:, c]   (int8 x int8, Kp bytes)
// where the query's one-hot holds its k 2-bit fields (4 bytes each), its
// length-class channels and a constant one; c matches iff s >= 0, and the
// answer is min over matching columns of the priority word
// (rank << 16) | id, decoded to id (0 when nothing matches).
//
// Replaces the TPU kernel bbtools_tpu/ops/mm_match.py `_mm_kernel`
// (reached through `_mm_pallas`), which runs the product on the MXU and
// fuses the select and min. Here the product is small integers (one-hot
// bytes times weights of at most 127 in magnitude, |s| < 256), so it is an
// exact int32 dot product on the CUDA cores with dp4a: 4 bytes per
// instruction, Kp / 4 instructions per (query, column).
//
// Design: one thread per query. The thread builds its query's one-hot in
// registers from the int64 key (word f < k is 1 << 8 * field_f; the words
// past the fields carry the class bytes and the constant byte), so the
// one-hot never exists in device memory. The block streams the key matrix
// through shared memory in column tiles of 32 KB (the index keeps it on
// the device column-major, Kp / 4 words per column); all threads of a warp read the
// same column words (a broadcast) and keep a running min of the priority
// word of the columns they match.
//
// What bounds it on Hopper: integer instruction throughput. Per (query,
// column): Kp / 16 16-byte shared loads, Kp / 4 dp4a, a compare and a
// min. The key matrix (at most 256 x 32,768 bytes) is read once per block
// from L2. A tensor core version (int8 mma / wgmma with the threshold and
// min in the epilogue) is later work.
//
// Pad columns carry a constant weight of -1 and no other weight, so their
// score is -1 and they never match; their priority is BIG32 as well.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int32_t BIG32 = 0x7FFFFFFF;
constexpr int TILE_WORDS = 8192;  // 32 KB of key words per tile

// KW = Kp / 4 words per column (32 for Kp = 128, 64 for Kp = 256)
template <int KW>
__global__ void mm_lookup_kernel(const int64_t* __restrict__ keys,
                                 int32_t* __restrict__ out, int64_t n,
                                 const int32_t* __restrict__ key_t,
                                 const int32_t* __restrict__ prio, int Dp,
                                 int k, int mink, int nc) {
  constexpr int TC = TILE_WORDS / KW;  // columns per tile
  constexpr int V4 = KW / 4;           // int4 loads per column
  __shared__ int4 skey[TILE_WORDS / 4];
  __shared__ int32_t sprio[TC];

  const int64_t qi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < n;
  const int64_t q = live ? keys[qi] : 0;

  // the query's one-hot, KW words in registers (fully unrolled so no
  // array is indexed at run time)
  int32_t qw[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    uint32_t word = 0;
    if (w < k) {
      word = 1u << (8 * (int)((q >> (2 * w)) & 3));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = 4 * (w - k) + b;  // byte index past the fields
        uint32_t v = 0;
        if (p < nc) {
          v = nc > 1 ? (uint32_t)((q >> (2 * (mink + p))) == 1) : 1u;
        } else if (p == nc) {
          v = 1u;  // the constant dim that carries the threshold
        }
        word |= v << (8 * b);
      }
    }
    qw[w] = (int32_t)word;
  }

  int32_t best = BIG32;
  for (int c0 = 0; c0 < Dp; c0 += TC) {
    const int ncols = min(TC, Dp - c0);
    __syncthreads();  // the previous tile is no longer read
    const int4* src = reinterpret_cast<const int4*>(key_t + (int64_t)c0 * KW);
    for (int t = threadIdx.x; t < ncols * V4; t += blockDim.x) skey[t] = src[t];
    for (int t = threadIdx.x; t < ncols; t += blockDim.x) sprio[t] = prio[c0 + t];
    __syncthreads();
    if (live) {
      for (int c = 0; c < ncols; ++c) {
        const int4* col = skey + c * V4;
        int s = 0;
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int4 w4 = col[v];
          s = __dp4a(qw[4 * v + 0], w4.x, s);
          s = __dp4a(qw[4 * v + 1], w4.y, s);
          s = __dp4a(qw[4 * v + 2], w4.z, s);
          s = __dp4a(qw[4 * v + 3], w4.w, s);
        }
        if (s >= 0) best = min(best, sprio[c]);
      }
    }
  }
  if (live) out[qi] = best != BIG32 ? (best & 0xFFFF) : 0;
}

}  // namespace

// keys: n int64 canonical keys -> out: n int32 ids, on `stream`. key_t is
// the key matrix column-major: Dp columns of Kp / 4 int32 words; prio is
// int32 [Dp]. Returns the cudaError_t of the launch.
extern "C" int mm_lookup(const int64_t* keys, int32_t* out, int64_t n,
                         const int32_t* key_t, const int32_t* prio, int Dp,
                         int k, int mink, int nc, int Kp,
                         cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || k > 31 || Dp <= 0 || 4 * k + nc + 1 > Kp)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (Kp == 128) {
    mm_lookup_kernel<32><<<(unsigned)blocks, THREADS, 0, stream>>>(
        keys, out, n, key_t, prio, Dp, k, mink, nc);
  } else if (Kp == 256) {
    mm_lookup_kernel<64><<<(unsigned)blocks, THREADS, 0, stream>>>(
        keys, out, n, key_t, prio, Dp, k, mink, nc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
