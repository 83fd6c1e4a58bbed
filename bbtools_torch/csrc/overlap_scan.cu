// BBMerge insert scan: for each read pair and each candidate insert
// ins = min0 + d (d < D), count over the overlap window
//   max(ins - blen, 0) <= i < min(alen, ins),  j = i + blen - ins
// good (a[i] == rc_b[j] and a[i] < 4), bad (a[i] != rc_b[j]) and the
// window length, comparing read a with the reverse complement of read b
// (jgi/BBMergeOverlapper.java:428-446).
//
// Replaces the TPU kernel bbtools_tpu/ops/overlap_pallas.py `_kernel`
// (reached through `overlap_counts_pallas`). The TPU version transposes
// the reads to [position, read] planes, right-justifies and pads rc(b),
// and walks inserts in 8-aligned blocks: all Mosaic layout constraints.
// None of that is kept.
//
// What bounds it on Hopper: a byte-by-byte walk issues several
// instructions per overlapped position (about L^2 a pair), so it is
// bound by instruction issue, far above the bytes it moves (the three
// [B, D] int32 output planes, ~12 bytes an insert). Bit slicing compares
// 32 positions at once:
//   * One warp per pair. The warp loads each read 32 positions at a time
//     and turns them into bit planes with __ballot_sync: word w of plane k
//     holds bit k of the codes at positions 32w..32w+31. Beside them goes
//     a length plane, set at the positions below the read's length. The
//     planes go to shared memory four to a 16-byte word: planes 0-2 and
//     the length plane, then planes 3-6, then plane 7. rc(b)'s words get
//     a zero word on each side.
//   * Each lane takes inserts lane, lane + 32, ...; for each 32-position
//     word of a that meets the insert's window it funnel-shifts b's words
//     to the insert's bit offset (__funnelshift_r) and ORs the XORs of the
//     code planes into a mismatch mask. a's length plane ANDed with b's
//     shifted one is the window's mask (i < alen, 0 <= j < blen), so the
//     window needs no arithmetic. __popc counts: bad the mismatches in
//     the window, good the matches where a's code is below 4 (planes 2
//     and up all zero). Integer counts are exact in any order.
//   * Exact on every uint8 code: a pair whose codes are all below 8 (the
//     main paths send 0-4) stages and compares planes 0-2 only, one
//     16-byte word of a and two of b a word; the warp stages planes 3-7
//     too, and compares all 8, for any other pair, in the same kernel.
//   * Each lane writes its insert's three counts, so a warp writes 32
//     consecutive int32 of each [D] row: coalesced.
//
// Kept as the measurement variant "byte": the first port's kernel (one
// block of 128 threads per pair, each thread walking whole inserts a byte
// at a time).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
// pairs (warps) per block of the bit-sliced kernel
constexpr int WARPS = 8;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// 16-byte words of shared memory one warp uses at nw words of 32
// positions: three groups of planes, each nw words of a and nw + 2 of b
__host__ __device__ constexpr int warp_words(int nw) { return 3 * (2 * nw + 2); }

// the low k bits set (k clamped to 0..32)
__device__ __forceinline__ unsigned low_bits(int k) {
  return k >= 32 ? FULL : k <= 0 ? 0u : FULL >> (32 - k);
}

__device__ __forceinline__ uint4 shift4(uint4 lo, uint4 hi, int r) {
  return make_uint4(__funnelshift_r(lo.x, hi.x, r), __funnelshift_r(lo.y, hi.y, r),
                    __funnelshift_r(lo.z, hi.z, r), __funnelshift_r(lo.w, hi.w, r));
}

// One lane's inserts d = lane, lane + 32, ... of one pair. Group g of a's
// word w is A[g * gs + w], of b's word u - 1 B[g * gs + u] (gs = 2 nw + 2,
// B = A + nw): group 0 holds planes 0-2 and the length plane, group 1
// planes 3-6, group 2 plane 7.
template <bool WIDE>
__device__ __forceinline__ void scan_inserts(const uint4* A, const uint4* B, int gs,
                                             int alen, int blen, int min0, int D,
                                             int64_t row, int32_t* __restrict__ good,
                                             int32_t* __restrict__ bad,
                                             int32_t* __restrict__ olen) {
  for (int d = threadIdx.x & 31; d < D; d += 32) {
    const int ins = min0 + d;
    const int lo = max(ins - blen, 0);
    const int hi = min(alen, ins);
    // bit s of b's padded planes is position s - 32; a's bit 32w + t
    // faces b's position 32w + t + blen - ins
    const int off = blen - ins + 32;
    const int w_end = lo < hi ? ((hi - 1) >> 5) + 1 : 0;
    int g = 0, bd = 0;
#pragma unroll 1
    for (int w = lo >> 5; w < w_end; ++w) {
      const int s = 32 * w + off;  // >= 1 for every word that meets the window
      const int q = s >> 5, r = s & 31;
      const uint4 a0 = A[w];
      const uint4 b0 = shift4(B[q], B[q + 1], r);
      unsigned x = (a0.x ^ b0.x) | (a0.y ^ b0.y) | (a0.z ^ b0.z);
      unsigned high = a0.z;  // a's planes 2 and up: a code of 4 or more
      if (WIDE) {
        const uint4 a1 = A[gs + w], b1 = shift4(B[gs + q], B[gs + q + 1], r);
        const unsigned a2 = A[2 * gs + w].x;
        const unsigned b2 = __funnelshift_r(B[2 * gs + q].x, B[2 * gs + q + 1].x, r);
        x |= (a1.x ^ b1.x) | (a1.y ^ b1.y) | (a1.z ^ b1.z) | (a1.w ^ b1.w) | (a2 ^ b2);
        high |= a1.x | a1.y | a1.z | a1.w | a2;
      }
      const unsigned m = a0.w & b0.w;  // the window: i < alen, 0 <= j < blen
      bd += __popc(x & m);
      g += __popc(~(x | high) & m);
    }
    const int64_t o = row + d;
    good[o] = g;
    bad[o] = bd;
    olen[o] = max(hi - lo, 0);
  }
}

// Stage both reads of pair p into the warp's shared memory: group 0
// (planes 0-2 and the length planes) or, with `wide`, groups 1 and 2
// (planes 3-7). Returns the OR of the codes this lane loaded.
__device__ __forceinline__ unsigned stage(const uint8_t* __restrict__ a,
                                          const uint8_t* __restrict__ b_rc, int64_t p, int L,
                                          int nw, int alen, int blen, uint4* A, uint4* B,
                                          int gs, bool wide) {
  const int lane = threadIdx.x & 31;
  unsigned any = 0;
  for (int c = 0; c < nw; ++c) {
    const int pos = 32 * c + lane;
    const unsigned xa = pos < L ? a[p * L + pos] : 0u;
    const unsigned xb = pos < L ? b_rc[p * L + pos] : 0u;
    any |= xa | xb;
    if (!wide) {
      const unsigned a0 = __ballot_sync(FULL, xa & 1), a1 = __ballot_sync(FULL, xa & 2),
                     a2 = __ballot_sync(FULL, xa & 4);
      const unsigned b0 = __ballot_sync(FULL, xb & 1), b1 = __ballot_sync(FULL, xb & 2),
                     b2 = __ballot_sync(FULL, xb & 4);
      if (lane == 0) {
        A[c] = make_uint4(a0, a1, a2, low_bits(alen - 32 * c));
        B[c + 1] = make_uint4(b0, b1, b2, low_bits(blen - 32 * c));
      }
    } else {
      unsigned pa[5], pb[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        pa[k] = __ballot_sync(FULL, (xa >> (3 + k)) & 1);
        pb[k] = __ballot_sync(FULL, (xb >> (3 + k)) & 1);
      }
      if (lane == 0) {
        A[gs + c] = make_uint4(pa[0], pa[1], pa[2], pa[3]);
        A[2 * gs + c] = make_uint4(pa[4], 0, 0, 0);
        B[gs + c + 1] = make_uint4(pb[0], pb[1], pb[2], pb[3]);
        B[2 * gs + c + 1] = make_uint4(pb[4], 0, 0, 0);
      }
    }
  }
  return any;
}

__global__ void __launch_bounds__(32 * WARPS)
overlap_bits_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b_rc,
                    const int32_t* __restrict__ alens, const int32_t* __restrict__ blens,
                    int32_t* __restrict__ good, int32_t* __restrict__ bad,
                    int32_t* __restrict__ olen, int64_t B, int L, int min0, int D) {
  extern __shared__ uint4 smem[];
  const int nw = (L + 31) >> 5;
  const int gs = 2 * nw + 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= B) return;  // whole warps; the kernel has no block barrier
  uint4* Aw = smem + (size_t)warp * warp_words(nw);
  uint4* Bw = Aw + nw;
  // lengths beyond the row would read past it; the callers never pass them
  const int alen = min(max(alens[p], 0), L);
  const int blen = min(max(blens[p], 0), L);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (lane < 6) Bw[(lane >> 1) * gs + (lane & 1) * (nw + 1)] = zero;  // b's pad words
  const unsigned any = stage(a, b_rc, p, L, nw, alen, blen, Aw, Bw, gs, false);
  const bool wide = __any_sync(FULL, any >= 8);  // a code of 8 or more
  if (wide) stage(a, b_rc, p, L, nw, alen, blen, Aw, Bw, gs, true);
  __syncwarp();
  if (wide)
    scan_inserts<true>(Aw, Bw, gs, alen, blen, min0, D, p * D, good, bad, olen);
  else
    scan_inserts<false>(Aw, Bw, gs, alen, blen, min0, D, p * D, good, bad, olen);
}

// ---- the variant "byte": the first port's kernel ----

constexpr int BYTE_THREADS = 128;

__global__ void overlap_byte_kernel(const uint8_t* __restrict__ a,
                                    const uint8_t* __restrict__ b_rc,
                                    const int32_t* __restrict__ alens,
                                    const int32_t* __restrict__ blens,
                                    int32_t* __restrict__ good,
                                    int32_t* __restrict__ bad,
                                    int32_t* __restrict__ olen, int L,
                                    int min0, int D) {
  extern __shared__ uint8_t sbytes[];
  uint8_t* sa = sbytes;
  uint8_t* sb = sbytes + L;
  const int64_t p = blockIdx.x;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    sa[t] = a[p * L + t];
    sb[t] = b_rc[p * L + t];
  }
  __syncthreads();
  const int alen = min(max(alens[p], 0), L);
  const int blen = min(max(blens[p], 0), L);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int ins = min0 + d;
    const int lo = max(ins - blen, 0);
    const int hi = min(alen, ins);
    const int off = blen - ins;
    int g = 0, bd = 0;
    for (int i = lo; i < hi; ++i) {
      const uint8_t ca = sa[i];
      const uint8_t cb = sb[i + off];
      if (ca == cb) {
        g += ca < 4;
      } else {
        ++bd;
      }
    }
    const int64_t o = p * D + d;
    good[o] = g;
    bad[o] = bd;
    olen[o] = max(hi - lo, 0);
  }
}

int run(int variant, const uint8_t* a, const uint8_t* b_rc, const int32_t* alens,
        const int32_t* blens, int32_t* good, int32_t* bad, int32_t* olen, int64_t B,
        int L, int min0, int D, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return (int)cudaSuccess;
  if (L < 0 || B > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    const size_t smem = 2 * (size_t)L;
    if (smem > DEFAULT_SMEM) return (int)cudaErrorInvalidValue;
    overlap_byte_kernel<<<(unsigned)B, BYTE_THREADS, smem, stream>>>(
        a, b_rc, alens, blens, good, bad, olen, L, min0, D);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  // fewer pairs a block for long reads; past 48 KB a warp opts in to more
  const size_t per_warp = 16 * (size_t)warp_words((L + 31) >> 5);
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > DEFAULT_SMEM) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > DEFAULT_SMEM) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(overlap_bits_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (B + warps - 1) / warps;
  overlap_bits_kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      a, b_rc, alens, blens, good, bad, olen, B, L, min0, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b_rc: uint8 [B, L] codes (b reverse-complemented, left-aligned);
// alens, blens: int32 [B]; good, bad, olen: int32 [B, D]; on `stream`.
// Returns the cudaError_t of the launch.
extern "C" int overlap_scan(const uint8_t* a, const uint8_t* b_rc,
                            const int32_t* alens, const int32_t* blens,
                            int32_t* good, int32_t* bad, int32_t* olen,
                            int64_t B, int L, int min0, int D,
                            cudaStream_t stream) {
  return run(0, a, b_rc, alens, blens, good, bad, olen, B, L, min0, D, stream);
}

// The same, plus `variant`: 0 the kernel above, 1 the variant "byte".
extern "C" int overlap_scan_variant(const uint8_t* a, const uint8_t* b_rc,
                                    const int32_t* alens, const int32_t* blens,
                                    int32_t* good, int32_t* bad, int32_t* olen,
                                    int64_t B, int L, int min0, int D, int variant,
                                    cudaStream_t stream) {
  return run(variant, a, b_rc, alens, blens, good, bad, olen, B, L, min0, D, stream);
}
