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
// A GPU thread can index both reads directly, so none of that is kept:
// one block per pair stages both reads in shared memory (2 * L bytes)
// and each thread walks whole inserts, counting into int32 registers.
// Integer counts are exact in any order.
//
// What bounds it on Hopper: the compare loop, about L^2 shared-memory
// reads per pair (one byte of each read per step). Neighbouring threads
// take neighbouring inserts, whose windows start one byte apart, so a
// warp's reads fall into a few shared-memory words (broadcast, no bank
// conflicts). Each pair's [D] outputs are written once, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void overlap_scan_kernel(const uint8_t* __restrict__ a,
                                    const uint8_t* __restrict__ b_rc,
                                    const int32_t* __restrict__ alens,
                                    const int32_t* __restrict__ blens,
                                    int32_t* __restrict__ good,
                                    int32_t* __restrict__ bad,
                                    int32_t* __restrict__ olen, int L,
                                    int min0, int D) {
  extern __shared__ uint8_t smem[];
  uint8_t* sa = smem;
  uint8_t* sb = smem + L;
  const int64_t p = blockIdx.x;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    sa[t] = a[p * L + t];
    sb[t] = b_rc[p * L + t];
  }
  __syncthreads();
  // lengths beyond the row would read past it; the callers never pass them
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

}  // namespace

// a, b_rc: uint8 [B, L] codes (b reverse-complemented, left-aligned);
// alens, blens: int32 [B]; good, bad, olen: int32 [B, D]; on `stream`.
// Returns the cudaError_t of the launch.
extern "C" int overlap_scan(const uint8_t* a, const uint8_t* b_rc,
                            const int32_t* alens, const int32_t* blens,
                            int32_t* good, int32_t* bad, int32_t* olen,
                            int64_t B, int L, int min0, int D,
                            cudaStream_t stream) {
  if (B <= 0 || D <= 0) return (int)cudaSuccess;
  if (L < 0 || B > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)L;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  overlap_scan_kernel<<<(unsigned)B, THREADS, smem, stream>>>(
      a, b_rc, alens, blens, good, bad, olen, L, min0, D);
  return (int)cudaGetLastError();
}
