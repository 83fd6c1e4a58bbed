// Hamming-ball k-mer matcher: for each int64 canonical key, the id of the
// first-inserted reference key within its length class's hamming distance,
// or 0. Score of query q against column c:
//   s(q, c) = onehot(q) . keymat[:, c]   (int8 x int8, Kp bytes)
// where the query's one-hot holds its k 2-bit fields (4 bytes each), its
// length-class channels and a constant one; c matches iff s >= 0, and the
// answer is min over matching columns of the priority word
// (rank << 16) | id, decoded to id (0 when nothing matches). |s| < 256, so
// the int32 accumulators are exact.
//
// Replaces the TPU kernel bbtools_tpu/ops/mm_match.py `_mm_kernel`
// (reached through `_mm_pallas`), which runs the product on the MXU and
// fuses the select and min.
//
// What bounds it on Hopper: int8 tensor-core operations. One batch of the
// matcher configuration sends 4,194,304 + 212,992 keys against Kp = 128,
// Dp = 17,920: 2 x 4.4e6 x 17,920 x 128 = 2.0e13 operations, 10.22 ms at
// 1,979 TOP/s. The design, against each of its costs:
//
// * The product: wgmma.m64n64k32.s32.s8.s8 with A in registers and B in
//   shared memory, issued by warpgroups (4 warps). The legacy
//   mma.sync.m16n8k32 form of the same design reached about half the int8
//   peak on this card (PERF.md); wgmma is the way to the rest.
// * A, the one-hot, is never in memory, not even shared: in the register
//   A fragment each 32-bit register is 4 consecutive k-bytes of one row,
//   word 8 ks + t (+ 4) of that row's one-hot (rows 16 w + g and + 8 of
//   warp w), so each thread computes its own fragment words from its rows'
//   int64 keys once per query tile (word f < k is 1 << 8 * field_f; the
//   words past the fields carry the class bytes and the constant byte). A
//   warpgroup holds MW m64 tiles (128 rows at Kp = 128, 64 at Kp = 256: 32
//   registers of A either way) for its whole sweep over the columns.
// * B, the key matrix, is K-major per column as `device_arrays` stores it
//   ([Dp, Kp / 4] words), which is wgmma's K-major B as it stands. The
//   block stages column tiles of TN = 256 columns into a ring of STAGES =
//   3 shared-memory buffers with cp.async, two tiles ahead of the product.
//   Each 128-byte half of a column is one row of a 128-byte-swizzled
//   K-major tile (16-byte chunk j of column c at chunk j ^ (c & 7), 8-row
//   atoms of 1,024 bytes), the layout wgmma's SWIZZLE_128B descriptor
//   reads without bank conflicts; a k-step of 32 bytes advances the
//   descriptor's start address by 32.
// * The epilogue: almost every (query, column) misses. After the Kp / 32
//   wgmma of a 64-column chunk each thread ANDs its 32 MW accumulators
//   (LOP3, three at a time) and the warp votes on the sign bit: a clear
//   bit means some score is >= 0. Only such chunks run the per-score select
//   and min against the column priorities, which keeps the epilogue near
//   0.5 integer operations per score (~2.4 ms of int32 issue for the
//   batch). A warpgroup cannot scan one accumulator set while its next
//   wgmma fills another (ptxas then serializes the wgmma, C7514), so the
//   overlap comes from the other warpgroups instead: the two halves of the
//   block issue in turns (named barriers 1 and 2), and the tensor cores,
//   which take the groups in order, run one half's product while the other
//   half scans. Each thread keeps a running min per row in registers; the
//   four threads of a row combine by __shfl_xor_sync and one writes the
//   row once. The minimum is taken over every matching column, so the
//   columns may come in any order.
// * L2 traffic: each block of 4 warpgroups (512 rows) streams the whole
//   key matrix (2.3 MB at Dp = 17,920, resident in the 50 MB L2) once: for
//   the batch 8,608 blocks x 2.3 MB = 20 GB from L2, a few ms at L2 rates,
//   hidden behind the product by the cp.async ring (the "half the tile"
//   variant doubles it). A block's prologue (its A build and two tiles in
//   flight) is ~2% of its 70 tiles, so blocks are not made persistent.
//
// Pad columns carry a constant weight of -1 and no other weight, so their
// score is -1 and they never match; their priority is BIG32 as well. A
// ragged last tile (Dp not a multiple of TN) is zero-filled with priority
// BIG32: a zero column scores 0 and "matches" with BIG32, which changes no
// minimum.
//
// `mm_best` is the same kernel with the lookup's min written undecoded: the
// priority word, BIG32 on a miss. A matcher whose columns are cut over
// several devices (parallel/sharded_count.py) takes the min of the slabs'
// words, which a min over decoded ids would get wrong; its cost is the
// lookup's, on a slab's columns.
//
// `mm_lookup_variant` also runs, for measurement only: the kernel with a
// max-only epilogue or an epilogue that reads one column per n8 block (the
// split of product and epilogue; the counterparts of the TPU experiments
// in tools/exp_mm_wall.py), the kernel at half the query tile, and the
// original kernel (one thread per query, dp4a on the CUDA cores).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t BIG32 = 0x7FFFFFFF;
constexpr int TN = 256;     // columns per staged tile
constexpr int STAGES = 3;   // tiles in the shared-memory ring
constexpr int ALIGN = 1024; // the 128-byte swizzle's atom

// EPI_FULL is the lookup; EPI_BEST the same min, written undecoded (the
// priority word, BIG32 on a miss) for a column-sharded matcher to combine.
enum Epi { EPI_FULL = 0, EPI_MAX = 1, EPI_ONECOL = 2, EPI_BEST = 3 };

// Word w of the one-hot of key q (4 bytes, byte b at bits 8b..8b+7).
__device__ __forceinline__ uint32_t onehot_word(int64_t q, int w, int k,
                                                int mink, int nc) {
  if (w < k) return 1u << (8 * (int)((q >> (2 * w)) & 3));
  uint32_t word = 0;
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
  return word;
}

// The A fragment words of rows r0 and r0 + 8 for each k-step ks: words
// 8 ks + t and 8 ks + t + 4 of each row (m16n8k32 and wgmma k32 alike).
template <int KS>
__device__ __forceinline__ void build_a(uint32_t (&a)[KS][4], const int64_t* keys,
                                        int64_t n, int64_t r0, int t, int k,
                                        int mink, int nc) {
  const int64_t q0 = r0 < n ? keys[r0] : 0;
  const int64_t q1 = r0 + 8 < n ? keys[r0 + 8] : 0;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = onehot_word(q0, 8 * ks + t, k, mink, nc);
    a[ks][1] = onehot_word(q1, 8 * ks + t, k, mink, nc);
    a[ks][2] = onehot_word(q0, 8 * ks + t + 4, k, mink, nc);
    a[ks][3] = onehot_word(q1, 8 * ks + t + 4, k, mink, nc);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int KW>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (TN * 4 * KW + TN * 4) + ALIGN;
}

// Stage `tile` (TN columns) of the key matrix into its ring slot: 16-byte
// chunk j of column c at [j / 8][c][(j % 8) ^ (c % 8)] (128-byte rows, one
// per column and half), zero-filled past Dp; its priorities beside, BIG32
// past Dp.
template <int KW, int NTHREADS>
__device__ __forceinline__ void stage_tile(int tile, uint32_t sbase,
                                           int32_t* sprio,
                                           const int32_t* key_t,
                                           const int32_t* prio, int Dp) {
  constexpr int CHUNKS = KW / 4;
  const int stage = tile % STAGES;
  const uint32_t dst0 = sbase + stage * (TN * 4 * KW);
  const int c0 = tile * TN;
  for (int i = threadIdx.x; i < TN * CHUNKS; i += NTHREADS) {
    const int c = i / CHUNKS, j = i % CHUNKS;
    const bool ok = c0 + c < Dp;
    const int32_t* src = key_t + (int64_t)(ok ? c0 + c : 0) * KW + 4 * j;
    cp_async16(dst0 + (j >> 3) * (TN * 128) + c * 128 + (((j & 7) ^ (c & 7)) << 4),
               src, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < TN; i += NTHREADS)
    sprio[stage * TN + i] = c0 + i < Dp ? prio[c0 + i] : BIG32;
}

// The epilogue of one accumulator chunk: R row tiles of NB n8 blocks,
// acc[r][4 j + e] = score of row g + 8 (e / 2) against column
// 8 j + 2 t + e % 2 of the chunk whose priorities start at `sp`.
template <int EPI, int R, int NB>
__device__ __forceinline__ void epilogue(const int32_t (&acc)[R][4 * NB],
                                         int32_t (&best)[R][2],
                                         const int32_t* sp, int t) {
  if (EPI == EPI_FULL || EPI == EPI_BEST) {
    // the sign bit of the AND is clear iff some score is >= 0
    int32_t all = acc[0][0];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i)
        if (r || i) all &= acc[r][i];
    if (__any_sync(0xFFFFFFFFu, all >= 0)) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int32_t p0 = sp[8 * j + 2 * t], p1 = sp[8 * j + 2 * t + 1];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (acc[r][4 * j + e] >= 0)
              best[r][e >> 1] = min(best[r][e >> 1], (e & 1) ? p1 : p0);
      }
    }
  } else if (EPI == EPI_MAX) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i)
        best[r][(i >> 1) & 1] = max(best[r][(i >> 1) & 1], acc[r][i]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j) best[r][0] += acc[r][4 * j];
  }
}

template <int EPI>
__device__ __forceinline__ int32_t best_init() {
  return EPI == EPI_FULL || EPI == EPI_BEST ? BIG32 : EPI == EPI_MAX ? -BIG32 - 1 : 0;
}

// Combine the four threads of rows r0 and r0 + 8; one writes each row.
template <int EPI>
__device__ __forceinline__ void write_rows(const int32_t (&best)[2],
                                           int32_t* out, int64_t n,
                                           int64_t r0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int32_t v = best[h];
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const int32_t o = __shfl_xor_sync(0xFFFFFFFFu, v, x);
      v = EPI == EPI_FULL || EPI == EPI_BEST ? min(v, o)
          : EPI == EPI_MAX ? max(v, o) : v + o;
    }
    const int64_t r = r0 + 8 * h;
    if (t == 0 && r < n)
      out[r] = EPI != EPI_FULL ? v : v != BIG32 ? (v & 0xFFFF) : 0;  // EPI_BEST: v
  }
}

// ---------------------------------------------------------------------------
// The main kernel: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  // start address, LBO 1 (unused by swizzled K-major layouts), SBO 1,024
  // bytes between 8-row groups, layout SWIZZLE_128B
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n64k32(int32_t (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// KW = Kp / 4 words per column (32 for Kp = 128, 64 for Kp = 256); WGS
// warpgroups per block, each owning 64 MW query rows; EPI the epilogue.
template <int KW, int WGS, int EPI>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
    mm_wgmma_kernel(const int64_t* __restrict__ keys,
                    int32_t* __restrict__ out, int64_t n,
                    const int32_t* __restrict__ key_t,
                    const int32_t* __restrict__ prio, int Dp, int k,
                    int mink, int nc) {
  constexpr int KS = KW / 8;  // k-steps of 32 bytes
  constexpr int MW = KW == 32 ? 2 : 1;
  constexpr int NTHREADS = WGS * 128;
  constexpr int STAGE_BYTES = TN * 4 * KW;
  extern __shared__ uint8_t smem[];
  const uint32_t sraw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sbase = (sraw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  int32_t* sprio = reinterpret_cast<int32_t*>(smem + (sbase - sraw) +
                                              STAGES * STAGE_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * (WGS * 64 * MW) +
                       (int64_t)wg * 64 * MW + 16 * w + g;

  uint32_t a[MW][KS][4];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
    build_a<KS>(a[mw], keys, n, row0 + 64 * mw, t, k, mink, nc);
  int32_t best[MW][2];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) best[mw][0] = best[mw][1] = best_init<EPI>();
  int32_t acc[MW][32];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mw][i] = 0;

  const int ntiles = (Dp + TN - 1) / TN;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      stage_tile<KW, NTHREADS>(s, sbase, sprio, key_t, prio, Dp);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    // make this thread's cp.async writes visible to wgmma's (async proxy)
    // reads, then wait for every thread's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile is in; the ring slot of tile - 1 is free
    if (tile + STAGES - 1 < ntiles)
      stage_tile<KW, NTHREADS>(tile + STAGES - 1, sbase, sprio, key_t, prio,
                               Dp);
    cp_async_commit();
    const int stage = tile % STAGES;
    const uint32_t sb = sbase + stage * STAGE_BYTES;
    const int32_t* sp = sprio + stage * TN;
#pragma unroll 1
    for (int c64 = 0; c64 < TN / 64; ++c64) {
      // ping-pong: the second half of the warpgroups issues chunk c64 after
      // the first half has (barrier 1), the first half issues chunk c64 + 1
      // after the second has issued c64 (barrier 2), so the tensor cores
      // run one half's product while the other half scans its scores
      if (wg >= WGS / 2) {
        asm volatile("bar.sync 1, %0;\n" ::"n"(NTHREADS) : "memory");
      } else if (c64 > 0) {
        asm volatile("bar.sync 2, %0;\n" ::"n"(NTHREADS) : "memory");
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int mw = 0; mw < MW; ++mw)
          wgmma_m64n64k32(acc[mw], a[mw][ks],
                          sw128_desc(sb + (ks >> 2) * (TN * 128) +
                                     c64 * 64 * 128 + (ks & 3) * 32),
                          ks > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (wg < WGS / 2) {
        asm volatile("bar.arrive 1, %0;\n" ::"n"(NTHREADS) : "memory");
      } else if (c64 + 1 < TN / 64) {
        asm volatile("bar.arrive 2, %0;\n" ::"n"(NTHREADS) : "memory");
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[mw][i])::"memory");
      epilogue<EPI, MW, 8>(acc, best, sp + c64 * 64, t);
    }
  }
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) write_rows<EPI>(best[mw], out, n, row0 + 64 * mw, t);
}

// ---------------------------------------------------------------------------
// The original kernel, kept for the before/after timing only: one thread per
// query, the one-hot in registers, an int32 dp4a dot product on the CUDA
// cores against column tiles of 32 KB staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int DP4A_THREADS = 256;
constexpr int DP4A_TILE_WORDS = 8192;

template <int KW>
__global__ void mm_dp4a_kernel(const int64_t* __restrict__ keys,
                               int32_t* __restrict__ out, int64_t n,
                               const int32_t* __restrict__ key_t,
                               const int32_t* __restrict__ prio, int Dp,
                               int k, int mink, int nc) {
  constexpr int TC = DP4A_TILE_WORDS / KW;  // columns per tile
  constexpr int V4 = KW / 4;                // int4 loads per column
  __shared__ int4 skey[DP4A_TILE_WORDS / 4];
  __shared__ int32_t sprio[TC];

  const int64_t qi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < n;
  const int64_t q = live ? keys[qi] : 0;
  int32_t qw[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) qw[w] = (int32_t)onehot_word(q, w, k, mink, nc);

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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const int64_t* keys;
  int32_t* out;
  int64_t n;
  const int32_t* key_t;
  const int32_t* prio;
  int Dp, k, mink, nc;
};

using KernelFn = void (*)(const int64_t*, int32_t*, int64_t, const int32_t*,
                          const int32_t*, int, int, int, int);

// Launch `kern` over ceil(n / rows) blocks of `threads` with `smem` bytes
// of dynamic shared memory, raising the block's limit first where needed.
int launch(KernelFn kern, bool& configured, const Args& x, int64_t rows,
           int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int64_t blocks = (x.n + rows - 1) / rows;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(
      x.keys, x.out, x.n, x.key_t, x.prio, x.Dp, x.k, x.mink, x.nc);
  return (int)cudaGetLastError();
}

template <int KW, int WGS, int EPI>
int launch_wgmma(const Args& x, cudaStream_t stream) {
  static bool configured = false;
  return launch(mm_wgmma_kernel<KW, WGS, EPI>, configured, x,
                WGS * 64 * (KW == 32 ? 2 : 1), WGS * 128, smem_bytes<KW>(),
                stream);
}

template <int WGS, int EPI>
int launch_wgmma_kp(const Args& x, int Kp, cudaStream_t stream) {
  if (Kp == 128) return launch_wgmma<32, WGS, EPI>(x, stream);
  return launch_wgmma<64, WGS, EPI>(x, stream);
}

template <int KW>
int launch_dp4a(const Args& x, cudaStream_t stream) {
  static bool configured = false;
  return launch(mm_dp4a_kernel<KW>, configured, x, DP4A_THREADS,
                DP4A_THREADS, 0, stream);
}

// the main kernel's warpgroups per block
constexpr int MAIN_WGS = 4;
// run()'s code of the main kernel with the undecoded epilogue (`mm_best`)
constexpr int BEST = 5;

int run(int variant, const Args& x, int Kp, cudaStream_t stream) {
  if (x.n == 0) return (int)cudaSuccess;
  if (x.k <= 0 || x.k > 31 || x.Dp <= 0 || 4 * x.k + x.nc + 1 > Kp || x.n < 0 ||
      (Kp != 128 && Kp != 256))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return launch_wgmma_kp<MAIN_WGS, EPI_FULL>(x, Kp, stream);
    case 1:
      return launch_wgmma_kp<MAIN_WGS, EPI_MAX>(x, Kp, stream);
    case 2:
      return launch_wgmma_kp<MAIN_WGS, EPI_ONECOL>(x, Kp, stream);
    case 3:
      return launch_wgmma_kp<MAIN_WGS / 2, EPI_FULL>(x, Kp, stream);
    case 4:
      return Kp == 128 ? launch_dp4a<32>(x, stream) : launch_dp4a<64>(x, stream);
    case BEST:
      return launch_wgmma_kp<MAIN_WGS, EPI_BEST>(x, Kp, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// keys: n int64 canonical keys -> out: n int32 ids, on `stream`. key_t is
// the key matrix column-major: Dp columns of Kp / 4 int32 words; prio is
// int32 [Dp]. Returns the cudaError_t of the launch.
extern "C" int mm_lookup(const int64_t* keys, int32_t* out, int64_t n,
                         const int32_t* key_t, const int32_t* prio, int Dp,
                         int k, int mink, int nc, int Kp,
                         cudaStream_t stream) {
  return run(0, Args{keys, out, n, key_t, prio, Dp, k, mink, nc}, Kp, stream);
}

// The same lookup before its decode: out = each key's best priority word
// (rank << 16) | id over the Dp columns given, BIG32 where none matches.
// A min over column slabs of the key matrix is the lookup over all of
// them (a tp-sharded matcher). Same arguments as mm_lookup.
extern "C" int mm_best(const int64_t* keys, int32_t* out, int64_t n,
                       const int32_t* key_t, const int32_t* prio, int Dp,
                       int k, int mink, int nc, int Kp, cudaStream_t stream) {
  return run(BEST, Args{keys, out, n, key_t, prio, Dp, k, mink, nc}, Kp, stream);
}

// The measurement variants, same arguments plus `variant`: 0 the main
// kernel; 1 max-only epilogue (out = the max score of each query); 2 one
// column read per n8 block (out = a sum of scores); 3 the main kernel at
// half the query tile; 4 the original dp4a kernel. All but 1 and 2 compute
// the lookup itself.
extern "C" int mm_lookup_variant(const int64_t* keys, int32_t* out, int64_t n,
                                 const int32_t* key_t, const int32_t* prio,
                                 int Dp, int k, int mink, int nc, int Kp,
                                 int variant, cudaStream_t stream) {
  return run(variant, Args{keys, out, n, key_t, prio, Dp, k, mink, nc}, Kp,
             stream);
}
