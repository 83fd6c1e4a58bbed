// The unpruned MultiStateAligner11ts fill with traceback planes
// (fillUnlimited, MultiStateAligner11ts.java:643-860): a three-state
// affine DP (match/sub, deletion, insertion) with streak-dependent costs
// over read rows r = 0..R and reference columns c, swept along the
// anti-diagonals d = r + c. MS reads (r-1, c-1) on diagonal d-2, DEL
// reads (r, c-1) and INS reads (r-1, c) on diagonal d-1.
//
// Replaces the TPU kernel bbtools_tpu/ops/msa_pallas.py `_kernel`
// (reached through `msa_fill_pallas(..., traceback=True)`), bit for bit:
// every sentinel (row 0 reads 99, rows 0-1 of the previous read base read
// 98, reference columns outside the window read 97, N is any code >= 4),
// the column-0 penalties, subfloor = -2 * maxgain, the DEL/INS barriers,
// the pick order MS >= DEL >= INS, the prevState byte taken before the
// barriers and the boundary overwrite, the MAX_TIME clamp, the final-row
// capture at r == len over increasing d with strict >, and the
// state-major combine with strict >.
//
// The TPU kernel's transposed [W, T] planes, step-parity banks, reference
// shift register and pre-gathered entering codes are Mosaic workarounds
// and are not kept. Here one thread block runs one task. Thread t owns
// rows t + k*T (k < K), so one diagonal is one pass over the block. Each
// row keeps its diagonal d-1 state and the d-2 state of row r-1 in
// registers; row r-1's d-1 state comes from the neighbouring lane with
// __shfl_up_sync, and across warps (and from thread T-1 to thread 0 for
// the next k) through a small shared exchange, double-buffered by the
// diagonal's parity so one __syncthreads per diagonal suffices. The read
// and the reference window sit in shared memory; row r reads reference
// column c - 1 = d - r - 1 directly. Each diagonal's plane row is R+1
// contiguous bytes, written by neighbouring threads. The thread that
// owns row r == len keeps the final-row maxima in registers.
//
// What bounds it on Hopper: integer issue. Each of the S * nd * (R+1)
// cells costs some eighty int32 instructions (three candidate scores per
// state, selects, barriers, clamps) and one byte of plane; the plane is
// written once (S * nd * (R+1) bytes), far below what the instruction
// count costs at the card's int32 rate. The per-diagonal barrier and the
// shuffles are latency the other resident blocks hide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_BIG = -(1 << 30);
constexpr int REF_PAD = 97;
constexpr int POINTS_NOCALL = 0;
constexpr int POINTS_MATCH = 70;
constexpr int POINTS_MATCH2 = 100;
constexpr int POINTS_SUB = -127;
constexpr int POINTS_SUBR = -147;
constexpr int POINTS_SUB2 = -51;
constexpr int POINTS_SUB3 = -25;
constexpr int POINTS_INS = -395;
constexpr int POINTS_INS2 = -39;
constexpr int POINTS_INS3 = -23;
constexpr int POINTS_INS4 = -8;
constexpr int POINTS_DEL = -472;
constexpr int POINTS_DEL2 = -33;
constexpr int POINTS_DEL3 = -9;
constexpr int POINTS_DEL4 = -1;
constexpr int POINTS_DEL5 = -1;
constexpr int POINTS_DEL_REF_N = -10;
constexpr int MASK5 = 3;
constexpr int BARRIER_I1 = 2;
constexpr int BARRIER_D1 = 3;
constexpr int LIMIT_FOR_COST_3 = 5;
constexpr int LIMIT_FOR_COST_4 = 20;
constexpr int LIMIT_FOR_COST_5 = 80;
constexpr int MAX_TIME = 2047;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int XW = 5;  // words of one row's d-1 state in the exchange

__device__ __forceinline__ int sub_cost(int streak) {
  const int i = streak + 1;
  return i > LIMIT_FOR_COST_3 ? POINTS_SUB3 : (i > 1 ? POINTS_SUB2 : POINTS_SUB);
}

__device__ __forceinline__ int ins_cost(int streak) {
  const int i = streak + 1;
  return i > LIMIT_FOR_COST_4   ? POINTS_INS4
         : i > LIMIT_FOR_COST_3 ? POINTS_INS3
         : i > 1                ? POINTS_INS2
                                : POINTS_INS;
}

__device__ __forceinline__ int del_cost(int streak) {
  return streak == 0                  ? POINTS_DEL
         : streak < LIMIT_FOR_COST_3  ? POINTS_DEL2
         : streak < LIMIT_FOR_COST_4  ? POINTS_DEL3
         : streak < LIMIT_FOR_COST_5  ? POINTS_DEL4
         : (streak & MASK5) == 0      ? POINTS_DEL5
                                      : 0;
}

__device__ __forceinline__ int clamp_time(int t) {
  return t > MAX_TIME ? MAX_TIME - MASK5 : t;
}

template <int K>
__global__ void __launch_bounds__(1024)
msa_fill_kernel(const uint8_t* __restrict__ reads,
                const int32_t* __restrict__ lens,
                const uint8_t* __restrict__ refs,
                const int32_t* __restrict__ col0,
                int32_t* __restrict__ out_s, int32_t* __restrict__ out_c,
                int32_t* __restrict__ out_st, uint8_t* __restrict__ planes,
                int S, int R, int Cc) {
  extern __shared__ int4 smem4[];
  const int T = blockDim.x;
  const int nwarps = T >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* xchg = reinterpret_cast<int*>(smem4);  // [2][nwarps][K][XW]
  uint8_t* sread = reinterpret_cast<uint8_t*>(xchg + 2 * nwarps * K * XW);
  uint8_t* sref = sread + R;
  const int64_t s = blockIdx.x;
  for (int i = tid; i < R; i += T) sread[i] = reads[s * R + i];
  for (int i = tid; i < Cc; i += T) sref[i] = refs[s * Cc + i];
  const int len = lens[s];
  __syncthreads();

  const int W = R + 1;
  const int subfloor = -2 * ((len - 1) * POINTS_MATCH2 + POINTS_MATCH);
  int call1[K], call0[K], c0v[K];
  // diagonal d-1 of row r
  int ms_s[K], ms_t[K], del_s[K], del_t[K], ins_s[K], ins_t[K];
  // diagonal d-2 of row r-1
  int q_ms_s[K], q_ms_t[K], q_del_s[K], q_ins_s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = tid + k * T;
    const bool on = r <= R;
    call1[k] = r == 0 ? 99 : (on ? sread[r - 1] : 0);
    call0[k] = r < 2 ? 98 : (on ? sread[r - 2] : 0);
    c0v[k] = on ? col0[r] : 0;
    // diagonal 1: c = 1 - r
    const int s1 = r == 1 ? c0v[k] : (r == 0 ? 0 : NEG_BIG);
    ms_s[k] = del_s[k] = ins_s[k] = s1;
    ms_t[k] = del_t[k] = ins_t[k] = 0;
    // diagonal 0 at row r-1 (c = 1 - r); row 0 has no row above: 0
    const int s0 = r == 0 ? 0 : (r == 1 ? col0[0] : NEG_BIG);
    q_ms_s[k] = q_del_s[k] = q_ins_s[k] = s0;
    q_ms_t[k] = 0;
  }
  int best_s0 = NEG_BIG, best_s1 = NEG_BIG, best_s2 = NEG_BIG;
  int best_c0 = -1, best_c1 = -1, best_c2 = -1;

  for (int d = 2; d <= R + Cc; ++d) {
    int* xb = xchg + (d & 1) * nwarps * K * XW;
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int* p = xb + (warp * K + k) * XW;
        p[0] = ms_s[k];
        p[1] = ms_t[k];
        p[2] = del_s[k];
        p[3] = ins_s[k];
        p[4] = ins_t[k];
      }
    }
    __syncthreads();
    uint8_t* prow = planes + ((int64_t)(d - 2) * S + s) * W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // row r-1 on diagonal d-1
      int p_ms_s = __shfl_up_sync(FULL, ms_s[k], 1);
      int p_ms_t = __shfl_up_sync(FULL, ms_t[k], 1);
      int p_del_s = __shfl_up_sync(FULL, del_s[k], 1);
      int p_ins_s = __shfl_up_sync(FULL, ins_s[k], 1);
      int p_ins_t = __shfl_up_sync(FULL, ins_t[k], 1);
      if (lane == 0) {
        const int* src = warp > 0 ? xb + ((warp - 1) * K + k) * XW
                         : k > 0  ? xb + ((nwarps - 1) * K + k - 1) * XW
                                  : nullptr;
        p_ms_s = src ? src[0] : 0;
        p_ms_t = src ? src[1] : 0;
        p_del_s = src ? src[2] : 0;
        p_ins_s = src ? src[3] : 0;
        p_ins_t = src ? src[4] : 0;
      }
      const int r = tid + k * T;
      if (r <= R) {
        const int c = d - r;
        const int ref1 = (c >= 1 && c <= Cc) ? sref[c - 1] : REF_PAD;
        const int ref0 = (c >= 2 && c <= Cc + 1) ? sref[c - 2] : REF_PAD;
        const bool match = call1[k] == ref1 && ref1 < 4;
        const bool prev_match = call0[k] == ref0 && ref0 < 4;
        // MS from (r-1, c-1)
        const int s_diag = q_ms_s[k];
        const int streak = q_ms_t[k];
        int m_sMS;
        if (match) {
          m_sMS = s_diag + (prev_match ? POINTS_MATCH2 : POINTS_MATCH);
        } else if (ref1 < 4 && call1[k] < 4) {
          m_sMS = s_diag + (prev_match ? (streak <= 1 ? POINTS_SUBR : POINTS_SUB)
                                       : sub_cost(streak));
        } else {
          m_sMS = s_diag + POINTS_NOCALL;
        }
        const int m_sD = q_del_s[k] + (match ? POINTS_MATCH : POINTS_SUB);
        const int m_sI = q_ins_s[k] + (match ? POINTS_MATCH : POINTS_SUB);
        const bool pick_ms = m_sMS >= m_sD && m_sMS >= m_sI;
        const bool pick_d = !pick_ms && m_sD >= m_sI;
        int n_ms_s = pick_ms ? m_sMS : (pick_d ? m_sD : m_sI);
        int n_ms_t = pick_ms ? (match ? (prev_match ? streak + 1 : 1)
                                      : (prev_match ? 1 : streak + 1))
                             : 1;
        // DEL from (r, c-1)
        const int rpen = ref1 >= 4 ? POINTS_DEL_REF_N : 0;
        const int d_sMS = ms_s[k] + POINTS_DEL + rpen;
        const int d_sD = del_s[k] + del_cost(del_t[k]) + rpen;
        const bool d_pick = d_sMS >= d_sD;
        int n_del_s = d_pick ? d_sMS : d_sD;
        int n_del_t = d_pick ? 1 : del_t[k] + 1;
        // INS from (r-1, c)
        const int i_sMS = p_ms_s + POINTS_INS;
        const int i_sI = p_ins_s + ins_cost(p_ins_t);
        const bool i_pick = i_sMS >= i_sI;
        int n_ins_s = i_pick ? i_sMS : i_sI;
        int n_ins_t = i_pick ? 1 : p_ins_t + 1;
        // prevState byte, before the barriers and the boundary
        prow[r] = (uint8_t)((pick_ms ? 0 : (pick_d ? 1 : 2)) | (d_pick ? 0 : 4) |
                            (i_pick ? 0 : 32));
        if (r < BARRIER_D1 || r > len - BARRIER_D1) {
          n_del_s = subfloor;
          n_del_t = 0;
        }
        if ((r < BARRIER_I1 && c > 1) || (r > len - BARRIER_I1 && c < Cc - 1)) {
          n_ins_s = subfloor;
          n_ins_t = 0;
        }
        n_ms_t = clamp_time(n_ms_t);
        n_del_t = clamp_time(n_del_t);
        n_ins_t = clamp_time(n_ins_t);
        if (r < 1 || c < 1) {
          const int b = c == 0 ? c0v[k] : (r == 0 ? 0 : NEG_BIG);
          n_ms_s = n_del_s = n_ins_s = b;
          n_ms_t = n_del_t = n_ins_t = 0;
        }
        if (r == len && c >= 1 && c <= Cc) {
          if (n_ms_s > best_s0) { best_s0 = n_ms_s; best_c0 = c; }
          if (n_del_s > best_s1) { best_s1 = n_del_s; best_c1 = c; }
          if (n_ins_s > best_s2) { best_s2 = n_ins_s; best_c2 = c; }
        }
        ms_s[k] = n_ms_s;
        ms_t[k] = n_ms_t;
        del_s[k] = n_del_s;
        del_t[k] = n_del_t;
        ins_s[k] = n_ins_s;
        ins_t[k] = n_ins_t;
      }
      q_ms_s[k] = p_ms_s;
      q_ms_t[k] = p_ms_t;
      q_del_s[k] = p_del_s;
      q_ins_s[k] = p_ins_s;
    }
  }
  // the owner of row len combines the states, strict > in state order;
  // a length outside 0..R owns no row and reports no alignment
  const bool owner = (len >= 0 && len <= R) ? tid == len % T : tid == 0;
  if (owner) {
    int bs = best_s0, bc = best_c0, bst = best_c0 >= 0 ? 0 : -1;
    if (best_s1 > bs) { bs = best_s1; bc = best_c1; bst = 1; }
    if (best_s2 > bs) { bs = best_s2; bc = best_c2; bst = 2; }
    out_s[s] = bs;
    out_c[s] = bc;
    out_st[s] = bst;
  }
}

template <int K>
int launch(const uint8_t* reads, const int32_t* lens, const uint8_t* refs,
           const int32_t* col0, int32_t* out_s, int32_t* out_c, int32_t* out_st,
           uint8_t* planes, int S, int R, int Cc, int T, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        msa_fill_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  msa_fill_kernel<K><<<(unsigned)S, T, smem, stream>>>(
      reads, lens, refs, col0, out_s, out_c, out_st, planes, S, R, Cc);
  return (int)cudaGetLastError();
}

}  // namespace

// reads: uint8 [S, R] codes (4 past each length); lens: int32 [S]; refs:
// uint8 [S, Cc]; col0: int32 [R+1] column-0 penalties; out_s, out_c,
// out_st: int32 [S]; planes: uint8 [R+Cc-1, S, R+1]; K: rows per thread
// (a power of two, at most 64, with ceil((R+1)/K) <= 1024). On `stream`.
// Returns the cudaError_t of the launch.
extern "C" int msa_fill(const uint8_t* reads, const int32_t* lens,
                        const uint8_t* refs, const int32_t* col0, int32_t* out_s,
                        int32_t* out_c, int32_t* out_st, uint8_t* planes,
                        int64_t S, int R, int Cc, int K, cudaStream_t stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (R < 1 || Cc < 1 || S > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int W = R + 1;
  const int T = ((W + K - 1) / K + 31) / 32 * 32;
  if (T > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (T / 32) * K * XW * sizeof(int) + R + Cc;
  const int s = (int)S;
#define MSA_FILL_CASE(k)                                                      \
  case k:                                                                     \
    return launch<k>(reads, lens, refs, col0, out_s, out_c, out_st, planes, s, \
                     R, Cc, T, smem, stream);
  switch (K) {
    MSA_FILL_CASE(1)
    MSA_FILL_CASE(2)
    MSA_FILL_CASE(4)
    MSA_FILL_CASE(8)
    MSA_FILL_CASE(16)
    MSA_FILL_CASE(32)
    MSA_FILL_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSA_FILL_CASE
}
