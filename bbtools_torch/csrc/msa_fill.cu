// The unpruned MultiStateAligner11ts fill with traceback planes
// (fillUnlimited, MultiStateAligner11ts.java:643-860): a three-state
// affine DP (match/sub, deletion, insertion) with streak-dependent costs
// over read rows r = 0..R and reference columns c, swept along the
// anti-diagonals d = r + c. MS reads (r-1, c-1) on diagonal d-2, DEL
// reads (r, c-1) and INS reads (r-1, c) on diagonal d-1.
//
// Replaces the TPU kernel bbtools_tpu/ops/msa_pallas.py `_kernel`
// (reached through `msa_fill_pallas(..., traceback=True)`), bit for bit
// on every live cell: every sentinel (row 0 reads 99, rows 0-1 of the
// previous read base read 98, reference columns outside the window read
// 97, N is any code >= 4), the column-0 penalties, subfloor = -2 *
// maxgain, the DEL/INS barriers, the pick order MS >= DEL >= INS, the
// prevState byte taken before the barriers and the boundary overwrite,
// the MAX_TIME clamp, the final-row capture at r == len over increasing
// d with strict >, and the state-major combine with strict >.
//
// Live cells. A task's cells with 0 <= r <= len and 0 <= c <= Cc are
// live; the rest are dead. Every dependency runs from r-1 to r and from
// c-1 to c, so a dead cell with r > len or c > Cc feeds only dead cells,
// and a cell with c < 0 holds the boundary value (NEG_BIG, or 0 in row
// 0) whatever feeds it. The walk (ops/msa.py) starts at (len, max_col)
// and moves up and left, so it reads live cells only. The wrapper trims
// R to the longest read of the call (ops/msa_fill.py), and the main
// kernel computes no slice and writes no plane byte that holds only dead
// cells: plane bytes of dead cells are unspecified.
//
// The main kernel, `msa_fill_warp_kernel`: one warp per task, WARPS
// tasks per block, no block barrier. Lane l owns rows l + 32k for k < K
// (K = ceil((len+1)/32) for the task, at most the template's K). Each
// row keeps its diagonal d-1 state (6 words) and the d-2 state of row
// r-1 (4 words) in registers, with its two read codes and the reference
// code it read on d-1. On diagonal d the warp visits its slices from the
// last to the first: row r-1's d-1 state comes from lane l-1 by a
// shuffle, and lane 0 takes lane 31 of slice k-1, which has not moved to
// d yet. A slice holding no live cell on d is skipped (a branch uniform
// over the warp): slice k is live on diagonals 32k .. min(32k+31, len) +
// Cc, one interval, so the registers of a skipped slice still hold the
// values that it needs when its interval opens. The reference window,
// padded with the sentinel on both sides, is one shared region per warp;
// the read codes are loaded once into registers. A diagonal's plane row
// is R+1 contiguous bytes, so a slice's 32 live bytes are one coalesced
// store.
//
// What bounds it on Hopper: the SMs' instruction rate. Each computed cell costs some
// eighty instructions (three candidate scores per state, selects,
// barriers, clamps, five shuffles) and one plane byte; chip_smoke.py
// counts the instructions of the diagonal loop in the built code. With
// reads of 151 bases in a 280-column window, the slices cover ~50,000
// cells of a task against 42,500 live ones; the block kernel below
// computed 137,500 at R = 256.
//
// A task with more than 32 * MAX_WARP_SLICES rows does not fit the warp
// kernel's registers; it goes to `msa_fill_block_kernel`, the first design:
// one block per task, thread t owns rows t + k*T, one __syncthreads per
// diagonal. The wrapper picks those tasks by length. A call with too few
// tasks to give each scheduler of the card a few warps leaves the warp
// kernel bound by one warp's chain of dependent instructions; there the
// wrapper runs the block kernel over every task (variant 1), which
// spreads a task's rows over several warps. Both choices are by shape,
// and the wrapper counts them.

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
constexpr int XW = 5;  // words of one row's d-1 state in the block exchange
constexpr int WARPS = 4;  // tasks per block of the warp kernel
constexpr int MAX_WARP_SLICES = 8;  // rows a warp takes: 32 * 8
constexpr int REF_LPAD = 32;  // sentinel bytes before a warp's window

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

// The three states of one cell: scores and streak times.
struct State {
  int ms_s, ms_t, del_s, del_t, ins_s, ins_t;
};

// One cell (r, c). `st` holds (r, c-1), DEL's source, and receives (r, c);
// q_* are (r-1, c-1), MS's source; p_* are (r-1, c), INS's source. c0 is
// col0[r], read only when c == 0. Returns the prevState byte, taken
// before the barriers and the boundary.
__device__ __forceinline__ uint32_t fill_cell(
    State& st, int r, int c, int len, int Cc, int subfloor, int c0, int call1,
    int call0, int ref1, int ref0, int q_ms_s, int q_ms_t, int q_del_s,
    int q_ins_s, int p_ms_s, int p_ins_s, int p_ins_t) {
  const bool match = call1 == ref1 && ref1 < 4;
  const bool prev_match = call0 == ref0 && ref0 < 4;
  // MS from (r-1, c-1)
  const int streak = q_ms_t;
  int m_sMS;
  if (match) {
    m_sMS = q_ms_s + (prev_match ? POINTS_MATCH2 : POINTS_MATCH);
  } else if (ref1 < 4 && call1 < 4) {
    m_sMS = q_ms_s + (prev_match ? (streak <= 1 ? POINTS_SUBR : POINTS_SUB)
                                 : sub_cost(streak));
  } else {
    m_sMS = q_ms_s + POINTS_NOCALL;
  }
  const int m_sD = q_del_s + (match ? POINTS_MATCH : POINTS_SUB);
  const int m_sI = q_ins_s + (match ? POINTS_MATCH : POINTS_SUB);
  const bool pick_ms = m_sMS >= m_sD && m_sMS >= m_sI;
  const bool pick_d = !pick_ms && m_sD >= m_sI;
  int n_ms_s = pick_ms ? m_sMS : (pick_d ? m_sD : m_sI);
  int n_ms_t = pick_ms ? (match ? (prev_match ? streak + 1 : 1)
                                : (prev_match ? 1 : streak + 1))
                       : 1;
  // DEL from (r, c-1)
  const int rpen = ref1 >= 4 ? POINTS_DEL_REF_N : 0;
  const int d_sMS = st.ms_s + POINTS_DEL + rpen;
  const int d_sD = st.del_s + del_cost(st.del_t) + rpen;
  const bool d_pick = d_sMS >= d_sD;
  int n_del_s = d_pick ? d_sMS : d_sD;
  int n_del_t = d_pick ? 1 : st.del_t + 1;
  // INS from (r-1, c)
  const int i_sMS = p_ms_s + POINTS_INS;
  const int i_sI = p_ins_s + ins_cost(p_ins_t);
  const bool i_pick = i_sMS >= i_sI;
  int n_ins_s = i_pick ? i_sMS : i_sI;
  int n_ins_t = i_pick ? 1 : p_ins_t + 1;
  const uint32_t byte =
      (pick_ms ? 0u : (pick_d ? 1u : 2u)) | (d_pick ? 0u : 4u) | (i_pick ? 0u : 32u);
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
    const int b = c == 0 ? c0 : (r == 0 ? 0 : NEG_BIG);
    n_ms_s = n_del_s = n_ins_s = b;
    n_ms_t = n_del_t = n_ins_t = 0;
  }
  st = State{n_ms_s, n_ms_t, n_del_s, n_del_t, n_ins_s, n_ins_t};
  return byte;
}

// The final-row maxima of the lane that owns row len, combined in state
// order with strict >; a length outside 0..R owns no row and reports no
// alignment (state -1, column -1).
__device__ __forceinline__ void write_best(int32_t* out_s, int32_t* out_c,
                                           int32_t* out_st, int64_t s,
                                           const int* best_s, const int* best_c) {
  int bs = best_s[0], bc = best_c[0], bst = best_c[0] >= 0 ? 0 : -1;
  if (best_s[1] > bs) { bs = best_s[1]; bc = best_c[1]; bst = 1; }
  if (best_s[2] > bs) { bs = best_s[2]; bc = best_c[2]; bst = 2; }
  out_s[s] = bs;
  out_c[s] = bc;
  out_st[s] = bst;
}

__device__ __forceinline__ void keep_best(const State& st, int c, int* best_s,
                                          int* best_c) {
  if (st.ms_s > best_s[0]) { best_s[0] = st.ms_s; best_c[0] = c; }
  if (st.del_s > best_s[1]) { best_s[1] = st.del_s; best_c[1] = c; }
  if (st.ins_s > best_s[2]) { best_s[2] = st.ins_s; best_c[2] = c; }
}

// blocks per SM the register budget is set for: at most 85, 128 or 170
// registers a thread
template <int K>
__global__ void __launch_bounds__(WARPS * 32, K <= 3 ? 6 : (K <= 5 ? 4 : 3))
msa_fill_warp_kernel(const uint8_t* __restrict__ reads,
                     const int32_t* __restrict__ lens,
                     const uint8_t* __restrict__ refs,
                     const int32_t* __restrict__ col0,
                     int32_t* __restrict__ out_s, int32_t* __restrict__ out_c,
                     int32_t* __restrict__ out_st, uint8_t* __restrict__ planes,
                     int S, int R, int ldr, int Cc, int ref_stride) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = (int64_t)blockIdx.x * WARPS + warp;
  if (s >= S) return;
  const int len = lens[s];
  const int nrows = len < 0 ? 0 : min(len, R) + 1;  // live rows 0..nrows-1
  if (nrows > 32 * K) return;  // the block kernel takes this task
  const int fin = (len >= 0 && len <= R) ? len : -1;
  // the window at sref[REF_LPAD + j], the sentinel around it: row r
  // reads column c-1 = d-r-1 >= -32 and <= Cc+30 in a live slice
  uint8_t* sref = reinterpret_cast<uint8_t*>(smem4) + warp * ref_stride;
  for (int i = lane; i < ref_stride; i += 32) {
    const int j = i - REF_LPAD;
    sref[i] = (j >= 0 && j < Cc) ? refs[s * Cc + j] : (uint8_t)REF_PAD;
  }
  __syncwarp();

  const int W = R + 1;
  const int subfloor = -2 * ((len - 1) * POINTS_MATCH2 + POINTS_MATCH);
  const int c00 = __ldg(col0), c01 = __ldg(col0 + 1);
  int call1[K], call0[K], ref_prev[K];
  State cur[K];  // diagonal d-1 of row r
  int q_ms_s[K], q_ms_t[K], q_del_s[K], q_ins_s[K];  // diagonal d-2 of row r-1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = lane + 32 * k;
    const bool on = r <= R;
    const uint8_t* rd = reads + s * ldr;
    call1[k] = r == 0 ? 99 : (on ? rd[r - 1] : 0);
    call0[k] = r < 2 ? 98 : (on ? rd[r - 2] : 0);
    // diagonal 1: c = 1 - r; its reference code (column c-1)
    ref_prev[k] = r == 0 ? sref[REF_LPAD] : REF_PAD;
    const int s1 = r == 1 ? c01 : (r == 0 ? 0 : NEG_BIG);
    cur[k] = State{s1, 0, s1, 0, s1, 0};
    // diagonal 0 at row r-1 (c = 1 - r); row 0 has no row above: 0
    const int s0 = r == 0 ? 0 : (r == 1 ? c00 : NEG_BIG);
    q_ms_s[k] = q_del_s[k] = q_ins_s[k] = s0;
    q_ms_t[k] = 0;
  }
  int best_s[3] = {NEG_BIG, NEG_BIG, NEG_BIG};
  int best_c[3] = {-1, -1, -1};
  const int src = (lane + 31) & 31;

  const int d_last = nrows - 1 + Cc;
#pragma unroll 1
  for (int d = 2; d <= d_last; ++d) {
    uint8_t* prow = planes + ((int64_t)(d - 2) * S + s) * W;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int a = 32 * k;
      // slice k holds a live cell on diagonals a .. min(a+31, len) + Cc
      if (a >= nrows || d < a || d > min(a + 31, nrows - 1) + Cc) continue;
      // row r-1 on diagonal d-1: lane l-1 of this slice; lane 0 reads lane
      // 31 of slice k-1 (not yet moved to d), or row -1 (zeros)
      int p_ms_s, p_ms_t, p_del_s, p_ins_s, p_ins_t;
      if (k == 0) {
        p_ms_s = __shfl_up_sync(FULL, cur[0].ms_s, 1);
        p_ms_t = __shfl_up_sync(FULL, cur[0].ms_t, 1);
        p_del_s = __shfl_up_sync(FULL, cur[0].del_s, 1);
        p_ins_s = __shfl_up_sync(FULL, cur[0].ins_s, 1);
        p_ins_t = __shfl_up_sync(FULL, cur[0].ins_t, 1);
        if (lane == 0) p_ms_s = p_ms_t = p_del_s = p_ins_s = p_ins_t = 0;
      } else {
        const State& lo = cur[k > 0 ? k - 1 : 0];
        const State& me = cur[k];
        const bool top = lane == 31;
        p_ms_s = __shfl_sync(FULL, top ? lo.ms_s : me.ms_s, src);
        p_ms_t = __shfl_sync(FULL, top ? lo.ms_t : me.ms_t, src);
        p_del_s = __shfl_sync(FULL, top ? lo.del_s : me.del_s, src);
        p_ins_s = __shfl_sync(FULL, top ? lo.ins_s : me.ins_s, src);
        p_ins_t = __shfl_sync(FULL, top ? lo.ins_t : me.ins_t, src);
      }
      const int r = lane + a;
      const int c = d - r;
      const int ref1 = sref[REF_LPAD + c - 1];
      const int c0 = (c == 0 && r <= R) ? __ldg(col0 + r) : 0;
      const uint32_t byte = fill_cell(cur[k], r, c, len, Cc, subfloor, c0, call1[k],
                                      call0[k], ref1, ref_prev[k], q_ms_s[k], q_ms_t[k],
                                      q_del_s[k], q_ins_s[k], p_ms_s, p_ins_s, p_ins_t);
      ref_prev[k] = ref1;
      q_ms_s[k] = p_ms_s;
      q_ms_t[k] = p_ms_t;
      q_del_s[k] = p_del_s;
      q_ins_s[k] = p_ins_s;
      if (r < nrows && c >= 0 && c <= Cc) prow[r] = (uint8_t)byte;
      if (r == fin && c >= 1 && c <= Cc) keep_best(cur[k], c, best_s, best_c);
    }
  }
  if (lane == (fin >= 0 ? fin & 31 : 0))
    write_best(out_s, out_c, out_st, s, best_s, best_c);
}

template <int K>
__global__ void __launch_bounds__(1024)
msa_fill_block_kernel(const uint8_t* __restrict__ reads,
                      const int32_t* __restrict__ lens,
                      const uint8_t* __restrict__ refs,
                      const int32_t* __restrict__ col0,
                      const int32_t* __restrict__ task_ids,
                      int32_t* __restrict__ out_s, int32_t* __restrict__ out_c,
                      int32_t* __restrict__ out_st, uint8_t* __restrict__ planes,
                      int S, int R, int ldr, int Cc) {
  extern __shared__ int4 smem4[];
  const int T = blockDim.x;
  const int nwarps = T >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* xchg = reinterpret_cast<int*>(smem4);  // [2][nwarps][K][XW]
  uint8_t* sread = reinterpret_cast<uint8_t*>(xchg + 2 * nwarps * K * XW);
  uint8_t* sref = sread + R;
  const int64_t s = task_ids ? task_ids[blockIdx.x] : blockIdx.x;
  for (int i = tid; i < R; i += T) sread[i] = reads[s * ldr + i];
  for (int i = tid; i < Cc; i += T) sref[i] = refs[s * Cc + i];
  const int len = lens[s];
  __syncthreads();

  const int W = R + 1;
  const int subfloor = -2 * ((len - 1) * POINTS_MATCH2 + POINTS_MATCH);
  int call1[K], call0[K], c0v[K];
  State cur[K];  // diagonal d-1 of row r
  int q_ms_s[K], q_ms_t[K], q_del_s[K], q_ins_s[K];  // diagonal d-2 of row r-1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = tid + k * T;
    const bool on = r <= R;
    call1[k] = r == 0 ? 99 : (on ? sread[r - 1] : 0);
    call0[k] = r < 2 ? 98 : (on ? sread[r - 2] : 0);
    c0v[k] = on ? col0[r] : 0;
    // diagonal 1: c = 1 - r
    const int s1 = r == 1 ? c0v[k] : (r == 0 ? 0 : NEG_BIG);
    cur[k] = State{s1, 0, s1, 0, s1, 0};
    // diagonal 0 at row r-1 (c = 1 - r); row 0 has no row above: 0
    const int s0 = r == 0 ? 0 : (r == 1 ? col0[0] : NEG_BIG);
    q_ms_s[k] = q_del_s[k] = q_ins_s[k] = s0;
    q_ms_t[k] = 0;
  }
  int best_s[3] = {NEG_BIG, NEG_BIG, NEG_BIG};
  int best_c[3] = {-1, -1, -1};

  for (int d = 2; d <= R + Cc; ++d) {
    int* xb = xchg + (d & 1) * nwarps * K * XW;
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int* p = xb + (warp * K + k) * XW;
        p[0] = cur[k].ms_s;
        p[1] = cur[k].ms_t;
        p[2] = cur[k].del_s;
        p[3] = cur[k].ins_s;
        p[4] = cur[k].ins_t;
      }
    }
    __syncthreads();
    uint8_t* prow = planes + ((int64_t)(d - 2) * S + s) * W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // row r-1 on diagonal d-1
      int p_ms_s = __shfl_up_sync(FULL, cur[k].ms_s, 1);
      int p_ms_t = __shfl_up_sync(FULL, cur[k].ms_t, 1);
      int p_del_s = __shfl_up_sync(FULL, cur[k].del_s, 1);
      int p_ins_s = __shfl_up_sync(FULL, cur[k].ins_s, 1);
      int p_ins_t = __shfl_up_sync(FULL, cur[k].ins_t, 1);
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
        prow[r] = (uint8_t)fill_cell(cur[k], r, c, len, Cc, subfloor, c0v[k], call1[k],
                                     call0[k], ref1, ref0, q_ms_s[k], q_ms_t[k],
                                     q_del_s[k], q_ins_s[k], p_ms_s, p_ins_s, p_ins_t);
        if (r == len && c >= 1 && c <= Cc) keep_best(cur[k], c, best_s, best_c);
      }
      q_ms_s[k] = p_ms_s;
      q_ms_t[k] = p_ms_t;
      q_del_s[k] = p_del_s;
      q_ins_s[k] = p_ins_s;
    }
  }
  const bool owner = (len >= 0 && len <= R) ? tid == len % T : tid == 0;
  if (owner) write_best(out_s, out_c, out_st, s, best_s, best_c);
}

struct Args {
  const uint8_t* reads;
  const int32_t* lens;
  const uint8_t* refs;
  const int32_t* col0;
  int32_t *out_s, *out_c, *out_st;
  uint8_t* planes;
  int S, R, ldr, Cc;
};

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int K>
int launch_warp(const Args& a, cudaStream_t stream) {
  const int ref_stride = (a.Cc + 2 * REF_LPAD + 15) / 16 * 16;
  const size_t smem = (size_t)WARPS * ref_stride;
  const int e = set_smem((const void*)msa_fill_warp_kernel<K>, smem);
  if (e) return e;
  const unsigned blocks = (unsigned)((a.S + WARPS - 1) / WARPS);
  msa_fill_warp_kernel<K><<<blocks, WARPS * 32, smem, stream>>>(
      a.reads, a.lens, a.refs, a.col0, a.out_s, a.out_c, a.out_st, a.planes, a.S,
      a.R, a.ldr, a.Cc, ref_stride);
  return (int)cudaGetLastError();
}

template <int K>
int launch_block(const Args& a, const int32_t* task_ids, int n_tasks, int T,
                 cudaStream_t stream) {
  const size_t smem = (size_t)2 * (T / 32) * K * XW * sizeof(int) + a.R + a.Cc;
  const int e = set_smem((const void*)msa_fill_block_kernel<K>, smem);
  if (e) return e;
  msa_fill_block_kernel<K><<<(unsigned)n_tasks, T, smem, stream>>>(
      a.reads, a.lens, a.refs, a.col0, task_ids, a.out_s, a.out_c, a.out_st,
      a.planes, a.S, a.R, a.ldr, a.Cc);
  return (int)cudaGetLastError();
}

int run_warp(const Args& a, cudaStream_t stream) {
  int K = (a.R + 1 + 31) / 32;
  if (K > MAX_WARP_SLICES) K = MAX_WARP_SLICES;
  switch (K) {
    case 1: return launch_warp<1>(a, stream);
    case 2: return launch_warp<2>(a, stream);
    case 3: return launch_warp<3>(a, stream);
    case 4: return launch_warp<4>(a, stream);
    case 5: return launch_warp<5>(a, stream);
    case 6: return launch_warp<6>(a, stream);
    case 7: return launch_warp<7>(a, stream);
    default: return launch_warp<8>(a, stream);
  }
}

// The block kernel over `task_ids` (all S tasks when null): K rows per
// thread, the least power of two that fits R+1 rows into 1,024 threads.
int run_block(const Args& a, const int32_t* task_ids, int n_tasks,
              cudaStream_t stream) {
  const int W = a.R + 1;
  int K = 1;
  while (K * 1024 < W) K *= 2;
  const int T = ((W + K - 1) / K + 31) / 32 * 32;
  switch (K) {
    case 1: return launch_block<1>(a, task_ids, n_tasks, T, stream);
    case 2: return launch_block<2>(a, task_ids, n_tasks, T, stream);
    case 4: return launch_block<4>(a, task_ids, n_tasks, T, stream);
    case 8: return launch_block<8>(a, task_ids, n_tasks, T, stream);
    case 16: return launch_block<16>(a, task_ids, n_tasks, T, stream);
    case 32: return launch_block<32>(a, task_ids, n_tasks, T, stream);
    case 64: return launch_block<64>(a, task_ids, n_tasks, T, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// reads: uint8 [S, ldr] codes (4 past each length), of which rows use the
// first R; lens: int32 [S]; refs: uint8 [S, Cc]; col0: int32 [R+1]
// column-0 penalties; out_s, out_c, out_st: int32 [S]; planes: uint8
// [R+Cc-1, S, R+1]; R + 1 <= 65,536. variant 0: the warp kernel over
// every task with at most 32 * MAX_WARP_SLICES live rows, and the block
// kernel over `long_ids` (n_long tasks, those with more); variant 1 (for
// measurement): the block kernel over every task. On `stream`. Returns
// the cudaError_t of the launches.
extern "C" int msa_fill(const uint8_t* reads, const int32_t* lens,
                        const uint8_t* refs, const int32_t* col0, int32_t* out_s,
                        int32_t* out_c, int32_t* out_st, uint8_t* planes,
                        int64_t S, int R, int ldr, int Cc, const int32_t* long_ids,
                        int64_t n_long, int variant, cudaStream_t stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (R < 1 || ldr < R || Cc < 1 || S > 0x7FFFFFFF || R + 1 > 65536 || n_long < 0 ||
      n_long > S)
    return (int)cudaErrorInvalidValue;
  const Args a{reads, lens, refs, col0, out_s, out_c, out_st, planes,
               (int)S, R, ldr, Cc};
  if (variant == 1) return run_block(a, nullptr, (int)S, stream);
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const int e = run_warp(a, stream);
  if (e || n_long == 0) return e;
  return run_block(a, long_ids, (int)n_long, stream);
}
