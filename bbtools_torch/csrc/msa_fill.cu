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
// What bounds the warp kernel on Hopper: the SMs' instruction rate. Each
// computed cell costs some eighty instructions (three candidate scores
// per state, selects, barriers, clamps, five shuffles) and one plane
// byte; chip_smoke.py counts the instructions of the diagonal loop in the
// built code. With reads of 151 bases in a 280-column window, the slices
// cover ~50,000 cells of a task against 42,500 live ones.
//
// The band kernel, `msa_fill_band_kernel`, takes the tasks of more than
// 32 * MAX_WARP_SLICES rows, and every task of a call too small to give
// the warp kernel a few warps an SM whose tasks are too long for the
// block kernel below (the wrapper's choices, by shape). A
// task's live rows 0..min(len, R) are cut into bands of 32 * K rows,
// and each band is one warp (one block of one warp) that runs the warp
// kernel's diagonal loop over its band: the same fill_cell, the same
// skipping of dead slices, the same plane-row stores and the same
// final-row capture, in the band that owns row len. A band starting at
// row r0 >= 2 starts at diagonal r0 with the warp kernel's seed values,
// which are the boundary values its rows hold on diagonals r0-1 and
// r0-2 (every column there is negative).
//
// The boundary record. Lane 0 of the band's first slice reads row r0-1,
// the last row of the band above, from a buffer in global memory: one
// 16-byte record a column c = 0..Cc (ms_s, del_s, ins_s, and ms_t |
// ins_t << 16: both times are at most MAX_TIME), written by lane 31 of
// the band above's last slice right after it computes (r0-1, c). The
// buffer holds a band's whole column range, so a producer never waits
// for its consumer. The consumer copies the records of up to 32 columns
// at a time into shared memory and reads one a diagonal; the d-2 words
// are the previous column's, kept in registers as in the warp kernel.
//
// Order and progress. Each warp draws a ticket from an atomic counter in
// a scratch buffer that outlives the call (the counter in the low 32
// bits, the call's epoch above it; the warp that draws the last ticket
// resets the counter and advances the epoch). Tickets are handed out in
// the order the warps start, and the wrapper's plan lays the bands of a
// task on consecutive tickets (`band_start`), band b of a task on ticket
// t waiting only on ticket t-1, band b-1. Ticket t-1 was drawn by a warp
// that is running or done, and that warp waits only on one drawn before
// it, down to the task's band 0, which waits on nothing: whatever the
// residency, no band waits on a band that cannot run, so the kernel
// cannot deadlock. Each band publishes its progress every G columns and
// at its last column: lane 31 stores its records, then (epoch << 32 |
// columns done) into the band's progress word with a release store. The
// consumer's lane 0 polls that word with acquire loads until it covers
// the column it needs, then __syncwarp, and the warp copies the records.
// A word of an earlier call carries an older epoch and reads as no
// progress, so the scratch is zeroed once when it is allocated, not
// before each call. A task has ceil((min(len, R) + 1) / (32 K)) bands,
// at least one (the one that writes its result): no band lies past its
// task's length, so none stalls the order. Tickets past the plan's last
// band exit at once.
//
// What bounds the band kernel on this card: at mapPacBio's widest class
// (4 tasks, R = 6,000, Cc = 13,640) not the instruction rate but the
// chain of R + Cc dependent diagonals. Its ~560 bands give a scheduler
// about one warp, so a diagonal step costs the loop's couple of hundred
// instructions at the latency of each, not at the issue rate, and each
// band starts some G columns (and a release-acquire round trip through
// the L2) after the band above. Small K gives more bands and warps to
// hide that chain; large K fewer records, polls and loop overheads. The
// wrapper picks K (`band_k` in ops/msa_fill.py) from a crossover
// measured on the card.
//
// The fill's first design, `msa_fill_block_kernel` (one block per task,
// thread t owns rows t + k*T, one __syncthreads per diagonal, every row
// on every diagonal), keeps the small calls of short tasks: with one row
// a thread, its barrier per diagonal costs less than the band kernel's
// longer loop and its bands' start-up lag (ops/msa_fill.py
// `few_task_route`, from chip_smoke.py's crossover).

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
// the band kernel's scratch: the ticket counter in the low TICKET_BITS
// bits of its first word, the call's epoch above them, then one progress
// word a ticket
constexpr int TICKET_BITS = 32;
constexpr unsigned long long TICKET_MASK = (1ull << TICKET_BITS) - 1;

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
  if (nrows > 32 * K) return;  // the band kernel takes this task
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

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One band of 32 * K rows of one task, one warp a block. task_ids (null:
// task i is i) names the n_tasks tasks of the call; band_start [n_tasks +
// 1] their first tickets. n_draws warps draw tickets; sync holds the
// ticket counter and a progress word a ticket, edges (Cc + 1) boundary
// records a ticket.
template <int K>
__global__ void __launch_bounds__(32, K <= 3 ? 24 : (K <= 5 ? 16 : 12))
msa_fill_band_kernel(const uint8_t* __restrict__ reads,
                     const int32_t* __restrict__ lens,
                     const uint8_t* __restrict__ refs,
                     const int32_t* __restrict__ col0,
                     const int32_t* __restrict__ task_ids,
                     const int32_t* __restrict__ band_start, int n_tasks,
                     unsigned long long n_draws, int G,
                     unsigned long long* __restrict__ sync, int4* __restrict__ edges,
                     int32_t* __restrict__ out_s, int32_t* __restrict__ out_c,
                     int32_t* __restrict__ out_st, uint8_t* __restrict__ planes,
                     int S, int R, int ldr, int Cc, int ref_stride) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x;
  // the ticket; the warp that draws the last one starts the next epoch
  unsigned long long h = 0;
  if (lane == 0) {
    h = atomicAdd(sync, 1ull);
    if ((h & TICKET_MASK) == n_draws - 1)
      atomicExch(sync, ((h >> TICKET_BITS) + 1) << TICKET_BITS);
  }
  h = __shfl_sync(FULL, h, 0);
  const int t = (int)(h & TICKET_MASK);
  const unsigned long long tag = (h >> TICKET_BITS) << 32;
  if (t >= __ldg(band_start + n_tasks)) return;
  // the task: the last i with band_start[i] <= t
  int lo = 0, hi = n_tasks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(band_start + mid) <= t) lo = mid; else hi = mid - 1;
  }
  const int64_t s = task_ids ? __ldg(task_ids + lo) : lo;
  const int b = t - __ldg(band_start + lo);
  const bool above = b > 0;
  const bool below = t + 1 < __ldg(band_start + lo + 1);
  unsigned long long* prog = sync + 1;
  const int4* from = edges + (int64_t)(t - 1) * (Cc + 1);
  int4* to = edges + (int64_t)t * (Cc + 1);

  const int len = lens[s];
  const int nrows = len < 0 ? 0 : min(len, R) + 1;  // live rows 0..nrows-1
  const int fin = (len >= 0 && len <= R) ? len : -1;
  const int r0 = b * 32 * K;
  const int end = min(r0 + 32 * K, nrows);  // the band's rows r0..end-1
  int4* stage = smem4;  // up to 32 records of row r0-1
  uint8_t* sref = reinterpret_cast<uint8_t*>(smem4 + 32);
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
    // rows r >= 2 hold the boundary on diagonals r0-1 and r0-2, where
    // the band starts; band 0 starts at diagonal 2, as the warp kernel
    const int r = r0 + lane + 32 * k;
    const bool on = r <= R;
    const uint8_t* rd = reads + s * ldr;
    call1[k] = r == 0 ? 99 : (on ? rd[r - 1] : 0);
    call0[k] = r < 2 ? 98 : (on ? rd[r - 2] : 0);
    ref_prev[k] = r == 0 ? sref[REF_LPAD] : REF_PAD;
    const int s1 = r == 1 ? c01 : (r == 0 ? 0 : NEG_BIG);
    cur[k] = State{s1, 0, s1, 0, s1, 0};
    const int s0 = r == 0 ? 0 : (r == 1 ? c00 : NEG_BIG);
    q_ms_s[k] = q_del_s[k] = q_ins_s[k] = s0;
    q_ms_t[k] = 0;
  }
  int best_s[3] = {NEG_BIG, NEG_BIG, NEG_BIG};
  int best_c[3] = {-1, -1, -1};
  const int src = (lane + 31) & 31;
  int have = 0, base = 0;  // records base..have-1 are staged
  int next_pub = G;        // columns done at the next progress store

  const int d_last = end - 1 + Cc;
  const int d_first = max(2, r0);
  const int64_t plane_step = (int64_t)S * W;
  uint8_t* prow = planes + ((int64_t)(d_first - 2) * S + s) * W;
#pragma unroll 1
  for (int d = d_first; d <= d_last; ++d, prow += plane_step) {
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int a = r0 + 32 * k;
      // with one slice, the loop's range is the slice's live interval
      if (K > 1 && (a >= nrows || d < a || d > min(a + 31, nrows - 1) + Cc)) continue;
      int p_ms_s, p_ms_t, p_del_s, p_ins_s, p_ins_t;
      if (k == 0) {
        p_ms_s = __shfl_up_sync(FULL, cur[0].ms_s, 1);
        p_ms_t = __shfl_up_sync(FULL, cur[0].ms_t, 1);
        p_del_s = __shfl_up_sync(FULL, cur[0].del_s, 1);
        p_ins_s = __shfl_up_sync(FULL, cur[0].ins_s, 1);
        p_ins_t = __shfl_up_sync(FULL, cur[0].ins_t, 1);
        // lane 0: row r0-1 at column d - r0, the band above's record, or
        // row -1 (zeros); past column Cc its cell is dead
        int4 e = make_int4(0, 0, 0, 0);
        const int c = d - r0;
        if (above && c <= Cc) {
          if (c >= have) {
            int n = 0;
            if (lane == 0) {
              do {
                const unsigned long long f = ld_acquire(prog + t - 1);
                n = (f & ~TICKET_MASK) == tag ? (int)(f & TICKET_MASK) : 0;
              } while (n <= c);
            }
            __syncwarp();
            n = __shfl_sync(FULL, n, 0);
            base = c;
            have = min(n, c + 32);
            if (c + lane < have) stage[lane] = __ldcg(from + c + lane);
            __syncwarp();
          }
          e = stage[c - base];
        }
        if (lane == 0) {
          p_ms_s = e.x;
          p_del_s = e.y;
          p_ins_s = e.z;
          p_ms_t = e.w & 0xFFFF;
          p_ins_t = e.w >> 16;
        }
      } else {
        const State& lo_st = cur[k > 0 ? k - 1 : 0];
        const State& me = cur[k];
        const bool top = lane == 31;
        p_ms_s = __shfl_sync(FULL, top ? lo_st.ms_s : me.ms_s, src);
        p_ms_t = __shfl_sync(FULL, top ? lo_st.ms_t : me.ms_t, src);
        p_del_s = __shfl_sync(FULL, top ? lo_st.del_s : me.del_s, src);
        p_ins_s = __shfl_sync(FULL, top ? lo_st.ins_s : me.ins_s, src);
        p_ins_t = __shfl_sync(FULL, top ? lo_st.ins_t : me.ins_t, src);
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
      // the last row's record for the band below (a band with one below
      // is full: its last row is lane 31 of slice K-1)
      if (k == K - 1 && below && d - (a + 31) >= 0 && d - (a + 31) <= Cc) {
        const int cl = d - (a + 31);
        const State& st = cur[K - 1];
        if (lane == 31)
          to[cl] = make_int4(st.ms_s, st.del_s, st.ins_s, st.ms_t | (st.ins_t << 16));
        if (cl + 1 == next_pub || cl == Cc) {
          if (lane == 31) st_release(prog + t, tag | (unsigned long long)(cl + 1));
          next_pub += G;
        }
      }
    }
  }
  const int owner = fin >= 0 ? fin / (32 * K) : 0;
  if (b == owner && lane == (fin >= 0 ? fin & 31 : 0))
    write_best(out_s, out_c, out_st, s, best_s, best_c);
}

template <int K>
__global__ void __launch_bounds__(1024)
msa_fill_block_kernel(const uint8_t* __restrict__ reads,
                      const int32_t* __restrict__ lens,
                      const uint8_t* __restrict__ refs,
                      const int32_t* __restrict__ col0,
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
  const int64_t s = blockIdx.x;
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
int launch_block(const Args& a, int T, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (T / 32) * K * XW * sizeof(int) + a.R + a.Cc;
  const int e = set_smem((const void*)msa_fill_block_kernel<K>, smem);
  if (e) return e;
  msa_fill_block_kernel<K><<<(unsigned)a.S, T, smem, stream>>>(
      a.reads, a.lens, a.refs, a.col0, a.out_s, a.out_c, a.out_st, a.planes, a.S, a.R,
      a.ldr, a.Cc);
  return (int)cudaGetLastError();
}

// The band kernel's launch: one block of one warp a ticket.
struct Band {
  const int32_t* task_ids;
  const int32_t* band_start;
  int n_tasks;
  int64_t n_tickets;
  int G;
  unsigned long long* sync;
  int4* edges;
};

template <int K>
int launch_band(const Args& a, const Band& b, cudaStream_t stream) {
  const int ref_stride = (a.Cc + 2 * REF_LPAD + 15) / 16 * 16;
  const size_t smem = 32 * sizeof(int4) + (size_t)ref_stride;
  const int e = set_smem((const void*)msa_fill_band_kernel<K>, smem);
  if (e) return e;
  msa_fill_band_kernel<K><<<(unsigned)b.n_tickets, 32, smem, stream>>>(
      a.reads, a.lens, a.refs, a.col0, b.task_ids, b.band_start, b.n_tasks,
      (unsigned long long)b.n_tickets, b.G, b.sync, b.edges, a.out_s, a.out_c, a.out_st,
      a.planes, a.S, a.R, a.ldr, a.Cc, ref_stride);
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

// The block kernel over every task: K rows per thread, the least power
// of two that fits R+1 rows into 1,024 threads.
int run_block(const Args& a, cudaStream_t stream) {
  const int W = a.R + 1;
  int K = 1;
  while (K * 1024 < W) K *= 2;
  const int T = ((W + K - 1) / K + 31) / 32 * 32;
  switch (K) {
    case 1: return launch_block<1>(a, T, stream);
    case 2: return launch_block<2>(a, T, stream);
    case 4: return launch_block<4>(a, T, stream);
    case 8: return launch_block<8>(a, T, stream);
    case 16: return launch_block<16>(a, T, stream);
    case 32: return launch_block<32>(a, T, stream);
    case 64: return launch_block<64>(a, T, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int check_args(int64_t S, int R, int ldr, int Cc) {
  return (R < 1 || ldr < R || Cc < 1 || S > 0x7FFFFFFF || R + 1 > 65536)
             ? (int)cudaErrorInvalidValue
             : (int)cudaSuccess;
}

}  // namespace

// reads: uint8 [S, ldr] codes (4 past each length), of which rows use the
// first R; lens: int32 [S]; refs: uint8 [S, Cc]; col0: int32 [R+1]
// column-0 penalties; out_s, out_c, out_st: int32 [S]; planes: uint8
// [R+Cc-1, S, R+1]; R + 1 <= 65,536. variant 0: the warp kernel over
// every task with at most 32 * MAX_WARP_SLICES live rows (the rest are
// left to msa_fill_band); variant 1: the block kernel over every
// task. On `stream`. Returns the cudaError_t of the launch.
extern "C" int msa_fill(const uint8_t* reads, const int32_t* lens,
                        const uint8_t* refs, const int32_t* col0, int32_t* out_s,
                        int32_t* out_c, int32_t* out_st, uint8_t* planes,
                        int64_t S, int R, int ldr, int Cc, int variant,
                        cudaStream_t stream) {
  if (S <= 0) return (int)cudaSuccess;
  const int e = check_args(S, R, ldr, Cc);
  if (e) return e;
  const Args a{reads, lens, refs, col0, out_s, out_c, out_st, planes,
               (int)S, R, ldr, Cc};
  if (variant == 0) return run_warp(a, stream);
  if (variant == 1) return run_block(a, stream);
  return (int)cudaErrorInvalidValue;
}

// The band kernel over the n_tasks tasks `task_ids` (null: tasks
// 0..n_tasks-1) of the arrays msa_fill takes, K rows a lane (1, 2, 4 or
// 8), a progress store every G columns. band_start: int32 [n_tasks + 1],
// task i's bands on tickets band_start[i] .. band_start[i+1]-1;
// n_tickets >= band_start[n_tasks] warps are launched. sync: uint64 [1 +
// n_tickets], zeroed once when allocated and kept for the stream's later
// calls; edges: int4 [n_tickets, Cc + 1], any contents.
extern "C" int msa_fill_band(const uint8_t* reads, const int32_t* lens,
                             const uint8_t* refs, const int32_t* col0,
                             const int32_t* task_ids, const int32_t* band_start,
                             int64_t n_tasks, int64_t n_tickets, int K, int G,
                             void* sync, void* edges, int32_t* out_s, int32_t* out_c,
                             int32_t* out_st, uint8_t* planes, int64_t S, int R,
                             int ldr, int Cc, cudaStream_t stream) {
  if (n_tasks <= 0) return (int)cudaSuccess;
  const int e = check_args(S, R, ldr, Cc);
  if (e) return e;
  if (n_tasks > S || n_tickets < n_tasks || n_tickets > 0x7FFFFFFF || G < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{reads, lens, refs, col0, out_s, out_c, out_st, planes,
               (int)S, R, ldr, Cc};
  const Band b{task_ids, band_start, (int)n_tasks, n_tickets, G,
               static_cast<unsigned long long*>(sync), static_cast<int4*>(edges)};
  switch (K) {
    case 1: return launch_band<1>(a, b, stream);
    case 2: return launch_band<2>(a, b, stream);
    case 4: return launch_band<4>(a, b, stream);
    case 8: return launch_band<8>(a, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
