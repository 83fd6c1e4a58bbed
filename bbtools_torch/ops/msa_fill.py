"""The unpruned MultiStateAligner11ts fill with traceback planes (B4).

The counterpart of bbtools_tpu/ops/msa_pallas.py (`msa_fill_pallas`
with traceback=True, the TPU kernel `_kernel`), which equals the XLA
`msa_fill(prune=False, traceback=True)` of its ops/msa.py:
fillUnlimited (MultiStateAligner11ts.java:643-860) as an anti-diagonal
wavefront. MS depends on (r-1, c-1), INS on (r-1, c), DEL on (r, c-1),
so every cell of diagonal d = r + c reads only diagonals d-1 and d-2.

Inputs: reads uint8 [S, R] (code 4 past each read's length), read
lengths int32 [S], reference windows uint8 [S, Cc]; columns outside the
window read the sentinel code 97, as the TPU kernel's padded window
(`prepare_refp`) does. Outputs: best score, column and state int32 [S]
(state -1 and column -1 when no final-row cell qualified), and the
prevState planes uint8 [nd, S, R+1], nd = R+Cc-1, diagonal d stored at
d-2 (ms_prev | del_prev<<2 | ins_prev<<4, the picks taken before the
barriers), the layout `ops.msa.msa_walk` reads.

Both versions trim R to R' = the longest read length of the call (at
least 1, at most R): rows past a read's length are padding, and no cell
of row r feeds a row above it, so the planes are [R'+Cc-1, S, R'+1] and
the walk takes R'. A cell with r <= len and 0 <= c <= Cc is live; the
walk reads live cells only (`live_cells`). The plain version writes
every plane byte, the kernel only those of live cells: the bytes of dead
cells are unspecified.

`msa_fill` is the wrapper: a CPU tensor runs `msa_fill_plain` (a torch
wavefront over the diagonals), a CUDA tensor launches the kernels of
csrc/msa_fill.cu (one warp per task where the call has enough tasks to
fill the card, a task of more than WARP_MAX_ROWS rows going to the band
kernel; otherwise the band kernel over every task, each task's rows cut
into bands of 32 * K, a warp a band, `band_plan`), anything else raises.
All arithmetic is int32 and exact, so both agree to the bit on every
output and every live plane byte.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import msa_constants as C
from .msa import col0_scores, msa_walk

NEG_BIG = -(1 << 30)
#: the sentinel of the reference columns outside the window
REF_PAD = 97
#: the longest read the kernels take: R' + 1 <= 65,536 rows (the C
#: entries' check; the block kernel: its largest template, 64 rows a
#: thread, times its 1,024 threads)
MAX_READ = 64 * 1024 - 1
#: the most rows a task may have for the warp kernel (32 lanes x 8
#: slices); a task with more goes to the band kernel
WARP_MAX_ROWS = 256


def _sub_array_cost(streak):
    i = streak + 1
    return torch.where(
        i > C.LIMIT_FOR_COST_3,
        C.POINTS_SUB3,
        torch.where(i > 1, C.POINTS_SUB2, C.POINTS_SUB),
    )


def _ins_array_cost(streak):
    i = streak + 1
    return torch.where(
        i > C.LIMIT_FOR_COST_4,
        C.POINTS_INS4,
        torch.where(
            i > C.LIMIT_FOR_COST_3,
            C.POINTS_INS3,
            torch.where(i > 1, C.POINTS_INS2, C.POINTS_INS),
        ),
    )


def _del_ext_cost(streak):
    return torch.where(
        streak == 0,
        C.POINTS_DEL,
        torch.where(
            streak < C.LIMIT_FOR_COST_3,
            C.POINTS_DEL2,
            torch.where(
                streak < C.LIMIT_FOR_COST_4,
                C.POINTS_DEL3,
                torch.where(
                    streak < C.LIMIT_FOR_COST_5,
                    C.POINTS_DEL4,
                    torch.where((streak & C.MASK5) == 0, C.POINTS_DEL5, 0),
                ),
            ),
        ),
    )


def _shift_row(x):
    """x[:, r] -> x[:, r-1]; row 0 reads 0."""
    return F.pad(x[:, :-1], (1, 0))


def trimmed_rows(reads, read_lens) -> int:
    """R': the longest read length of the call, at least 1 and at most
    reads.shape[1] (all of it for no tasks). A pull from the device."""
    S, R = reads.shape
    if S == 0:
        return R
    return max(1, min(R, int(read_lens.max())))


def live_cells(read_lens, R: int, Cc: int):
    """bool [R+Cc-1, S, R+1]: the plane bytes of live cells (0 <= r <=
    len, 0 <= c <= Cc, diagonal d = r + c stored at d-2), the ones the
    kernel writes and the walk may read."""
    dev = read_lens.device
    d = torch.arange(2, R + Cc + 1, device=dev)[:, None, None]
    r = torch.arange(R + 1, device=dev)[None, None, :]
    lens = read_lens.to(torch.int64)[None, :, None]
    c = d - r
    return (r <= lens) & (c >= 0) & (c <= Cc)


def msa_fill_plain(reads, read_lens, refs, ref_lens=None):
    """(max_score, max_col, max_state, planes) of the unpruned fill, one
    torch step per diagonal over [S, R'+1] planes (the XLA wavefront of
    bbtools_tpu/ops/msa.py `msa_fill(prune=False, traceback=True)` on
    reads[:, :R']).

    ref_lens (int [S]) gives each window's length where the windows are
    ragged (realignment's); the final-row capture then stops at column
    ref_len and the late insertion barrier at ref_len - 1. None means
    full-width windows, ref_len = Cc, the only case B4 takes. Torch ops
    on any device.

    Two roles: B4's plain yardstick (chip_smoke.py, the card tests) and
    realignment's fill (`ops.msa.realign_batch`). A faster realignment
    fill goes beside this function, never in its place, so that B4's
    yardstick stays independent of the kernels it checks."""
    reads = reads[:, : trimmed_rows(reads, read_lens)]
    S, R = reads.shape
    Cc = refs.shape[1]
    W = R + 1
    nd = R + Cc - 1
    dev = reads.device
    i32 = torch.int32
    rr = torch.arange(W, dtype=i32, device=dev)[None, :]  # [1, W]
    rd = reads.to(i32)
    call1 = torch.cat([torch.full((S, 1), 99, dtype=i32, device=dev), rd], 1)
    call0 = torch.cat([torch.full((S, 2), 98, dtype=i32, device=dev),
                       rd[:, :-1]], 1)
    PAD = R + 2
    refp = F.pad(refs.to(i32), (PAD, PAD), value=REF_PAD)
    # reversed once, so each diagonal's row-ordered codes are a view:
    # row r reads ref[c-1] = refp[d - r + R + 1] = rev[n - 1 - (d - r + R + 1)]
    rev = refp.flip(1)
    n = refp.shape[1]
    col0 = torch.as_tensor(col0_scores(R), dtype=i32, device=dev)[None, :]
    lens = read_lens.to(i32)[:, None]  # [S, 1]
    maxgain = (lens - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    subfloor = -2 * maxgain
    del_barrier = (rr < C.BARRIER_D1) | (rr > lens - C.BARRIER_D1)
    ins_lo = rr < C.BARRIER_I1
    ins_hi = rr > lens - C.BARRIER_I1
    cols = lens.new_full((S, 1), Cc) if ref_lens is None else ref_lens.to(i32)[:, None]
    fin_row = lens.clamp(0, R).long()
    fin_ok = (lens >= 0) & (lens <= R)

    def init_diag(dd):
        c = dd - rr
        s = torch.where(c == 0, col0, torch.where(rr == 0, 0, NEG_BIG))
        return s.to(i32).expand(S, W)

    zero = torch.zeros((S, W), dtype=i32, device=dev)
    s0, s1 = init_diag(0), init_diag(1)
    # (ms_s, ms_t, del_s, del_t, ins_s, ins_t) of diagonals d-1 and d-2
    p1 = (s1, zero, s1, zero, s1, zero)
    p2 = (s0, zero, s0, zero, s0, zero)
    best_s = [torch.full((S,), NEG_BIG, dtype=i32, device=dev) for _ in range(3)]
    best_c = [torch.full((S,), -1, dtype=i32, device=dev) for _ in range(3)]
    planes = torch.empty((nd, S, W), dtype=torch.uint8, device=dev)
    for d in range(2, R + Cc + 1):
        c = d - rr
        lo = n - 1 - (d + R + 1)
        ref1 = rev[:, lo : lo + W]  # ref[c-1] by row
        ref0 = rev[:, lo + 1 : lo + 1 + W]  # ref[c-2] by row
        in_range = (rr >= 1) & (c >= 1)
        match = (call1 == ref1) & (ref1 < 4)
        prev_match = (call0 == ref0) & (ref0 < 4)
        refn = ref1 >= 4
        q_ms_s, q_ms_t, q_del_s, _, q_ins_s, _ = p2
        p_ms_s, _, p_del_s, p_del_t, p_ins_s, p_ins_t = p1
        # --- MS from (r-1, c-1) ---
        s_diag = _shift_row(q_ms_s)
        s_del = _shift_row(q_del_s)
        s_ins = _shift_row(q_ins_s)
        streak = _shift_row(q_ms_t)
        m_sMS = torch.where(
            match,
            s_diag + torch.where(prev_match, C.POINTS_MATCH2, C.POINTS_MATCH),
            torch.where(
                (ref1 < 4) & (call1 < 4),
                s_diag + torch.where(
                    prev_match,
                    torch.where(streak <= 1, C.POINTS_SUBR, C.POINTS_SUB),
                    _sub_array_cost(streak),
                ),
                s_diag + C.POINTS_NOCALL,
            ),
        ).to(i32)
        m_sD = s_del + torch.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        m_sI = s_ins + torch.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        pick_ms = (m_sMS >= m_sD) & (m_sMS >= m_sI)
        pick_d = ~pick_ms & (m_sD >= m_sI)
        ms_score = torch.where(pick_ms, m_sMS, torch.where(pick_d, m_sD, m_sI))
        ms_time = torch.where(
            pick_ms,
            torch.where(
                match,
                torch.where(prev_match, streak + 1, 1),
                torch.where(prev_match, 1, streak + 1),
            ),
            1,
        )
        # --- DEL from (r, c-1) ---
        refn_pen = torch.where(refn, C.POINTS_DEL_REF_N, 0)
        d_sMS = p_ms_s + C.POINTS_DEL + refn_pen
        d_sD = p_del_s + _del_ext_cost(p_del_t) + refn_pen
        d_pick = d_sMS >= d_sD
        del_score = torch.where(d_pick, d_sMS, d_sD)
        del_time = torch.where(d_pick, 1, p_del_t + 1)
        # --- INS from (r-1, c) ---
        i_sMS = _shift_row(p_ms_s) + C.POINTS_INS
        i_streak = _shift_row(p_ins_t)
        i_sI = _shift_row(p_ins_s) + _ins_array_cost(i_streak)
        i_pick = i_sMS >= i_sI
        ins_score = torch.where(i_pick, i_sMS, i_sI)
        ins_time = torch.where(i_pick, 1, i_streak + 1)
        # prevState byte, from the picks before the barriers
        ms_prev = torch.where(pick_ms, 0, torch.where(pick_d, 1, 2))
        planes[d - 2] = (ms_prev + torch.where(d_pick, 0, 4)
                         + torch.where(i_pick, 0, 32)).to(torch.uint8)
        # --- barriers, time clamp, boundary ---
        ins_barrier = (ins_lo & (c > 1)) | (ins_hi & (c < cols - 1))
        del_score = torch.where(del_barrier, subfloor, del_score)
        del_time = torch.where(del_barrier, 0, del_time)
        ins_score = torch.where(ins_barrier, subfloor, ins_score)
        ins_time = torch.where(ins_barrier, 0, ins_time)
        clamp = C.MAX_TIME - C.MASK5
        ms_time = torch.where(ms_time > C.MAX_TIME, clamp, ms_time)
        del_time = torch.where(del_time > C.MAX_TIME, clamp, del_time)
        ins_time = torch.where(ins_time > C.MAX_TIME, clamp, ins_time)
        bnd = torch.where(c == 0, col0, torch.where(rr == 0, 0, NEG_BIG))
        out = []
        for v, b in ((ms_score, bnd), (ms_time, 0), (del_score, bnd),
                     (del_time, 0), (ins_score, bnd), (ins_time, 0)):
            out.append(torch.where(in_range, v, b).to(i32))
        # --- final-row capture: r == len, 1 <= c <= Cc, strict > ---
        fin_c = d - lens[:, 0]
        valid = fin_ok[:, 0] & (fin_c >= 1) & (fin_c <= cols[:, 0])
        for st, plane in enumerate(out[0::2]):
            fs = plane.gather(1, fin_row)[:, 0]
            cand = valid & (fs > best_s[st])
            best_s[st] = torch.where(cand, fs, best_s[st])
            best_c[st] = torch.where(cand, fin_c, best_c[st])
        p2, p1 = p1, tuple(out)
    # combine states in state-major order with strict >
    bs, bc = best_s[0], best_c[0]
    bst = torch.where(bc >= 0, 0, -1).to(i32)
    for st in (1, 2):
        take = best_s[st] > bs
        bs = torch.where(take, best_s[st], bs)
        bc = torch.where(take, best_c[st], bc)
        bst = torch.where(take, st, bst).to(i32)
    return bs, bc, bst, planes


def msa_fill(reads, read_lens, refs, rows: int | None = None):
    """The fill of `msa_fill_plain`. CPU tensors run the plain version;
    CUDA tensors launch the kernels of csrc/msa_fill.cu (reads contiguous
    uint8 [S, R], read_lens int32 [S], refs uint8 [S, Cc]), or raise.
    `rows` is R' (`trimmed_rows`) where the caller holds the lengths on
    the host; None pulls it from the device."""
    if reads.device.type == "cpu":
        return msa_fill_plain(reads, read_lens, refs)
    if reads.device.type != "cuda":
        raise ValueError(f"msa_fill: unsupported device {reads.device}")
    _check("msa_fill", reads, read_lens, refs)
    S = reads.shape[0]
    Rp = trimmed_rows(reads, read_lens) if rows is None else rows
    long_ids = _long_tasks(read_lens, Rp)
    n_warp = S - (0 if long_ids is None else long_ids.numel())
    sms = _sms(reads.device)
    route = "warp" if n_warp >= WARP_MIN_TASKS_PER_SM * sms else few_task_route(Rp + 1, S, sms)
    outs = _launch("msa_fill", reads, read_lens, refs, Rp, route,
                   long_ids if route == "warp" else None)
    if S:
        msa_fill.launches += route == "warp"
        msa_fill.band_launches += route == "band" or (route == "warp" and long_ids is not None)
        msa_fill.block_launches += route == "block"
    return outs


#: kernel launches since the counts were last set to 0: `launches` of the
#: warp kernel, `band_launches` of the band kernel (for the tasks of more
#: than WARP_MAX_ROWS rows, or every task of a call that gives the warp
#: kernel fewer than WARP_MIN_TASKS_PER_SM tasks an SM), `block_launches`
#: of the block kernel (the few-task calls of `few_task_route`'s
#: shapes)
msa_fill.launches = 0
msa_fill.band_launches = 0
msa_fill.block_launches = 0

#: the warp kernel runs where it has at least this many tasks per SM;
#: fewer warps than that leave it bound by one warp's chain of dependent
#: instructions, and the band and block kernels, which spread a task's
#: rows over several warps, are faster (PERF.md: window classes 1-3)
WARP_MIN_TASKS_PER_SM = 8
#: the block kernel keeps a few-task call whose tasks have at most
#: BLOCK_MAX_ROWS rows, or at most BLOCK_BUSY_ROWS (one row a thread)
#: where the call has a task for every second SM: there the card's
#: barrier per diagonal costs less than the band kernel's longer loop and
#: its bands' start-up lag (chip_smoke.py `b4_crossover`, PERF.md)
BLOCK_MAX_ROWS = 512
BLOCK_BUSY_ROWS = 1024
#: the band kernel's templates: rows a lane owns in a band of 32 * K
BAND_K = (1, 2, 4, 8)
#: one-warp blocks an SM holds at once (Hopper's limit of 32 blocks an
#: SM, which the K = 1 kernel's 64 registers also allow)
BAND_RESIDENT_WARPS_PER_SM = 32
#: columns between two of a band's progress stores
BAND_G = 16
#: bytes of one boundary record of the band kernel (one column of a
#: band's last row)
EDGE_BYTES = 16


def few_task_route(rows: int, n_tasks: int, sms: int) -> str:
    """The kernel of a call too small for the warp kernel: n_tasks tasks
    whose longest has `rows` live rows, on a card of `sms` SMs. "block"
    (the block kernel, one block a task) for short tasks, and for tasks of
    up to BLOCK_BUSY_ROWS where every second SM has one; "band" else."""
    if rows <= BLOCK_MAX_ROWS or (rows <= BLOCK_BUSY_ROWS and 2 * n_tasks >= sms):
        return "block"
    return "band"


def band_k(rows: int, n_tasks: int, sms: int) -> int:
    """K for the band kernel over n_tasks tasks whose longest has `rows`
    live rows, on a card of `sms` SMs: 1, the most bands, while one warp
    a band of 32 rows fits what the card holds at once; 2 past that."""
    if n_tasks * -(-rows // 32) <= BAND_RESIDENT_WARPS_PER_SM * sms:
        return 1
    return 2


def band_plan(read_lens, rows: int, sms: int, k: int | None = None):
    """The band kernel's plan for tasks of lengths read_lens (int [n], any
    device) of at most rows - 1 bases (R' + 1 = rows): (K, int32 [n + 1]
    on read_lens' device). K is `band_k`'s, or k; task i's bands of 32 *
    K rows lie on tickets starts[i] .. starts[i+1]-1, band b over rows
    32Kb .. min(32K(b+1), nrows) - 1 of its nrows = min(len, R') + 1 live
    rows, at least one band a task (the one that writes its result)."""
    K = band_k(rows, read_lens.numel(), sms) if k is None else k
    if K not in BAND_K:
        raise ValueError(f"band_plan: K={K} is not one of {BAND_K}")
    nrows = (read_lens.to(torch.int64).clamp(max=rows - 1) + 1).clamp(min=0)
    nb = ((nrows + 32 * K - 1) // (32 * K)).clamp(min=1)
    return K, F.pad(nb.cumsum(0), (1, 0)).to(torch.int32)


def band_edge_bytes(R: int, Cc: int) -> int:
    """The most boundary bytes the band kernel takes for one task of up
    to R bases in a window of Cc columns: a record a column, Cc + 1, for
    each band at the smallest K."""
    return -(-(R + 1) // (32 * BAND_K[0])) * (Cc + 1) * EDGE_BYTES


#: the share of the card's free memory that one fill call's planes and
#: walk output may take; the rest leaves room for the fused phase's copy
#: of its winners' planes (up to its walk cap of tasks). Fewer groups
#: mean fewer walk calls, each a loop of R'+Cc steps
PLANE_SHARE = 0.6
#: the plane budget of the plain version on the CPU, in bytes
CPU_PLANE_BUDGET = 1 << 30


def plane_budget(device, need: int = 0) -> int:
    """Bytes one fill call may give its traceback planes and its walk
    output: PLANE_SHARE of what the card has free now, or
    CPU_PLANE_BUDGET on the CPU. Where `need` (the bytes of the whole
    call) passes that, the allocator's unused cached segments are handed
    back first: a segment that also holds a small live tensor cannot
    serve a large request, so the budget counts only what the card then
    has free."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_PLANE_BUDGET
    free, _total = torch.cuda.mem_get_info(device)
    if need > PLANE_SHARE * free:
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info(device)
    return int(free * PLANE_SHARE)


def task_bytes(R: int, Cc: int) -> int:
    """The most bytes one task of reads of up to R bases in a window of
    Cc columns takes in a fill call and the walk after it: its planes
    [R+Cc-1, R+1], the band kernel's boundary records
    (`band_edge_bytes`), and three copies of its walk row of R+Cc steps
    (the walk's output, its transpose and the padded row)."""
    return (R + Cc - 1) * (R + 1) + band_edge_bytes(R, Cc) + 3 * (R + Cc)


def fill_groups(n: int, R: int, Cc: int, budget: int) -> list[slice]:
    """Contiguous groups of the n tasks of one window class, each of at
    most budget bytes by `task_bytes` (and at least one task): every task
    is filled and walked alone, so the grouping changes no output."""
    per = max(1, int(budget) // task_bytes(R, Cc))
    return [slice(a, min(a + per, n)) for a in range(0, n, per)]


def fill_walk(reads: np.ndarray, read_lens: np.ndarray, refs: np.ndarray, device):
    """The fill and the walk of one window class's tasks (host arrays:
    reads uint8 [S, R], read_lens int32 [S], refs uint8 [S, Cc]) on
    `device`, in the groups of `fill_groups` under `plane_budget`, with
    no pull from the device. Returns ((best score, column, state, walk
    ops, steps) as `msa_fill` and `ops.msa.msa_walk` give them, on
    `device`; the ops [S, R'+Cc], or [S, R+Cc] for more than one group),
    and the number of groups."""
    S, R = reads.shape
    Cc = refs.shape[1]
    groups = fill_groups(S, R, Cc, plane_budget(device, S * task_bytes(R, Cc)))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    parts = []
    for g in groups:
        lens_d = dev(read_lens[g])
        rows = max(1, min(R, int(read_lens[g].max())))
        bs, bc, bst, planes = msa_fill(dev(reads[g]), lens_d, dev(refs[g]), rows=rows)
        # the walk over every task of the group, on the device, over the
        # R' rows the fill kept
        ops, nst = msa_walk(planes.shape[2] - 1, Cc, planes, lens_d, bc, bst)
        del planes
        if len(groups) > 1:
            # rows of one width across the groups; the walk's rows read 0
            # past their end
            ops = F.pad(ops, (0, R + Cc - ops.shape[1]))
        parts.append((bs, bc, bst, ops, nst))
    out = parts[0] if len(parts) == 1 else tuple(torch.cat(x) for x in zip(*parts))
    return out, len(groups)


def msa_fill_variant(variant: str, reads, read_lens, refs, trim: bool = True,
                     k: int | None = None):
    """One kernel route on CUDA tensors, for timing beside `msa_fill`:
    "warp" the warp kernel (the band kernel over the tasks of more than
    WARP_MAX_ROWS rows), "band" the band kernel over every task (K = k,
    or `band_plan`'s), "block" the block kernel over every task; with
    trim=False over all R rows, as the fill first ran. No path of the
    port calls it, and it counts in no launch count."""
    if reads.device.type != "cuda":
        raise ValueError(f"msa_fill_variant: needs a CUDA tensor, not {reads.device}")
    if variant not in ("warp", "band", "block"):
        raise ValueError(f"msa_fill_variant: unknown variant {variant!r}")
    _check("msa_fill_variant", reads, read_lens, refs)
    Rp = trimmed_rows(reads, read_lens) if trim else reads.shape[1]
    long_ids = _long_tasks(read_lens, Rp) if variant == "warp" else None
    return _launch("msa_fill_variant", reads, read_lens, refs, Rp, variant, long_ids, k)


def _check(name: str, reads, read_lens, refs):
    S, R = reads.shape
    Cc = refs.shape[1]
    for t, tname, dt, shape in ((reads, "reads", torch.uint8, (S, R)),
                                (read_lens, "read_lens", torch.int32, (S,)),
                                (refs, "refs", torch.uint8, (S, Cc))):
        if (t.device != reads.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {tname} must be a contiguous {dt} tensor of shape "
                f"{shape} on {reads.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}"
            )
    if R < 1 or Cc < 1:
        raise ValueError(f"{name}: needs R >= 1 and Cc >= 1, got {R}, {Cc}")
    if R > MAX_READ:
        raise ValueError(f"{name}: reads of {R} bases exceed the kernel's {MAX_READ}")


@functools.cache
def _sms(device) -> int:
    """The card's SMs, read once a device: the wrapper's routes depend
    on it, and a call of a millisecond should not pay the query."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _long_tasks(read_lens, Rp: int):
    """int32 indices of the tasks of more than WARP_MAX_ROWS rows (of the
    Rp kept), or None. A pull from the device where Rp allows any."""
    if Rp + 1 <= WARP_MAX_ROWS:
        return None
    ids = torch.nonzero(read_lens.clamp(max=Rp) + 1 > WARP_MAX_ROWS)[:, 0]
    return ids.to(torch.int32) if ids.numel() else None


#: the band kernel's ticket counter and progress words, by (device index,
#: stream handle): zeroed once when allocated, each call's epoch telling
#: its words from an earlier call's
_BAND_SYNC: dict[tuple[int, int], torch.Tensor] = {}


def _band_sync(device, stream: int, words: int) -> torch.Tensor:
    key = (device.index, stream)
    sync = _BAND_SYNC.get(key)
    if sync is None or sync.numel() < words:
        sync = torch.zeros(words, dtype=torch.int64, device=device)
        _BAND_SYNC[key] = sync
    return sync


def _launch(name: str, reads, read_lens, refs, Rp: int, variant: str, band_ids,
            k: int | None = None):
    """The fill over Rp rows: variant "warp" the warp kernel, then the
    band kernel over `band_ids` (int32 task indices, or None for none);
    "band" the band kernel over every task (K = k, or band_plan's);
    "block" the block kernel over every task (band_ids None)."""
    S, R = reads.shape
    Cc = refs.shape[1]
    dev = reads.device
    outs = tuple(torch.empty(S, dtype=torch.int32, device=dev) for _ in range(3))
    planes = torch.empty((Rp + Cc - 1, S, Rp + 1), dtype=torch.uint8, device=dev)
    if S == 0:
        return (*outs, planes)
    col0 = torch.as_tensor(col0_scores(Rp), dtype=torch.int32, device=dev)
    from ..kernels.build import check, library

    lib = library()
    ptrs = (reads.data_ptr(), read_lens.data_ptr(), refs.data_ptr(), col0.data_ptr())
    out_ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                planes.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant != "band":
            rc = lib.msa_fill(*ptrs, *out_ptrs, S, Rp, R, Cc,
                              VARIANTS[variant], ctypes.c_void_p(stream))
            check(rc, name)
        if variant == "band" or band_ids is not None:
            lens = read_lens if variant == "band" else read_lens[band_ids.long()]
            K, starts = band_plan(lens, Rp + 1, _sms(dev), k)
            n = lens.numel()
            n_tickets = n * -(-(Rp + 1) // (32 * K))
            sync = _band_sync(dev, stream, 1 + n_tickets)
            edges = torch.empty((n_tickets, Cc + 1, EDGE_BYTES // 4), dtype=torch.int32,
                                device=dev)
            ids = band_ids.data_ptr() if variant != "band" else None
            rc = lib.msa_fill_band(*ptrs, ids, starts.data_ptr(), n, n_tickets, K, BAND_G,
                                   sync.data_ptr(), edges.data_ptr(), *out_ptrs, S, Rp, R,
                                   Cc, ctypes.c_void_p(stream))
            check(rc, name)
    return (*outs, planes)


#: the C entry's variants of `msa_fill`: the warp kernel, and the
#: block kernel over every task
VARIANTS = {"warp": 0, "block": 1}
