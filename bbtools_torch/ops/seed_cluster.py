"""Device seed expansion + diagonal clustering for BBMap.

The reference's quickMap seed walk (align2/BBIndex.findAdvanced :433:
per key fetch the Block site list, offset-shift, heap-merge, sweep-count
votes) as torch ops on the batch's device, the PyTorch port of
bbtools_tpu/ops/seed_cluster.py:

  1. per-key site counts: two gathers into the CSR `starts` plane
  2. ragged expansion to flat (site, owner) rows with a STATIC cap,
     built with the sorted-join trick: a (boundaries | slots) sort +
     cumsum replaces both scatter and per-slot binary search
  3. site gather + diagonal shift
  4. cluster by (group, diag) with one packed single-operand sort;
     votes, spreads, and modal diagonals fall out of stable boundary
     partitions (the sort_reduce pattern) — no row gathers
  5. top-`max_sites` clusters per (read, strand) by votes with the host
     path's exact lexsort tie-breaks

Outputs equal models/bbmap.candidates_for_batch exactly (tested): same
values, same order. Overflow of the static site cap returns ok=False.
No tool calls it: BBMap seeds on the host (models/bbmap.py
candidates_for_batch), as the JAX package does. Every sort that carries
a second operand is stable (`lax.sort`'s default), and the packed keys
are nonnegative, so `>>` is the logical shift of the JAX module.
"""

from __future__ import annotations

import torch

_SENT = 0x7FFFFFFFFFFFFFFF


def _sort_by(key, payload):
    """lax.sort((key, payload), num_keys=1): the key sorted stably, the
    payload in its order."""
    sk, order = torch.sort(key, stable=True)
    return sk, payload[order]


def _ragged_src(cnt, t_cap: int):
    """src[t] = run index covering flat slot t, for run sizes cnt [N]
    (the inverse of np.repeat). Boundary rows (run ends) and slot rows
    sort together; a cumsum of boundary flags read at each slot row IS
    the run index."""
    dev = cnt.device
    cum = torch.cumsum(cnt.to(torch.int64), 0)
    bkeys = cum << 1  # boundary at run end, ties before the equal slot
    skeys = (torch.arange(t_cap, dtype=torch.int64, device=dev) << 1) | 1
    sk = torch.sort(torch.cat([bkeys, skeys])).values
    is_b = (sk & 1) == 0
    nb_before = torch.cumsum(is_b.to(torch.int32), 0, dtype=torch.int32)
    # un-sort the slot rows back to t order (slot positions are unique)
    slot_key = torch.where(is_b, _SENT, sk >> 1)
    _, src = _sort_by(slot_key, nb_before)
    return src[:t_cap]


def _partition_front(flag, payload):
    """Stable partition: rows with flag=True first (in original order),
    carrying an int64 payload. Returns payload reordered."""
    n = flag.shape[0]
    key = ((~flag).to(torch.int64) << 32) | torch.arange(n, dtype=torch.int64,
                                                         device=flag.device)
    return _sort_by(key, payload)[1]


def _prev(x, fill):
    """x shifted one row down, `fill` in row 0."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _next(x, fill):
    """x shifted one row up, `fill` in the last row."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype, device=x.device)])


def seed_candidates(
    fwd_keys, rkm_keys, valid0, valid1, offs,
    starts32, sites, B: int, K: int, t_cap: int, c_cap: int,
    max_sites: int, bridge: int,
):
    """Device candidates_for_batch on the device of the inputs; see the
    module docstring.

    Returns (read i32, diag i64, strand i32, votes i64, spread i64,
    modal i64, n_out i32, ok bool, nclusters i32[B]) — fixed-cap
    [c_cap] tensors, rows >= n_out are padding; nclusters is the
    PRE-cap cluster census per read (both strands), feeding the
    CLEARZONE1e many-near-best-sites limit (BBMapThread.java:619-627,
    CLEARZONE_LIMIT1e) which needs the true site count, not the capped
    list length."""
    dev = fwd_keys.device
    i64, i32 = torch.int64, torch.int32
    keys = torch.stack([fwd_keys, rkm_keys])  # [2, B, K] i32
    valid = torch.stack([valid0, valid1])
    flat_keys = keys.reshape(-1)
    flat_valid = valid.reshape(-1)
    flat_off = offs.to(i64)[None].expand(2, B, K).reshape(-1)
    nslots = flat_keys.shape[0]
    kk = flat_keys.long().clamp(0, starts32.shape[0] - 2)
    s0 = starts32[kk]
    s1 = starts32[kk + 1]
    cnt = torch.where(flat_valid, s1 - s0, 0)
    total = cnt.to(i64).sum()
    ok = total <= t_cap
    src = _ragged_src(cnt, t_cap).clamp(0, nslots - 1).long()
    t_iota = torch.arange(t_cap, dtype=i64, device=dev)
    live = t_iota < total
    cum_excl = (torch.cumsum(cnt.to(i64), 0) - cnt)[src]
    site_idx = s0[src].to(i64) + (t_iota - cum_excl)
    site = sites[site_idx.clamp(0, sites.shape[0] - 1)]
    diag = site.to(i64) - flat_off[src]
    strand = src // (B * K)
    read = (src // K) % B
    group = read * 2 + strand

    # ---- cluster: one packed sort by (group, diag) ----
    BIAS = 1 << 40
    packed = torch.where(live, (group << 42) | (diag + BIAS), _SENT)
    sp = torch.sort(packed).values
    slive = sp != _SENT
    g = torch.where(slive, sp >> 42, -1)
    d = torch.where(slive, (sp & ((1 << 42) - 1)) - BIAS, 0)
    prev_g = _prev(g, -2)
    prev_d = _prev(d, 0)
    boundary = slive & ((g != prev_g) | (d - prev_d > bridge))
    n_clusters = boundary.sum().to(i32)
    nvalid = slive.sum()
    iota32 = torch.arange(t_cap, dtype=i32, device=dev)
    iota64 = iota32.to(i64)

    # per-cluster planes (row c = cluster c, ascending group/diag):
    # start pos + start diag + group via boundary partition
    bpos = _partition_front(boundary, iota64)
    firsts = _partition_front(boundary, d)
    cgroup = _partition_front(boundary, g)
    nxt = _next(bpos, 0)
    clive = iota32 < n_clusters
    lastc = iota32 == n_clusters - 1
    votes = torch.where(clive, torch.where(lastc, nvalid, nxt) - bpos, 0)
    # end diag: the last live row of each cluster, gather-free
    next_b = _next(boundary, True)
    is_last = slive & (next_b | (t_iota == nvalid - 1))
    end_d = _partition_front(is_last, d)
    spread = torch.where(clive, end_d - firsts, 0)

    # ---- modal diagonal: runs of equal (cluster, diag) ----
    cid = torch.cumsum(boundary.to(i32), 0, dtype=i32) - 1
    run_b = slive & (boundary | (d != prev_d))
    n_runs = run_b.sum().to(i32)
    rpos = _partition_front(run_b, iota64)
    rcl = _partition_front(run_b, cid.to(i64))
    rdg = _partition_front(run_b, d)
    rnxt = _next(rpos, 0)
    rlive = iota32 < n_runs
    rlast = iota32 == n_runs - 1
    rcount = torch.where(rlive, torch.where(rlast, nvalid, rnxt) - rpos, 0)
    # host: lexsort((-rcount, rcluster)) stable; first row per cluster
    # wins -> pack (cluster, count-desc, run index) and sort
    MAXC = 1 << 21
    rpack = torch.where(rlive, (rcl << 43) | ((MAXC - rcount) << 22) | iota64, _SENT)
    rsp, rdg_s = _sort_by(rpack, rdg)
    rcl_s = torch.where(rsp != _SENT, rsp >> 43, -1)
    firstrun = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          rcl_s[1:] != rcl_s[:-1]]) & (rcl_s >= 0)
    modal = _partition_front(firstrun, rdg_s)  # row c = cluster c

    # ---- top max_sites per group by votes (lexsort semantics) ----
    MAXV = 1 << 29
    cpack = torch.where(
        clive,
        (cgroup << 43) | ((MAXV - votes) << 14) | iota32.clamp(max=(1 << 14) - 1).to(i64),
        _SENT,
    )
    csp, csel = _sort_by(cpack, iota64)
    cg_s = torch.where(csp != _SENT, csp >> 43, -1)
    gb = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    cg_s[1:] != cg_s[:-1]]) & (cg_s >= 0)
    laststart = torch.cummax(torch.where(gb, iota32, -1), 0).values
    rank = iota32 - laststart
    keep = (cg_s >= 0) & (rank < max_sites)
    sel = _partition_front(keep, csel)[:c_cap].clamp(0, t_cap - 1)
    n_out = keep.sum().clamp(max=c_cap).to(i32)
    # pre-cap cluster census per read: csp is sorted with group in the
    # top bits (dead rows at the end), so per-read counts are two
    # binary searches on the group plane — no scatter
    cg_sorted = torch.where(csp != _SENT, csp >> 43, 2 * B)
    qpts = torch.arange(B + 1, dtype=i64, device=dev) * 2
    bnds = torch.searchsorted(cg_sorted, qpts)
    nclusters = torch.diff(bnds).to(i32)
    out_group = cgroup[sel]
    return (
        (out_group // 2).to(i32),
        firsts[sel],
        (out_group & 1).to(i32),
        votes[sel],
        spread[sel],
        modal[sel],
        n_out,
        ok,
        nclusters,
    )
