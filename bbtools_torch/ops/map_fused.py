"""The fused BBMap device phase of one batch.

The PyTorch port of bbtools_tpu/ops/map_fused.py `fused_map_step`, with
the same contract: ungapped scoreNoIndels on every candidate site
(ops/score_ungapped.py), the speculative unpruned DP fill with traceback
(ops/msa_fill.py, the B4 kernel) per window class, the maxImperfectScore
gate, winner and runner-up selection per read over a dense [B, K] slot
grid (first-max ties, the lowest task index), and the traceback walk
(ops/msa.py) over only the compacted DP-improved winners.

Differences from the JAX version, none of which reaches an output:

- JAX pads each class to the TPU kernel's tiles and writes per-class
  results with `.at[idx].set(v, mode="drop")`, which drops the pad
  indices (T for `idx`, B*K for `slotflat`). Torch's index_put has no
  drop mode, and on CUDA it is nondeterministic where indices repeat.
  The port's classes are not padded (the fill takes any number of
  tasks), so every index is in range and unique, and the plain indexed
  writes are deterministic.
- The walked-winner cap is decided before the walk: more than `wcap`
  DP-improved winners in a class sets `overflow` and skips the walks
  (the caller redoes the batch on the staged path). JAX caps at
  min(wcap, Sc), which decides the same, since a class never has more
  winners than its Sc tasks.
- A class whose planes would pass the plane budget
  (`msa_fill.plane_budget`) also sets `overflow`, before any work: the
  staged path fills and walks such a class in groups and writes the
  same bytes, as it does after a walk-cap overflow. The JAX package has
  no budget.
- Each class walks exactly its winners, in ascending read order, and a
  class without winners walks nothing; JAX walks a padded set of
  min(wcap, Sc) lanes whose pad rows the host never reads.
- The fill trims its rows to the class's longest read (R' <= L), so the
  walk runs R'+Wc steps, not L+Wc; the walk has ended by then, and its
  rows are padded with the zeros JAX's further steps write.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .msa import msa_walk
from .msa_fill import msa_fill, plane_budget, task_bytes
from .score_ungapped import score_no_indels

NEG = -(1 << 30)


def fused_map_step(L: int, W: int, K: int, cls_shapes, wcap: int,
                   task_reads, task_lens, refwins, slot_map, dp_args):
    """One batch's map phase. L read width, W ungapped window width, K
    slots per read, cls_shapes a tuple of (Wc, Sc) per active DP class,
    wcap the walked-winner cap per class.

    task_reads [T, L] u8, task_lens [T] i32, refwins [T, W] u8 (4-filled
    outside the reference), slot_map [B, K] i32 task index per read slot
    (-1 pad). dp_args: per active class a tuple (idx [Sc] i32 task index,
    slotflat [Sc] i32 b*K+k, maximp [Sc] i32, reads [Sc, L] u8, lens [Sc]
    i32, refs [Sc, Wc] u8), the indices unique across the classes.

    Returns (eff [T] i32, win_task [B] i32, win_score [B] i32, second
    [B] i32, win_used [B] bool, win_cls [B] i32, win_pos [B] i32, win_bc
    [B] i32, overflow bool, ops_subs tuple of [n_c, L+Wc] u8, nst_subs
    tuple of [n_c] i32, n_fills int), where n_c is class c's number of
    DP-improved winners; with overflow the two tuples are empty. Winner
    b's walk row is ops_subs[win_cls[b]][rank of b among its class's
    winners by read id]. n_fills counts the fill calls, one a class.

    Where a class's planes (Sc tasks of `msa_fill.task_bytes` at L rows
    and Wc columns) pass the device's plane budget, the step returns
    overflow at once, with n_fills 0 and every other output None.
    """
    T = task_reads.shape[0]
    B = slot_map.shape[0]
    dev = task_reads.device
    i32 = torch.int32
    for Wc, Sc in cls_shapes:
        need = Sc * task_bytes(L, Wc)
        if need > plane_budget(dev, need):
            return (None,) * 8 + (True, (), (), 0)
    pad = (W - L) // 2
    ug = score_no_indels(
        L, task_reads, task_lens, refwins,
        torch.full((T,), pad, dtype=i32, device=dev),
        torch.full((T,), W, dtype=i32, device=dev),
    )
    eff = ug.clone()
    used = torch.zeros(T, dtype=torch.bool, device=dev)
    cls_t = torch.full((T,), -1, dtype=i32, device=dev)
    pos_t = torch.zeros(T, dtype=i32, device=dev)
    flat = slot_map.reshape(-1).long()
    dense_flat = torch.where(
        flat >= 0, ug[flat.clamp(0, max(T - 1, 0))], NEG
    ).to(i32)
    per_cls = []
    for ci, ((Wc, Sc), args) in enumerate(zip(cls_shapes, dp_args)):
        idx, slotflat, maximp, reads_c, lens_c, refs_c = args
        idx, slotflat = idx.long(), slotflat.long()
        bs, bc, bst, planes = msa_fill(reads_c, lens_c, refs_c)
        ug_c = ug[idx]
        # maxImperfectScore gate: an ungapped-resolved site stays
        # ungapped even when the (unpruned) DP fill scores higher
        usec = (bs > ug_c) & (ug_c <= maximp)
        effc = torch.where(usec, bs, ug_c)
        eff[idx] = effc
        used[idx] = usec
        cls_t[idx] = ci
        pos_t[idx] = torch.arange(Sc, dtype=i32, device=dev)
        dense_flat[slotflat] = effc
        per_cls.append((planes, lens_c, bc, bst))

    dense = dense_flat.reshape(B, K)
    k_star = torch.argmax(dense, dim=1)  # first max == lowest task index
    bi = torch.arange(B, device=dev)
    win_score = dense[bi, k_star]
    second = dense.clone()
    second[bi, k_star] = NEG
    second = second.max(dim=1).values
    win_task = slot_map[bi, k_star].to(i32)
    wt = win_task.long().clamp(0, max(T - 1, 0))
    has = (win_task >= 0) & (win_score > NEG)
    win_used = used[wt] & has
    win_cls = torch.where(win_used, cls_t[wt], -1).to(i32)
    win_pos = torch.where(win_used, pos_t[wt], 0).to(i32)
    win_bc = torch.zeros(B, dtype=i32, device=dev)
    for ci, (planes, lens_c, bc_c, bst_c) in enumerate(per_cls):
        Sc = cls_shapes[ci][1]
        rowi = torch.where(win_cls == ci, win_pos, 0).long().clamp(0, Sc - 1)
        win_bc = torch.where(win_cls == ci, bc_c[rowi], win_bc)
    # one pull decides the cap and sizes the walks
    counts = [int(n) for n in torch.stack(
        [(win_cls == ci).sum() for ci in range(len(per_cls))]
    ).tolist()] if per_cls else []
    overflow = any(n > wcap for n in counts)
    ops_subs, nst_subs = [], []
    if not overflow:
        for ci, (planes, lens_c, bc_c, bst_c) in enumerate(per_cls):
            Wc, Sc = cls_shapes[ci]
            if counts[ci] == 0:
                ops_subs.append(torch.zeros((0, L + Wc), dtype=torch.uint8, device=dev))
                nst_subs.append(torch.zeros(0, dtype=i32, device=dev))
                continue
            # this class's winners in ascending read id, their lanes'
            # planes gathered once, then the walk over those lanes only
            bsel = torch.nonzero(win_cls == ci)[:, 0]
            lane = win_pos[bsel].long().clamp(0, Sc - 1)
            # the fill trimmed its rows to the class's longest read, R'; the
            # walk ends within R'+Wc steps and its rows read 0 past there
            Rp = planes.shape[2] - 1
            ops_s, nst_s = msa_walk(
                Rp, Wc, planes.index_select(1, lane), lens_c[lane],
                bc_c[lane], bst_c[lane],
            )
            ops_subs.append(F.pad(ops_s, (0, L - Rp)))
            nst_subs.append(nst_s)
    return (
        eff, win_task, win_score, second, win_used, win_cls, win_pos, win_bc,
        overflow, tuple(ops_subs), tuple(nst_subs), len(per_cls),
    )
