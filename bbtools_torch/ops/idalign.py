"""IDAligner family — identity-only aligners behind one interface.

The PyTorch port of bbtools_tpu/ops/idalign.py. Reference:
idaligner/IDAligner.java (interface: name(), align(q, r[,pos]) ->
identity fraction), idaligner/Factory.java (name -> implementation).
The host engines (glocal, crosscut, quantum, wobble, drifting, xdrop,
wavefront, banded) and `make_id_aligner` are the JAX package's.

The device work runs as torch ops on the device of the call:

  - `glocal_identity` (ROADMAP L5): the batched exact glocal aligner, a
    loop over the query rows on [T, N+1] int32 tensors. The left-gap
    relaxation is a prefix max with ties to the latest column, taken as
    `torch.cummax` over a packed int64 key ((G + 2^30) << b | t), so the
    tie rule follows from the key's value alone. Matches, columns and the
    entry column ride along the selection, so no traceback is needed.
    `glocal_identity.device_calls` counts its calls on CUDA tensors.
  - `BandedIDAligner.align_batch`: the banded edit distance
    (ops/banded.align_pairs) on the device given.

Scoring for glocal follows the family's unit model: match +1, sub -1,
gap -1 (idaligner/Tracer semantics: identity = matches / columns).
"""

from __future__ import annotations

import numpy as np
import torch

# idaligner/GlocalAligner.java:196-199: MATCH=+1, SUB=INS=DEL=-1.
# gap=-1 (not -2) is load-bearing: Test.validate pins align(AA,AGA)=2/3,
# which requires the gapped path to beat the substitution path on ties.
MATCH, SUB, GAP = 1, -1, -1


def glocal_align_np(q: np.ndarray, r: np.ndarray):
    """Exact glocal alignment. Returns (identity, rstart, rstop).

    Query is global (fully aligned); ref start/end are free.
    """
    m, n = len(q), len(r)
    if m == 0 or n == 0:
        return 0.0, 0, -1
    NEG = -(1 << 30)
    score = np.zeros((m + 1, n + 1), dtype=np.int64)
    score[1:, 0] = GAP * np.arange(1, m + 1)  # query must be consumed
    ptr = np.zeros((m + 1, n + 1), dtype=np.int8)  # 0 diag, 1 up, 2 left
    for i in range(1, m + 1):
        sub = np.where(r == q[i - 1], MATCH, SUB)
        diag = score[i - 1, :-1] + sub
        up = score[i - 1, 1:] + GAP
        best = np.maximum(diag, up)
        p = np.where(diag >= up, 0, 1).astype(np.int8)
        # left dependency: prefix-max of (best[j] + GAP*(n-j)) relaxation
        row = np.empty(n + 1, dtype=np.int64)
        row[0] = score[i, 0]
        cur = row[0]
        for j in range(1, n + 1):
            left = cur + GAP
            if best[j - 1] >= left:
                cur = best[j - 1]
                ptr[i, j] = p[j - 1]
            else:
                cur = left
                ptr[i, j] = 2
            row[j] = cur
        score[i] = row
    j = int(np.argmax(score[m]))
    rstop = j - 1
    matches = cols = 0
    i = m
    while i > 0 and j >= 0:
        d = ptr[i, j] if j > 0 else 1
        if j == 0:
            d = 1
        if d == 0:
            cols += 1
            if r[j - 1] == q[i - 1]:
                matches += 1
            i -= 1
            j -= 1
        elif d == 1:
            cols += 1
            i -= 1
        else:
            cols += 1
            j -= 1
    rstart = j
    identity = matches / cols if cols else 0.0
    return float(identity), int(rstart), int(rstop)


class GlocalAligner:
    def name(self) -> str:
        return "Glocal"

    def align(self, q, r, pos=None) -> float:
        ident, rstart, rstop = glocal_align_np(
            np.asarray(q, np.uint8), np.asarray(r, np.uint8)
        )
        if pos is not None:
            pos[0], pos[1] = rstart, rstop
        return ident


class BandedIDAligner:
    def __init__(self, max_edits: int = 40):
        self.max_edits = max_edits

    def name(self) -> str:
        return "Banded"

    def align(self, q, r, pos=None) -> float:
        from .banded import banded_edits_np

        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        a, b = (q, r) if len(q) <= len(r) else (r, q)
        edits = banded_edits_np(a, b, self.max_edits, max_width=81)
        edits = min(edits, max(len(q), len(r)))
        if pos is not None:
            pos[0], pos[1] = 0, len(r) - 1
        return 1.0 - edits / max(len(q), len(r))

    def align_batch(self, q, qlen, r, rlen, device="cuda"):
        """Batched device path: [B, Lq] and [B, Lr] code arrays ->
        identity [B] (float64), the edit distance on `device`. The two
        arrays are padded to one width first (the JAX package's version
        needs Lq == Lr and raises otherwise)."""
        from .banded import align_pairs

        dev = torch.device(device)
        width = max(q.shape[1], r.shape[1])
        q, r = (torch.as_tensor(np.pad(x, ((0, 0), (0, width - x.shape[1]))), device=dev)
                for x in (np.asarray(q), np.asarray(r)))
        qlen = torch.as_tensor(np.asarray(qlen), device=dev)
        rlen = torch.as_tensor(np.asarray(rlen), device=dev)
        edits = align_pairs(q, qlen, r, rlen, self.max_edits, max_width=81)
        denom = torch.maximum(qlen, rlen).to(torch.float64)
        ident = 1.0 - torch.minimum(edits.to(torch.float64), denom) / denom
        return ident.cpu().numpy()


def make_id_aligner(name: str = "glocal"):
    """Factory.java analog (idaligner/Factory.java:30-38). EIGHT real
    engines with distinct cost models: glocal row-scan (exact), crosscut
    anti-diagonal (exact, traceback-free), quantum sparse active-set
    with teleporting deletions, wobble dynamic-width band, xdrop
    score-threshold window, drifting fixed-width band, wavefront
    edit-distance (WFA), banded global. Remaining research aliases
    (ssa2/ssa3/quabble/scrabble — same identity contract, CPU
    constant-factor variants) map to the engine of their family
    (tests/test_alignertools.py dominance evidence)."""
    name = name.lower()
    if name in ("glocal", "glocalplus", "ssa2", "ssa3", "parallelogram"):
        return GlocalAligner()
    if name in ("quantum", "quantumplus", "quabble"):
        return QuantumIDAligner()
    if name in ("wobble", "wobbleplus", "scrabble"):
        return WobbleIDAligner()
    if name in ("crosscut", "diagonal"):
        return CrossCutIDAligner()
    if name in ("xdrop", "xdroph"):
        return XDropIDAligner()
    if name in ("wave", "wavefront"):
        return WaveFrontIDAligner()
    if name in ("drifting", "driftingplus"):
        return DriftingIDAligner()
    if name in ("banded", "bandedplus"):
        return BandedIDAligner()
    raise ValueError(f"unknown aligner {name!r}")


#: the score of a cell no path can reach (a reference column past rlen)
NEG = -(1 << 29)


#: the packed carry of a cell: (matches << 42) | ((K + KOFF) << 21) | E,
#: K the path's columns less the cell's column j, E its entry column
KOFF = 1 << 20
FIELD = (1 << 21) - 1


def _glocal_scan(qs, qlens, rs, rlens, device):
    """The rows of the batched glocal DP. Returns, per task, the final
    row's best column jbest and (matches, columns, entry column) of the
    path that ends there, as int64 tensors [T] on `device`."""
    dev = torch.device(device)
    qs, rs = torch.as_tensor(qs, device=dev), torch.as_tensor(rs, device=dev)
    qlens = torch.as_tensor(qlens, device=dev).to(torch.int32)
    rlens = torch.as_tensor(rlens, device=dev).to(torch.int32)
    if dev.type == "cuda":
        glocal_identity.device_calls += 1
    T, M = qs.shape
    # rows at or under every qlen update every task; rows past the
    # longest update none; the output is taken at the rows that are a qlen
    qlen_set = set(qlens.tolist())
    q_min, q_max = min(qlen_set, default=0), max(qlen_set, default=0)
    N = rs.shape[1]
    # the packed key: ((G + 2^30) << b) | t, t < 2^b; G + 2^30 lies in
    # (0, 2^31), so the key fits in 63 bits
    b = max(1, N.bit_length())
    assert (1 << b) > N and b <= 32
    # the carry's fields: E <= N, 0 <= K + KOFF < 2^21 (-N <= K <= M)
    assert N < KOFF and M < KOFF
    tmask = (1 << b) - 1
    j_idx = torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    t_key = j_idx.to(torch.int64) + ((1 << 30) << b)
    # the carry of the row above: each cell's score and packed path
    # (row 0: no columns, the entry column j). Columns past rlen are
    # scored as if the reference went on: no path into a valid column
    # leaves one (the relaxation runs left to right), and the final row
    # masks them out before its argmax
    score = torch.zeros((T, N + 1), dtype=torch.int32, device=dev)
    j64 = j_idx.to(torch.int64)
    path = (((KOFF - j64) << 21) | j64).expand(T, N + 1)
    out = [score, path]  # the row i == qlen (row 0 for qlen 0)
    # per row, for each candidate column t: G[t], and the path into t
    # from the row above (a diagonal move keeps K and adds a match, an up
    # move adds a column; column 0 is the query-prefix gap, an up move)
    G = torch.empty((T, N + 1), dtype=torch.int32, device=dev)
    cand = torch.empty((T, N + 1), dtype=torch.int64, device=dev)
    for i in range(1, min(M, q_max) + 1):
        eq = rs == qs[:, i - 1:i]
        diag = torch.add(score[:, :-1] + SUB, eq, alpha=MATCH - SUB)
        up = score[:, 1:] + GAP
        use_diag = diag >= up
        torch.where(use_diag, torch.add(path[:, :-1], eq, alpha=1 << 42),
                    path[:, 1:] + (1 << 21), out=cand[:, 1:])
        cand[:, 0] = path[:, 0] + (1 << 21)
        # G[t] = best[t-1] - GAP*t; column 0 the query-prefix gap GAP*i
        G[:, 0] = GAP * i
        torch.sub(torch.maximum(diag, up), j_idx[:, 1:], alpha=GAP, out=G[:, 1:])
        # left relaxation: the prefix max of G, ties to the latest t; the
        # left gaps from t to j add as many columns as they move, so K
        # and the packed path are cand[t]'s
        key = torch.cummax(torch.add(t_key, G, alpha=1 << b), dim=1).values
        pt = key & tmask
        nrow = torch.add(torch.gather(G, 1, pt), j_idx, alpha=GAP)
        npath = torch.gather(cand, 1, pt)
        if i <= q_min:
            score, path = nrow, npath
        else:  # rows past a task's qlen leave its carry untouched
            active = (i <= qlens)[:, None]
            score = torch.where(active, nrow, score)
            path = torch.where(active, npath, path)
        if i in qlen_set:
            take = (i == qlens)[:, None]
            out = [torch.where(take, v, o) for v, o in zip((score, path), out)]
    fs, fpath = out
    row_ok = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                        j_idx[:, 1:] <= rlens[:, None]], 1)
    jbest = torch.argmax(torch.where(row_ok, fs, NEG), dim=1)  # the first column on ties
    p = torch.gather(fpath, 1, jbest[:, None])[:, 0]
    return jbest, p >> 42, ((p >> 21) & FIELD) - KOFF + jbest, p & FIELD


def glocal_identity(qs, qlens, rs, rlens, device="cuda"):
    """Batched glocal aligner on `device`: (identity f32, rstart, rstop)
    int32 tensors [T].

    Same recurrences and tie rules as glocal_align_np and the JAX
    package's glocal_identity_jnp: each query row is a fixed set of torch
    ops on [T, N+1] int32 tensors. The sequential left-gap relaxation
        row[j] = max(best[j-1], row[j-1] + GAP)
    is the prefix maximum of G[t] = best[t-1] - GAP*t with ties to the
    latest t, a `torch.cummax` over the packed int64 key ((G + 2^30) << b)
    | t: its maximum is the largest G, and among equal G the largest t, by
    value alone (cummax's own tie index is not used). (matches, columns,
    entry column) are gathered at that t, so the final cell reads them
    out without a traceback. qs [T, M] and rs [T, N] code arrays, qlens
    and rlens [T]; numpy arrays or tensors.
    """
    jbest, matches, cols, rstart = _glocal_scan(qs, qlens, rs, rlens, device)
    ident = matches.to(torch.float32) / torch.clamp(cols, min=1).to(torch.float32)
    return ident, rstart.to(torch.int32), (jbest - 1).to(torch.int32)


#: calls on CUDA tensors since the count was last set to 0
glocal_identity.device_calls = 0


def glocal_counts(qs, qlens, rs, rlens, device="cuda"):
    """glocal_identity's (matches, columns, rstart, rstop) as int64
    tensors [T]: matches / columns in float64 is glocal_align_np's
    identity, and rstart, rstop its coordinates."""
    jbest, matches, cols, rstart = _glocal_scan(qs, qlens, rs, rlens, device)
    return matches, cols, rstart, jbest - 1


def wavefront_edits_np(q: np.ndarray, r: np.ndarray,
                       max_edits: int | None = None) -> int:
    """WFA-style exact edit distance, O(n*s): furthest-reaching points
    per diagonal per edit count (idaligner/WaveFrontAligner.java role).
    Returns the exact Levenshtein distance (or max_edits+1 if capped)."""
    m, n = len(q), len(r)
    if m == 0 or n == 0:
        return max(m, n)
    cap = max(m, n) if max_edits is None else max_edits
    target = n - m  # diagonal of the end cell
    # fr[d] = furthest row i reached on diagonal (j - i) = d
    offs = m + n + 1
    fr = np.full(2 * offs, -1, np.int64)

    def extend(d, i):
        j = i + d
        while i < m and j < n and q[i] == r[j]:
            i += 1
            j += 1
        return i

    fr[offs + 0] = extend(0, 0)
    if fr[offs] >= m and target == 0:
        return 0
    lo = hi = 0
    for s in range(1, cap + 1):
        lo -= 1
        hi += 1
        new = np.full_like(fr, -1)
        for d in range(lo, hi + 1):
            # ins (from d-1), del (from d+1), sub (from d)
            best = -1
            v = fr[offs + d]  # sub
            if v >= 0:
                best = v + 1
            v = fr[offs + d - 1]  # deletion in q? (j advanced)
            if v >= 0 and v > best:
                best = v
            v = fr[offs + d + 1]
            if v >= 0 and v + 1 > best:
                best = v + 1
            if best < 0:
                continue
            i = min(best, m)
            if i + d > n:
                continue
            new[offs + d] = extend(d, i)
        fr = new
        if lo <= target <= hi and fr[offs + target] >= m:
            return s
    return cap + 1


class WaveFrontIDAligner:
    """Exact edit-distance identity via the wavefront recurrence."""

    def name(self) -> str:
        return "WaveFront"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        e = wavefront_edits_np(q, r)
        if pos is not None:
            pos[0], pos[1] = 0, len(r) - 1
        return 1.0 - e / max(len(q), len(r), 1)


class DriftingIDAligner:
    """Banded DP whose band center drifts toward the best-SCORING cell
    of each row (idaligner/DriftingAligner.java:124-138: drift =
    mid(-1, maxPos - center, maxDrift), center += 1 + drift). The drift
    follows a match-score surface (match +1, sub -1, gap -2) — an
    edit-count surface separates diagonals too slowly to steer — while
    an edit band rides along to report identity."""

    def __init__(self, width: int = 21, max_drift: int = 8):
        self.width = width | 1
        self.max_drift = max_drift

    def name(self) -> str:
        return "Drifting"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        m, n = len(q), len(r)
        if m == 0 or n == 0:
            return 0.0
        w = self.width
        half = w // 2
        BIGE = 1 << 30
        NEGS = -(1 << 30)
        center = 0
        js_prev = np.arange(-half, half + 1)
        ed_prev = np.where((js_prev >= 0) & (js_prev <= n),
                           np.abs(js_prev), BIGE)
        sc_prev = np.where((js_prev >= 0) & (js_prev <= n),
                           GAP * np.abs(js_prev), NEGS)
        for i in range(1, m + 1):
            best_t = w - 1 - int(np.argmax(sc_prev[::-1]))
            drift = min(max(-1, best_t - half), self.max_drift)
            center = int(np.clip(center + 1 + drift, 0, n))
            js = np.arange(-half, half + 1) + center
            ed = np.full(w, BIGE, np.int64)
            sc = np.full(w, NEGS, np.int64)
            shift = center - (int(js_prev[0]) + half)  # prev center
            for t in range(w):
                j = int(js[t])
                if j < 0 or j > n:
                    continue
                e_best, s_best = (i, GAP * i) if j == 0 else (BIGE, NEGS)
                pt = t + shift - 1  # prev-band index of column j-1
                if j >= 1 and 0 <= pt < w and ed_prev[pt] < BIGE:
                    mm = 0 if q[i - 1] == r[j - 1] else 1
                    e = ed_prev[pt] + mm
                    sv = sc_prev[pt] + (MATCH if mm == 0 else SUB)
                    if sv > s_best:
                        s_best = sv
                    if e < e_best:
                        e_best = e
                pt = t + shift  # prev-band index of column j
                if 0 <= pt < w and ed_prev[pt] < BIGE:
                    if ed_prev[pt] + 1 < e_best:
                        e_best = ed_prev[pt] + 1
                    if sc_prev[pt] + GAP > s_best:
                        s_best = sc_prev[pt] + GAP
                if t >= 1 and ed[t - 1] < BIGE:
                    if ed[t - 1] + 1 < e_best:
                        e_best = ed[t - 1] + 1
                    if sc[t - 1] + GAP > s_best:
                        s_best = sc[t - 1] + GAP
                ed[t] = e_best
                sc[t] = s_best
            ed_prev, sc_prev, js_prev = ed, sc, js
        pt = n - (center - half)
        e = int(ed_prev[pt]) if 0 <= pt < w and ed_prev[pt] < BIGE else max(m, n)
        if pos is not None:
            pos[0], pos[1] = 0, n - 1
        return 1.0 - min(e, max(m, n)) / max(m, n, 1)


# ---------------------------------------------------------------------------
# CrossCut: anti-diagonal exact glocal, traceback-free identity
# ---------------------------------------------------------------------------

_CC_BIAS = np.int64(1) << 20  # score bias so packed max works unsigned


def _cc_pack(score, rstart, dels):
    # dels stored COMPLEMENTED so the packed max prefers FEWER deletions
    # on score ties (fewer columns -> higher identity when score > 0)
    return (
        ((np.int64(score) + _CC_BIAS) << 42)
        | (np.int64(rstart) << 21)
        | (np.int64(0x1FFFFF) - np.int64(dels))
    )


def _cc_unpack_identity(best, m, pos, best_j):
    score = int(best >> 42) - int(_CC_BIAS)
    rstart = int((best >> 21) & 0x1FFFFF)
    dels = 0x1FFFFF - int(best & 0x1FFFFF)
    matches = (score + dels + m) // 2
    cols = m + dels
    if pos is not None:
        pos[0], pos[1] = rstart, best_j - 1
    return matches / max(cols, 1)


_GAPP = (np.int64(GAP) << 42)  # packed gap step (score field)
_DELP = _GAPP - 1  # deletion: gap + (complemented) dels decrement
_NEGP = np.int64(-1)  # impossible cell (all valid packs are >= 0)


class CrossCutIDAligner:
    """Anti-diagonal ("cross-cut") exact glocal aligner
    (idaligner/CrossCutAligner.java): iterate diagonals d = i+j so every
    cell on a diagonal is independent — the dependency-free order that
    vectorizes (the same wavefront the Pallas MSA kernel uses). Identity
    needs NO traceback: each cell packs (score | rstart | deletions) in
    one int64 and, with the query consumed globally,
      columns = qlen + D,  M = (score + D + qlen) / 2  (unit scores),
    so identity falls out of the winning cell alone — CrossCutAligner's
    three-plane packing collapsed to one int64."""

    def name(self) -> str:
        return "CrossCut"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        m, n = len(q), len(r)
        if m == 0 or n == 0:
            return 0.0
        # buffers indexed by i; cell (i, j = d - i)
        prev2 = np.full(m + 1, _NEGP, np.int64)  # diagonal d-2
        prev = np.full(m + 1, _NEGP, np.int64)  # diagonal d-1
        prev2[0] = _cc_pack(0, 0, 0)  # (0, 0)
        prev[0] = _cc_pack(0, 1, 0)  # (0, 1) free ref prefix
        if m >= 1:
            prev[1] = _cc_pack(GAP, 0, 0)  # (1, 0) query gap
        best = prev2[0] if m == 0 else _NEGP
        best_j = 0
        if m >= 1 and 1 <= n + 0:
            pass
        if m == 1:
            # diagonal 1 already holds row m cells
            if prev[1] > best:
                best, best_j = prev[1], 0
        for d in range(2, m + n + 1):
            lo = max(0, d - n)
            hi = min(m, d)
            cur = np.full(m + 1, _NEGP, np.int64)
            ivec = np.arange(lo, hi + 1)
            # left neighbor (i, j-1) -> prev[i]; invalid when j-1 < 0
            left = prev[lo : hi + 1]
            cand = np.where(left >= 0, left + _DELP, _NEGP)
            # up neighbor (i-1, j) -> prev[i-1]; needs i >= 1
            iu = np.maximum(ivec - 1, 0)
            up = prev[iu]
            cu = np.where((ivec >= 1) & (up >= 0), up + _GAPP, _NEGP)
            cand = np.maximum(cand, cu)
            # diagonal (i-1, j-1) -> prev2[i-1]; needs i >= 1 and j >= 1
            dg = prev2[iu]
            jvec = d - ivec
            okd = (ivec >= 1) & (jvec >= 1) & (dg >= 0)
            qi = q[np.clip(ivec - 1, 0, m - 1)]
            rj = r[np.clip(jvec - 1, 0, n - 1)]
            ss = np.where(qi == rj, np.int64(MATCH), np.int64(SUB))
            cd = np.where(okd, dg + (ss << 42), _NEGP)
            cand = np.maximum(cand, cd)
            # boundary cells
            if lo == 0:  # (0, d): free ref prefix start
                cand[0] = _cc_pack(0, d, 0)
            if hi == d:  # (d, 0): query-prefix gaps
                cand[-1] = _cc_pack(GAP * d, 0, 0)
            cur[lo : hi + 1] = cand
            # row i = m joins the free-ref-suffix maximum
            if d >= m and cur[m] > best:
                best, best_j = cur[m], d - m
            prev2, prev = prev, cur
        if best < 0:
            return 0.0
        return _cc_unpack_identity(best, m, pos, best_j)


class XDropIDAligner:
    """X-drop glocal (idaligner/XDropHAligner.java role): per row, only
    columns whose score stays within X of the row maximum remain active;
    the window shrinks on clean data (decideBandwidth's leading-subs
    probe seeds it, XDropHAligner.decideBandwidth) and widens under
    divergence — adaptive work instead of the full matrix. Identity is
    traceback-free via the CrossCut packing. Heuristic by design:
    pruning can clip the true optimum on adversarial inputs."""

    def __init__(self, xdrop: int = 24):
        self.xdrop = xdrop

    def name(self) -> str:
        return "XDrop"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        m, n = len(q), len(r)
        if m == 0 or n == 0:
            return 0.0
        # decideBandwidth probe (leading mismatch count, capped)
        bw = min(m // 4 + 2, max(m, n) // 32, 12)
        bw = max(2, bw) + 3
        ml = min(m, n)
        mism = np.cumsum(q[:ml] != r[:ml])
        subs = int(np.searchsorted(mism, bw))
        X = np.int64(self.xdrop + 2 * min(subs + 1, bw))
        row = _cc_pack(
            np.zeros(n + 1, np.int64),
            np.arange(n + 1, dtype=np.int64),
            np.zeros(n + 1, np.int64),
        )  # row 0: free ref start
        lo, hi = 0, n
        tvec_full = np.arange(n + 1, dtype=np.int64)
        for i in range(1, m + 1):
            nlo = max(lo - 1, 0)
            nhi = min(hi + 1, n)
            width = nhi - nlo + 1
            cols = tvec_full[nlo : nhi + 1]
            up = row[nlo : nhi + 1]
            cand = np.where(up >= 0, up + _GAPP, _NEGP)
            dlo = max(nlo, 1)
            if dlo <= nhi:
                dg = row[dlo - 1 : nhi]
                ss = np.where(
                    q[i - 1] == r[dlo - 1 : nhi],
                    np.int64(MATCH), np.int64(SUB),
                )
                cd = np.where(dg >= 0, dg + (ss << 42), _NEGP)
                off = dlo - nlo
                cand[off:] = np.maximum(cand[off:], cd)
            if nlo == 0:
                cand[0] = max(cand[0], _cc_pack(GAP * i, 0, 0))
            # left (deletion) relaxation as a decayed prefix-max:
            # c'[t] = max_{t'<=t} cand[t'] + (t-t')*DELP
            t_idx = np.arange(width, dtype=np.int64)
            sent = np.int64(-(1 << 62))
            shifted = np.where(cand >= 0, cand - t_idx * _DELP, sent)
            relax = np.maximum.accumulate(shifted) + t_idx * _DELP
            any_valid = np.maximum.accumulate(
                (cand >= 0).astype(np.int8)
            ).astype(bool)
            cand = np.maximum(cand, np.where(any_valid, relax, _NEGP))
            # x-drop prune on the score field
            scores = np.where(cand >= 0, cand >> 42, np.int64(-(1 << 40)))
            rb = scores.max()
            alive = np.flatnonzero(scores >= rb - X)
            if len(alive) == 0:
                return 0.0
            row = np.full(n + 1, _NEGP, np.int64)
            a0, a1 = int(alive[0]), int(alive[-1])
            row[nlo + a0 : nlo + a1 + 1] = cand[a0 : a1 + 1]
            lo, hi = nlo + a0, nlo + a1
        best_j = int(np.argmax(row))
        best = row[best_j]
        if best < 0:
            return 0.0
        return _cc_unpack_identity(best, m, pos, best_j)


class QuantumIDAligner:
    """Sparse active-set glocal aligner (idaligner/QuantumAligner.java
    role: "sparse matrix traversal with quantum teleportation" — jumps
    between high-scoring regions across unexplored gaps, traceback-free
    bit-packed cells, adaptive bandwidth). The TPU-repo re-design keeps
    the three defining ideas and drops the Java pointer machinery:

      - ACTIVE SET: each row evaluates only a sorted set of live
        columns; cells outside it do not exist (QuantumAligner's
        activeList/nextList "rapids").
      - TELEPORTATION: the deletion recurrence is a DECAYED PREFIX-MAX
        over the active columns at their true coordinates — a chain of
        deletions across an unexplored gap costs GAP*(distance) without
        materializing the gap's cells, which is exactly the "bridge
        across long deletions" the reference builds explicitly
        (QuantumAligner.java BUILD_BRIDGES / insPad).
      - SCORE-WIDTH PRUNE + BRIDGE EXTEND: columns whose score falls
        more than scoreWidth below the row best die; the frontier
        extends right a few columns per row (more on mismatch rows —
        the reference's bridgeTime race).

    Identity needs no traceback: cells pack (score | rstart | dels) in
    one int64 (the CrossCut packing; QuantumAligner packs position and
    deletion count in the low bits the same way)."""

    BRIDGE_PERIOD = 16

    def name(self) -> str:
        return "Quantum"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        if pos is None and len(q) > len(r):  # reference swap rule
            q, r = r, q
        m, n = len(q), len(r)
        if m == 0 or n == 0:
            return 0.0
        # adaptive bandwidth (QuantumAligner.decideBandwidth shape:
        # narrow for clean data, floor for tiny inputs)
        mx = max(m, n)
        bw = min(m // 4 + 2, max(mx // 32, 2),
                 int(np.log2(mx + 256)) + 2)
        bw = max(2, bw) + 3
        ml = min(m, n)
        lead_mm = int(np.cumsum(q[:ml] != r[:ml]).searchsorted(bw))
        bw += min(bw, max(0, 8 - lead_mm // 4))
        score_width = np.int64(2 * bw + 2)
        top_width = min(m, 2 * bw)
        # row 0: every column is a free glocal start -> all active
        act = np.arange(n + 1, dtype=np.int64)
        prev = _cc_pack(np.zeros(n + 1, np.int64), act,
                        np.zeros(n + 1, np.int64))
        best, best_j = (_NEGP, 0)
        best_col = 0  # maxPos: previous row's best-scoring column
        for i in range(1, m + 1):
            # frontier extension (bridge race): when the best path's next
            # base MISmatches (q[i-1] != ref[maxPos], the reference's
            # nextMatch test) a deletion may have started — build a
            # contiguous bridge AHEAD OF THE BEST CELL so the teleporting
            # deletion chain has somewhere to land the same row it is
            # priced (QuantumAligner.java BUILD_BRIDGES, made
            # best-anchored instead of frontier-anchored)
            last = int(act[-1])
            nm = q[i - 1] == r[min(n - 1, best_col)]
            if not nm and best_col < n:
                span = np.arange(best_col + 1,
                                 min(best_col + max(35, 8 * bw), n) + 1,
                                 dtype=np.int64)
                merged = np.union1d(act, span)
                if len(merged) > len(act):
                    pv = np.full(len(merged), _NEGP, np.int64)
                    pv[np.searchsorted(merged, act)] = prev
                    act, prev = merged, pv
                    last = int(act[-1])
            if last < n:  # frontier drift (rightExtend)
                grow = np.arange(last + 1, min(last + 2, n) + 1,
                                 dtype=np.int64)
                act = np.concatenate([act, grow])
                prev = np.concatenate(
                    [prev, np.full(len(grow), _NEGP, np.int64)])
            # always keep column 0 (query-prefix gaps) alive
            if act[0] != 0:
                act = np.concatenate([[np.int64(0)], act])
                prev = np.concatenate([[_NEGP], prev])
            # diagonal/up neighbors live at the SAME active slots when
            # the previous column (j-1) is active; map via searchsorted
            jm1 = act - 1
            slot = np.searchsorted(act, jm1)
            slot_ok = (jm1 >= 0) & (slot < len(act)) & (act[np.minimum(
                slot, len(act) - 1)] == jm1)
            pv_dg = np.where(slot_ok, prev[np.minimum(slot, len(act) - 1)],
                             _NEGP)
            ss = np.where(q[i - 1] == r[np.clip(act - 1, 0, n - 1)],
                          np.int64(MATCH), np.int64(SUB))
            cand = np.where((pv_dg >= 0) & (act >= 1),
                            pv_dg + (ss << 42), _NEGP)
            up = np.where(prev >= 0, prev + _GAPP, _NEGP)  # insertion
            cand = np.maximum(cand, up)
            cand[0] = max(cand[0], _cc_pack(GAP * i, 0, 0))
            # teleporting deletion chain: decayed prefix-max at true
            # column coordinates (distance-priced jumps over dead gaps)
            sent = np.int64(-(1 << 62))
            shifted = np.where(cand >= 0, cand - act * _DELP, sent)
            relax = np.maximum.accumulate(shifted) + act * _DELP
            ok = np.maximum.accumulate((cand >= 0).astype(np.int8)) > 0
            cand = np.maximum(cand, np.where(ok, relax, _NEGP))
            # prune on the score plane (looser near the top band, like
            # scoreWidth0 + MATCH*(topWidth - i))
            scr = np.where(cand >= 0, cand >> 42, np.int64(-(1 << 40)))
            width = score_width + np.int64(MATCH) * max(0, top_width - i)
            keep = scr >= scr.max() - width
            # EXTEND_MATCH (QuantumAligner.java `live`): cells sitting on
            # a base match survive below the score window — this is what
            # lets a freshly-bridged landing cell climb back after paying
            # a long-deletion toll instead of dying to the prune
            match_live = (act >= 1) & (ss == np.int64(MATCH)) & (cand >= 0)
            keep |= match_live
            keep[0] = True
            best_col = int(act[int(np.argmax(scr))])
            if i == m:
                t = int(np.argmax(cand))
                best, best_j = cand[t], int(act[t])
                break
            # a surviving match cell must also ACTIVATE its diagonal
            # successor (the reference's `live` adds j+1 to nextList) or
            # the climbing chain is computed once and never extended
            kept_act = act[keep]
            succ = act[match_live] + 1
            succ = succ[succ <= n]
            new_act = np.union1d(kept_act, succ)
            pv = np.full(len(new_act), _NEGP, np.int64)
            pv[np.searchsorted(new_act, kept_act)] = cand[keep]
            act, prev = new_act, pv
        if best < 0:
            return 0.0
        return _cc_unpack_identity(best, m, pos, best_j)


class WobbleIDAligner:
    """Dynamic-bandwidth drifting band (idaligner/WobbleAligner.java:
    "band starts wide and narrows to allow glocal alignments; band
    dynamically widens and narrows in response to sequence identity;
    center drifts toward highest score"). Distinct cost model from
    Drifting (fixed width) and XDrop (score-threshold set): Wobble's
    work per row is a contiguous band whose WIDTH is the control
    variable — it decays geometrically on clean rows and doubles when
    the row optimum presses the band edge. Identity is traceback-free
    via the packed-cell scheme."""

    def __init__(self, min_width: int = 9, max_width: int = 513):
        self.min_width = min_width
        self.max_width = max_width

    def name(self) -> str:
        return "Wobble"

    def align(self, q, r, pos=None) -> float:
        q = np.asarray(q, np.uint8)
        r = np.asarray(r, np.uint8)
        m, n = len(q), len(r)
        if m == 0 or n == 0:
            return 0.0
        # start wide (glocal entry: whole row 0 is free), then narrow
        lo, hi = 0, n
        row = _cc_pack(np.zeros(n + 1, np.int64),
                       np.arange(n + 1, dtype=np.int64),
                       np.zeros(n + 1, np.int64))
        width = hi - lo + 1
        center = 0
        sent = np.int64(-(1 << 62))
        best, best_j = _NEGP, 0
        prev_rb = 0
        for i in range(1, m + 1):
            # band placement: follow last row's best, advance one diagonal
            nlo = max(0, min(center + 1 - width // 2, n - width + 1))
            nhi = min(n, nlo + width - 1)
            nlo = max(0, nhi - width + 1)
            cols = np.arange(nlo, nhi + 1, dtype=np.int64)
            w = len(cols)
            # neighbors from the previous dense-band row
            def at(j):
                v = np.full(w, _NEGP, np.int64)
                sel = (j >= lo) & (j <= hi)
                v[sel] = row[j[sel] - lo]
                return v
            pv_dg = at(cols - 1)
            ss = np.where(q[i - 1] == r[np.clip(cols - 1, 0, n - 1)],
                          np.int64(MATCH), np.int64(SUB))
            cand = np.where((pv_dg >= 0) & (cols >= 1),
                            pv_dg + (ss << 42), _NEGP)
            up = at(cols)
            cand = np.maximum(cand,
                              np.where(up >= 0, up + _GAPP, _NEGP))
            if nlo == 0:
                cand[0] = max(cand[0], _cc_pack(GAP * i, 0, 0))
            shifted = np.where(cand >= 0, cand - cols * _DELP, sent)
            relax = np.maximum.accumulate(shifted) + cols * _DELP
            ok = np.maximum.accumulate((cand >= 0).astype(np.int8)) > 0
            cand = np.maximum(cand, np.where(ok, relax, _NEGP))
            # wobble: widen when the optimum presses an edge OR the row
            # best stops climbing (identity dropped — a gap or divergent
            # region needs more band); narrow geometrically on clean rows
            scr_t = np.where(cand >= 0, cand >> 42, np.int64(-(1 << 40)))
            t = int(np.argmax(scr_t))
            center = int(cols[t])
            rb = int(scr_t[t])
            stalled = rb < prev_rb + MATCH
            prev_rb = rb
            if t <= 1 or t >= w - 2 or stalled:
                width = min(self.max_width, width * 2, n + 1)
            else:
                width = max(self.min_width, width - max(1, width // 8))
            row, lo, hi = cand, nlo, nhi
            if i == m:
                best, best_j = cand[t], center
        if best < 0:
            return 0.0
        return _cc_unpack_identity(best, m, pos, best_j)
