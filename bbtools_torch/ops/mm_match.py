"""Hamming-ball k-mer matcher: hdist-tolerant set lookup as a one-hot
product (the BBDuk backend for expansion-heavy panels, hdist >= 2).

The counterpart of bbtools_tpu/ops/mm_match.py, whose docstring gives
the construction in full. In short: a key is a one-hot vector over its k
2-bit fields, so for same-length keys the dot product of two one-hots
counts equal fields, and hamming(q, x) <= h iff the dot is >= k - h.
Each RAW reference key is one column (two with rcomp: the forward form
and its reverse complement) of an int8 key matrix [Kp, Dp]; per-class
indicator channels of weight CLASS_W keep mink short-kmer classes apart,
and a constant query dim folds the threshold in, so a query matches a
column iff the product is >= 0. The min over matching columns of the
priority word (insertion_rank << 16) | id gives the first-inserted id,
the reference's setIfNotPresent result, with no expansion of the panel.

The host build (`MMKmerIndex.build`, `lookup_np`) is a copy of the JAX
package's. `mm_lookup` is the kernel wrapper: a CPU tensor runs
`mm_lookup_plain` (the JAX package's `_mm_xla`: a chunked bf16 product,
exact because every term and partial sum is an integer below 2**8 in
magnitude), a CUDA tensor launches the kernel of csrc/mm_match.cu (the
counterpart of the TPU's `_mm_kernel`), anything else raises. `mm_best`
is the same kernel with an epilogue that writes each query's best
priority word undecoded (plain twin `mm_best_plain`), the part a
column-sharded matcher combines by a min.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .kmers import length_mask, rc_kmer_np

LANES = 128
CLASS_W = 64  # class-channel weight; > max cross-class dot (k)
BIG32 = np.int32(0x7FFFFFFF)
DT = 512  # the column padding unit of the key matrix


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _field_onehot_np(vals: np.ndarray, k: int) -> np.ndarray:
    """[n, 4k] one-hot of the k 2-bit fields of int64 keys (LSB first)."""
    n = len(vals)
    shifts = (2 * np.arange(k, dtype=np.int64))[None, :]
    codes = (vals[:, None] >> shifts) & 3  # [n, k]
    oh = codes[:, :, None] == np.arange(4, dtype=np.int64)[None, None, :]
    return oh.reshape(n, 4 * k).astype(np.int8)


def _canonical_realizable_np(y: np.ndarray, k: int, mid_mask: int) -> np.ndarray:
    """For masked patterns y (masked fields zero): is y the masked image
    of at least one canonical full key? Tries every masked-field variant
    Q of y and tests Q >= rc(Q)."""
    free = [i for i in range(k) if (mid_mask >> (2 * i)) & 3 != 3]
    variants = [y]
    for pos in free:
        variants = [
            v | (np.int64(c) << int(2 * pos)) for v in variants for c in range(4)
        ]
    ok = np.zeros(y.shape, bool)
    for v in variants:
        ok |= v >= rc_kmer_np(v, k)
    return ok


def _masked_safety(fwd: np.ndarray, k: int, hdist: int, mid_mask: int) -> bool:
    """True iff for every raw full-k key x, the set of canonical masked
    queries accepted by the two-column ball test is contained in the
    reference expansion (no false positive possible). Only called when a
    middle mask is active and rcomp is on; supports hdist <= 1."""
    from .kmer_index import expand_kmers

    if hdist > 1:
        return False
    n = len(fwd)
    if n == 0:
        return True
    mm = np.int64(mid_mask)
    tag = np.int64(length_mask(k))
    unmasked = [i for i in range(k) if (mid_mask >> (2 * i)) & 3 == 3]
    exp, src = expand_kmers(fwd, k, hdist, mid_mask)
    exp = exp & ~tag
    for base in (fwd, rc_kmer_np(fwd, k)):
        cand = [base & mm]
        if hdist >= 1:
            for i in unmasked:
                for c in range(4):
                    v = (base & ~(np.int64(3) << (2 * i))) | (
                        np.int64(c) << (2 * i)
                    )
                    cand.append(v & mm)
        cand = np.stack(cand, axis=1)  # [n, V]
        V = cand.shape[1]
        realizable = _canonical_realizable_np(
            cand.reshape(-1), k, mid_mask
        ).reshape(n, V)
        for b in range(n):
            ref = set((exp[src == b]).tolist())
            mine = set(cand[b][realizable[b]].tolist())
            if not mine <= ref:
                return False
    return True


@dataclass
class MMKmerIndex:
    """One-hot product matcher; see module docstring.

    keymat  int8 [Kp, Dp]  column = key one-hot + class W + (-thr) const
    prio    int32 [1, Dp]  (insertion_rank << 16) | id ; BIG for pad cols
    """

    keymat: np.ndarray
    prio: np.ndarray
    k: int
    mink: int
    Kp: int
    Dp: int
    n_raw: int

    #: above this column count the matmul loses to the gather index
    MAX_COLS = 32768

    @staticmethod
    def build(
        scaffolds: list[np.ndarray],
        k: int,
        mink: int = 0,
        hdist: int = 0,
        hdist2: int | None = None,
        mid_mask: int = -1,
        rcomp: bool = True,
        ids: list[int] | None = None,
    ) -> "MMKmerIndex | None":
        """Raw-key column build in reference insertion order. Returns
        None when the config or panel shape is unsupported (callers use
        the gather index)."""
        from .kmer_index import scaffold_kmer_stream

        if hdist2 is None:
            hdist2 = hdist
        if k > 31:
            return None
        # insertion-order raw streams, all classes interleaved as the
        # loader inserts them (scaffold-major; class collisions are
        # impossible so only within-class order matters, but global
        # order is kept anyway)
        ent_len: list[int] = []
        ent_fwd: list[int] = []
        ent_id: list[int] = []
        for snum, codes in enumerate(scaffolds):
            sid = ids[snum] if ids is not None else snum + 1
            if sid <= 0 or sid >= (1 << 16):
                return None
            fwd, _rkm, s_first, s_last, _extras = scaffold_kmer_stream(
                codes, k, mink
            )
            ent_len.extend([k] * len(fwd))
            ent_fwd.extend(int(x) for x in fwd)
            ent_id.extend([sid] * len(fwd))
            for km, _rk, ln, _eb in s_first + s_last:
                ent_len.append(ln)
                ent_fwd.append(int(km))
                ent_id.append(sid)
        if not ent_fwd:
            return None
        lens = np.asarray(ent_len, np.int64)
        fwds = np.asarray(ent_fwd, np.int64)
        sids = np.asarray(ent_id, np.int32)
        # first-wins dedup of identical (len, fwd) raw keys
        pairs = np.stack([lens, fwds], axis=1)
        _, first = np.unique(pairs, axis=0, return_index=True)
        keep = np.sort(first)
        lens, fwds, sids = lens[keep], fwds[keep], sids[keep]
        n_raw = len(fwds)
        # strict <, so the max priority word (rank<<16 | id) stays below
        # the BIG32 miss sentinel even at rank 2*n_raw-1, id 0xFFFF
        if 2 * n_raw >= MMKmerIndex.MAX_COLS:
            return None
        # masked-safety gate (full-k class only; shorts carry no mask)
        has_mask = mid_mask != -1 and any(
            (mid_mask >> (2 * i)) & 3 != 3 for i in range(k)
        )
        if has_mask and rcomp:
            if not _masked_safety(fwds[lens == k], k, hdist, mid_mask):
                return None
        nc = (k - mink + 1) if mink and mink < k else 1
        dims = 4 * k + nc + 1
        Kp = ((dims + LANES - 1) // LANES) * LANES
        thr = k + CLASS_W  # minus per-class hdist below
        if thr > 127:
            return None
        cols_oh: list[np.ndarray] = []
        cols_cls: list[np.ndarray] = []
        cols_thr: list[np.ndarray] = []
        cols_prio: list[np.ndarray] = []
        mmv = np.int64(mid_mask)
        for ln in sorted(set(lens.tolist())):
            sel = np.nonzero(lens == ln)[0]
            x = fwds[sel]
            h = hdist if ln == k else hdist2
            msk = mmv if ln == k else np.int64(-1)
            # short keys keep their length-tag bit as a regular field so
            # an exact same-class match scores k field-equalities: bases
            # 0..ln-1, the tag field at ln, zeros above (never mutated)
            tagv = np.int64(0 if ln == k else length_mask(int(ln)))
            forms = [(x & msk) | tagv]
            if rcomp:
                forms.append((rc_kmer_np(x, int(ln)) & msk) | tagv)
            ci = int(ln) - mink if (mink and mink < k) else 0
            for fi, form in enumerate(forms):
                cols_oh.append(_field_onehot_np(form, k))
                cls = np.zeros((len(sel), nc), np.int8)
                cls[:, ci] = CLASS_W
                cols_cls.append(cls)
                cols_thr.append(np.full(len(sel), -(thr - h), np.int32))
                cols_prio.append(
                    ((sel.astype(np.int64) * 2 + fi) << 16)
                    | sids[sel].astype(np.int64)
                )
        oh = np.concatenate(cols_oh, axis=0)
        cls = np.concatenate(cols_cls, axis=0)
        thrv = np.concatenate(cols_thr, axis=0)
        prio = np.concatenate(cols_prio, axis=0)
        colmat = np.concatenate(
            [oh, cls, thrv[:, None].astype(np.int8)], axis=1
        )  # [D, dims]
        D = colmat.shape[0]
        # keep insertion order along columns (priority already encodes
        # it; ordering is for locality and debuggability)
        order = np.argsort(prio, kind="stable")
        dt = DT if D > DT else LANES
        Dp = ((D + dt - 1) // dt) * dt
        keymat = np.zeros((Kp, Dp), np.int8)
        keymat[:dims, :D] = colmat[order].T
        # pad columns: all-zero weights with const dim -1 -> s < 0, never hit
        keymat[4 * k + nc, D:] = -1
        prio_row = np.full((1, Dp), BIG32, np.int32)
        prio_row[0, :D] = prio[order].astype(np.int32)
        return MMKmerIndex(keymat, prio_row, k, mink, Kp, Dp, n_raw)

    @staticmethod
    def from_arrays(keymat, prio, k: int, mink: int,
                    n_raw: int) -> "MMKmerIndex":
        """An index over arrays built elsewhere (the JAX package's
        MMKmerIndex fields), so both packages can share one key matrix."""
        keymat = np.ascontiguousarray(keymat, dtype=np.int8)
        prio = np.ascontiguousarray(prio, dtype=np.int32)
        Kp, Dp = keymat.shape
        if prio.shape != (1, Dp):
            raise ValueError(f"key matrix {keymat.shape} and prio {prio.shape}")
        return MMKmerIndex(keymat, prio, int(k), int(mink), Kp, Dp, int(n_raw))

    def device_arrays(self, device):
        """(key words, prio) on `device`. The key words are the key matrix
        column-major, column c's Kp bytes as Kp/4 int32 words [Dp, Kp/4]:
        the kernel stages a column as one contiguous run, and the plain
        version reads them back through an int8 view. prio is [1, Dp]."""
        words = np.ascontiguousarray(self.keymat.T).view(np.int32)
        return (torch.from_numpy(words).to(device),
                torch.from_numpy(self.prio).to(device))

    def static_params(self):
        return (self.k, self.mink, self.Kp, self.Dp)

    # ------------------------------------------------------------------
    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        """Host oracle (small inputs/tests)."""
        q = np.asarray(query, np.int64).reshape(-1)
        oh = _query_onehot_np(q, self.k, self.mink, self.Kp)
        s = oh.astype(np.int32) @ self.keymat.astype(np.int32)
        pr = np.where(s >= 0, self.prio, BIG32)
        best = pr.min(axis=1)
        out = np.where(best != BIG32, best & 0xFFFF, 0).astype(np.int32)
        return out.reshape(np.asarray(query).shape)


def _query_onehot_np(q: np.ndarray, k: int, mink: int, Kp: int) -> np.ndarray:
    n = len(q)
    oh = _field_onehot_np(q & ((np.int64(1) << (2 * k)) - 1), k)
    nc = (k - mink + 1) if mink and mink < k else 1
    cls = np.zeros((n, nc), np.int8)
    if nc > 1:
        for ci in range(nc):
            cls[:, ci] = (q >> (2 * (mink + ci))) == 1
    else:
        cls[:, 0] = 1
    out = np.zeros((n, Kp), np.int8)
    out[:, : 4 * k] = oh
    out[:, 4 * k : 4 * k + nc] = cls
    out[:, 4 * k + nc] = 1
    return out


# ---------------------------------------------------------------------------
# device lookup
# ---------------------------------------------------------------------------


def _n_classes(k: int, mink: int) -> int:
    return (k - mink + 1) if mink and mink < k else 1


def query_onehot(q, k: int, mink: int, Kp: int):
    """[N, Kp] int8 one-hot of int64 keys q [N] (the JAX package's
    `_query_onehot_jnp`): k fields of 4 dims, the class channels, the
    constant-one dim, zero pad."""
    n = q.shape[0]
    dev = q.device
    shifts = 2 * torch.arange(k, dtype=torch.int64, device=dev)
    codes = (q[:, None] >> shifts[None, :]) & 3  # [N, k]
    four = torch.arange(4, dtype=torch.int64, device=dev)
    oh = (codes[:, :, None] == four).reshape(n, 4 * k)
    nc = _n_classes(k, mink)
    if nc > 1:
        lns = 2 * (mink + torch.arange(nc, dtype=torch.int64, device=dev))
        cls = (q[:, None] >> lns[None, :]) == 1
    else:
        cls = torch.ones((n, 1), dtype=torch.bool, device=dev)
    const = torch.ones((n, 1), dtype=torch.bool, device=dev)
    pad = torch.zeros((n, Kp - 4 * k - nc - 1), dtype=torch.bool, device=dev)
    return torch.cat([oh, cls, const, pad], dim=1).to(torch.int8)


def mm_best_plain(key_words, prio, k: int, mink: int, Kp: int, Dp: int,
                  query):
    """Plain torch version of `mm_best` (the JAX package's `mm_best_jnp`):
    each query's best (rank << 16) | id priority word over these columns,
    BIG32 on a miss, int32 of `query`'s shape."""
    shape = query.shape
    oh = query_onehot(query.reshape(-1), k, mink, Kp)
    n = oh.shape[0]
    kb = key_words.view(torch.int8).t().to(torch.bfloat16)  # [Kp, Dp]
    big = torch.tensor(int(BIG32), dtype=torch.int32, device=query.device)
    best = torch.empty(n, dtype=torch.int32, device=query.device)
    # chunked over queries: the full [N, Dp] score matrix of a scan batch
    # would be tens of GB
    ch = 8192
    for c0 in range(0, n, ch):
        s = torch.matmul(oh[c0 : c0 + ch].to(torch.bfloat16), kb)
        best[c0 : c0 + ch] = torch.where(s >= 0, prio, big).amin(dim=1)
    return best.reshape(shape)


def mm_decode_best(best):
    """Priority word -> scaffold id (0 on a miss)."""
    return torch.where(best != int(BIG32), best & 0xFFFF, 0).to(torch.int32)


def mm_lookup_plain(key_words, prio, k: int, mink: int, Kp: int, Dp: int,
                    query):
    """Plain torch version of the lookup (the JAX package's `_mm_xla`):
    ids for int64 canonical keys `query` (any shape), 0 on a miss.
    key_words and prio are `MMKmerIndex.device_arrays`."""
    return mm_decode_best(mm_best_plain(key_words, prio, k, mink, Kp, Dp, query))


def _checked(key_words, prio, k: int, mink: int, Kp: int, Dp: int, query,
             name: str):
    """Raise unless the kernel takes these arguments."""
    if query.dtype != torch.int64 or not query.is_contiguous():
        raise ValueError(f"{name}: query must be contiguous int64")
    nc = _n_classes(k, mink)
    if (key_words.device != query.device or key_words.dtype != torch.int32
            or tuple(key_words.shape) != (Dp, Kp // 4)
            or not key_words.is_contiguous()):
        raise ValueError(f"{name}: key_words must be a contiguous int32 "
                         f"[{Dp}, {Kp // 4}] tensor on {query.device}")
    if (prio.device != query.device or prio.dtype != torch.int32
            or tuple(prio.shape) != (1, Dp) or not prio.is_contiguous()):
        raise ValueError(f"{name}: prio must be a contiguous int32 "
                         f"[1, {Dp}] tensor on {query.device}")
    if (Kp not in (128, 256) or 4 * k + nc + 1 > Kp or not 0 < k <= 31
            or Dp <= 0):
        raise ValueError(f"{name}: k={k}, mink={mink}, Kp={Kp}, Dp={Dp} "
                         "unsupported")


def _launch(entry: str, key_words, prio, k, mink, Kp, Dp, query, *extra):
    out = torch.empty(query.shape, dtype=torch.int32, device=query.device)
    n = query.numel()
    if n == 0:
        return out
    from ..kernels.build import check, library

    fn = getattr(library(), entry)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = fn(query.data_ptr(), out.data_ptr(), n, key_words.data_ptr(),
                prio.data_ptr(), Dp, k, mink, _n_classes(k, mink), Kp, *extra,
                ctypes.c_void_p(stream))
    check(rc, entry)
    return out


def mm_lookup(key_words, prio, k: int, mink: int, Kp: int, Dp: int, query):
    """ids for int64 canonical keys `query` (any shape) against the key
    words int32 [Dp, Kp/4] and priority row prio int32 [1, Dp] of
    `MMKmerIndex.device_arrays`.

    CPU tensors run `mm_lookup_plain`; CUDA tensors launch the kernel of
    csrc/mm_match.cu (wgmma's int8 product with the one-hot built in
    registers from each key), or raise."""
    if query.device.type == "cpu":
        return mm_lookup_plain(key_words, prio, k, mink, Kp, Dp, query)
    if query.device.type != "cuda":
        raise ValueError(f"mm_lookup: unsupported device {query.device}")
    _checked(key_words, prio, k, mink, Kp, Dp, query, "mm_lookup")
    out = _launch("mm_lookup", key_words, prio, k, mink, Kp, Dp, query)
    if query.numel():
        mm_lookup.launches += 1
    return out


#: kernel launches since the count was last set to 0
mm_lookup.launches = 0


def mm_best(key_words, prio, k: int, mink: int, Kp: int, Dp: int, query):
    """Each int64 query's best (rank << 16) | id priority word over the
    columns of `key_words` [Dp, Kp/4] and `prio` [1, Dp], BIG32 on a
    miss: the lookup before its decode. A min over column slabs of the
    key matrix is the lookup's winner over all their columns, which is
    how a tp-sharded matcher combines (parallel/sharded_count.py).

    CPU tensors run `mm_best_plain`; CUDA tensors launch the kernel of
    csrc/mm_match.cu with the epilogue that writes the word undecoded,
    or raise."""
    if query.device.type == "cpu":
        return mm_best_plain(key_words, prio, k, mink, Kp, Dp, query)
    if query.device.type != "cuda":
        raise ValueError(f"mm_best: unsupported device {query.device}")
    _checked(key_words, prio, k, mink, Kp, Dp, query, "mm_best")
    out = _launch("mm_best", key_words, prio, k, mink, Kp, Dp, query)
    if query.numel():
        mm_best.launches += 1
    return out


#: kernel launches since the count was last set to 0
mm_best.launches = 0

#: measurement variants of csrc/mm_match.cu (`mm_lookup_variant`): the
#: main kernel; its max-only epilogue (out = each query's max score) and
#: one-column epilogue (out = a sum of scores), which split product from
#: epilogue; the main kernel at half the query tile; the original dp4a
#: kernel
VARIANTS = {"main": 0, "max_only": 1, "one_column": 2, "half_tile": 3,
            "dp4a": 4}
#: the variants that compute the lookup itself
LOOKUP_VARIANTS = ("main", "half_tile", "dp4a")


def mm_lookup_variant(variant: str, key_words, prio, k: int, mink: int,
                      Kp: int, Dp: int, query):
    """One of VARIANTS on CUDA tensors, for timing beside `mm_lookup`;
    LOOKUP_VARIANTS compute the lookup itself. No path of the port calls
    it, and it does not count in `mm_lookup.launches`."""
    if query.device.type != "cuda":
        raise ValueError(f"mm_lookup_variant: needs a CUDA tensor, not "
                         f"{query.device}")
    _checked(key_words, prio, k, mink, Kp, Dp, query, "mm_lookup_variant")
    return _launch("mm_lookup_variant", key_words, prio, k, mink, Kp, Dp,
                   query, VARIANTS[variant])
