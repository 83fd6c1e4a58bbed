"""Sorted-join k-mer lookup: set membership as sort + scan, no hashing.

The large-panel backend (adapters.fa at hdist=1 expands to ~217k keys,
above the lane table's cap). The counterpart of
bbtools_tpu/ops/sort_join.py, computing the same join per chunk:

  1. concatenate [sorted index keys | query keys] with payloads that
     order index rows FIRST among key ties,
  2. sort,
  3. propagate the last-seen index row to every later position. Because
     index keys ascend, both (key) and (rank<<16 | id) of index rows
     ascend too, so the propagation is an int64 cummax of the
     segment-start words (ops/scan.py, a CUDA kernel on the GPU),
  4. a query hits iff its segment starts with an index row; un-sort the
     hit ids back to query order with one int64 sort.

Exactness: index keys are unique (first-wins dedup at build), every query
key is either present (the cummax carries its id) or absent (its segment
starts with a query row). The one unsupported scan feature is qhdist>0,
which multiplies the query stream ~70x (callers keep the bucket index
there).

Reference semantics: bbduk/BBDukIndexMod.getValue canonical-key lookup
(:492-508) over the loader's expanded key set (:298-361).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .scan import cummax_i64


@dataclass
class SortJoinIndex:
    """Sorted unique keys + first-wins ids, joined against query batches."""

    keys: np.ndarray  # int64 [V] sorted ascending, unique
    pay: np.ndarray  # int64 [V] = (rank << 16) | id  (ascending)
    n: int

    #: beyond this the per-batch join is dominated by re-sorting the
    #: index; kept equal to the JAX package's cap
    MAX_KEYS = 8_000_000

    @staticmethod
    def supports(n_keys: int, qhdist: int = 0) -> bool:
        return 0 < n_keys <= SortJoinIndex.MAX_KEYS and qhdist == 0

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray) -> "SortJoinIndex":
        """keys must be sorted unique with first-wins ids, exactly what
        ops/kmer_index.build_ref_keys returns."""
        keys = np.asarray(keys, np.int64)
        ids = np.asarray(ids, np.int64)
        if ids.min(initial=0) < 0 or ids.max(initial=0) >= (1 << 16):
            raise ValueError("sort-join ids must lie in [0, 2**16)")
        pay = (np.arange(len(keys), dtype=np.int64) << 16) | ids
        return SortJoinIndex(keys=keys, pay=pay, n=len(keys))

    @staticmethod
    def from_arrays(keys, pay) -> "SortJoinIndex":
        """An index over arrays built elsewhere (the JAX package's
        SortJoinIndex fields), so both packages can share one index."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        pay = np.ascontiguousarray(pay, dtype=np.int64)
        if keys.shape != pay.shape or keys.ndim != 1:
            raise ValueError(f"keys {keys.shape} and pay {pay.shape}")
        return SortJoinIndex(keys=keys, pay=pay, n=len(keys))

    def device_arrays(self, device):
        """(sorted keys int64, ids int32): the sort payload is just the id;
        row order in the scan supplies the monotonicity the int64 payload
        carries."""
        return (
            torch.from_numpy(self.keys).to(device),
            torch.from_numpy((self.pay & 0xFFFF).astype(np.int32)).to(device),
        )

    def static_params(self):
        return (self.n,)

    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        """Host path: binary search (fast on CPU; tests + CPU backend)."""
        q = np.asarray(query, np.int64)
        pos = np.searchsorted(self.keys, q)
        pos = np.minimum(pos, max(self.n - 1, 0))
        ok = self.keys[pos] == q if self.n else np.zeros(q.shape, bool)
        return np.where(
            ok, (self.pay[np.maximum(pos, 0)] & 0xFFFF), 0
        ).astype(np.int32)


#: per-join query-chunk size, as in the JAX package, so both packages
#: join the same chunks
CHUNK = 1 << 20

QBIT32 = 1 << 30  # marks query rows in the int32 payload


def _join_chunk(sorted_keys, ids32, q):
    """One join pass: q int64 [nq] (may contain -1 pad rows) -> ids."""
    v, sp, is_idx = segment_words(sorted_keys, ids32, q)
    c = cummax_i64(v)
    hit = (~is_idx) & (((c >> 16) & 1) == 1)
    out_id = torch.where(hit, c & 0xFFFF, 0)
    # un-sort to query order as ONE int64 sort of (pos << 16 | id);
    # index rows sink to the tail via a huge pos
    pos_key = torch.where(is_idx, 0x7FFFFFFF, sp & ~QBIT32).to(torch.int64)
    packed = torch.sort((pos_key << 16) | out_id).values
    return (packed[: q.shape[0]] & 0xFFFF).to(torch.int32)


def segment_words(sorted_keys, ids32, q):
    """Sort one chunk and build the cummax input: (v int64, sorted
    payload int32, is_idx bool), each of length len(index) + len(q).

    Index rows carry just the id (16 bits) as payload, query rows carry
    (1<<30)|position (nq <= CHUNK < 2^30). Post-sort propagation is ONE
    cummax: equal keys form a segment whose FIRST row is the index row
    when the key is present, so packing (row << 17 | is_idx << 16 | id)
    at segment starts (-1 elsewhere) gives a value monotone in row
    position."""
    nq = q.shape[0]
    keys = torch.cat([sorted_keys, q])
    qpay = QBIT32 | torch.arange(nq, dtype=torch.int32, device=q.device)
    pays = torch.cat([ids32, qpay])
    # The JAX package sorts by (key, payload) with a two-key lax.sort.
    # One stable sort by key alone gives the same order: index rows come
    # first in the concatenation and their keys are unique, and query
    # payloads (QBIT32 | position) ascend in concatenation order, so
    # among equal keys the stable order is the (key, payload) order.
    sk, perm = torch.sort(keys, stable=True)
    sp = pays[perm]
    n = sk.shape[0]
    is_idx = sp < QBIT32
    row = torch.arange(n, dtype=torch.int64, device=q.device)
    seg_start = torch.ones(n, dtype=torch.bool, device=q.device)
    seg_start[1:] = sk[1:] != sk[:-1]
    v = torch.where(
        seg_start,
        (row << 17) | (is_idx.to(torch.int64) << 16) | (sp.to(torch.int64) & 0xFFFF),
        -1,
    )
    return v, sp, is_idx


def join_lookup(sorted_keys, ids32, query):
    """ids for `query` (any shape, int64 canonical keys) against the
    sorted index, chunked as in the JAX package. Pad rows use key -1:
    they sort before all index keys (>= 0), can never be carried into a
    hit by an index row, and their positions are sliced off."""
    shape = query.shape
    q = query.reshape(-1)
    nq = q.shape[0]
    if nq <= CHUNK + CHUNK // 2:
        return _join_chunk(sorted_keys, ids32, q).reshape(shape)
    nch = -(-nq // CHUNK)
    padded = nch * CHUNK
    if padded != nq:
        q = torch.cat(
            [q, torch.full((padded - nq,), -1, dtype=torch.int64, device=q.device)]
        )
    outs = [
        _join_chunk(sorted_keys, ids32, q[c * CHUNK : (c + 1) * CHUNK])
        for c in range(nch)
    ]
    return torch.cat(outs)[:nq].reshape(shape)
