"""Count-min sketch k-mer counter — the KCountArray analog, on the device.

The PyTorch port of bbtools_tpu/ops/cms.py: memory-bounded approximate
counting (bloom/KCountArray7MTA.java:29: cell-packed counters with
several hashes) as `hashes` independent lanes of a power-of-2 `cells`
array of int32 counters, kept on the device between batches.

The slot of a key in lane h is splitmix64(key ^ salt[h]) & (cells - 1),
computed in int64 with logical shifts (`kmer_index._bucket_of`): CUDA
tensors have no uint64 multiply or logical right shift.

An add sorts the [H*n] flat slots, takes the run boundaries and the run
lengths, and makes one `index_add_` over the unique slots only, then
saturates at `max_count`. The JAX package pads its runs with an
out-of-range slot that its scatter drops; torch has no dropping scatter,
so the add slices to the runs instead: every index is in range and
unique, and the result is deterministic. A query is one gather per lane
and a min over the lanes.

`cms_add.device_calls` and `cms_query.device_calls` count the adds and
queries made on CUDA tensors: the proof that a path counted on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .kmer_index import _as_int64, _bucket_of, _mix64

_SALTS_NP = np.array(
    [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x27D4EB2F165667C5],
    dtype=np.uint64,
)
#: the salts as the signed int64 of the same bits
_SALTS = [_as_int64(int(s)) for s in _SALTS_NP]


def cms_slots(keys: torch.Tensor, hashes: int, cells: int) -> torch.Tensor:
    """[H, n] int64 slot of each int64 key in each lane."""
    keys = keys.to(torch.int64)
    return torch.stack([_bucket_of(keys ^ _SALTS[h], cells) for h in range(hashes)])


def cms_add(table: torch.Tensor, keys: torch.Tensor, max_count: int):
    """Add one to each key's slot in every lane of table [H, cells]
    (int32, in place), duplicates accumulating, then saturate at
    max_count."""
    if table.device.type == "cuda":
        cms_add.device_calls += 1
    hashes, cells = table.shape
    slots = cms_slots(keys, hashes, cells)
    flat = (slots + (torch.arange(hashes, device=table.device) * cells)[:, None]).reshape(-1)
    s = torch.sort(flat).values
    n = s.shape[0]
    boundary = torch.ones(n, dtype=torch.bool, device=s.device)
    boundary[1:] = s[1:] != s[:-1]
    starts = torch.nonzero(boundary).squeeze(1)
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=starts.dtype, device=s.device)])
    table.view(-1).index_add_(0, s[starts], (ends - starts).to(torch.int32))
    table.clamp_(max=max_count)


def cms_query(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """[n] int32 estimate of each key: the least of its lanes' counters."""
    if table.device.type == "cuda":
        cms_query.device_calls += 1
    hashes, cells = table.shape
    slots = cms_slots(keys, hashes, cells)
    est = table[0, slots[0]]
    for h in range(1, hashes):
        est = torch.minimum(est, table[h, slots[h]])
    return est


#: adds on CUDA tensors since the count was last set to 0
cms_add.device_calls = 0
#: queries on CUDA tensors since the count was last set to 0
cms_query.device_calls = 0


class CountMinSketch:
    """Device-resident CMS on `device` (cuda by default). add()/query()
    take int64 keys (host arrays or tensors); the table stays on the
    device between calls."""

    def __init__(self, cells_per_hash: int = 1 << 22, hashes: int = 3,
                 max_count: int = 65535, device: str | torch.device = "cuda"):
        assert cells_per_hash & (cells_per_hash - 1) == 0
        self.cells = cells_per_hash
        self.hashes = hashes
        self.max_count = max_count
        self.device = resolve_device(str(device))
        self.table = torch.zeros((hashes, cells_per_hash), dtype=torch.int32,
                                 device=self.device)

    def _keys(self, keys) -> torch.Tensor:
        if not torch.is_tensor(keys):
            keys = torch.from_numpy(np.asarray(keys, np.int64))
        return keys.to(self.device, torch.int64)

    def add(self, keys):
        """Increment each key once per lane (saturating). Duplicate keys
        within the batch accumulate (scatter-add semantics)."""
        keys = self._keys(keys)
        if keys.numel():
            cms_add(self.table, keys, self.max_count)

    def query_t(self, keys) -> torch.Tensor:
        """Device-to-device query: int32 estimates on the table's device."""
        return cms_query(self.table, self._keys(keys))

    def query(self, keys) -> np.ndarray:
        return self.query_t(keys).cpu().numpy().astype(np.int64)

    # --- host-side reference implementation (tests) ---
    def _slots_np(self, keys: np.ndarray) -> np.ndarray:
        out = np.empty((self.hashes, len(keys)), dtype=np.int64)
        for h in range(self.hashes):
            out[h] = (
                _mix64(keys.astype(np.uint64) ^ _SALTS_NP[h])
                & np.uint64(self.cells - 1)
            ).astype(np.int64)
        return out


class CMSTable:
    """count_of adapter so EccEngine/correctors can run over CMS counts
    (canonical int64 keys in, approximate counts out)."""

    def __init__(self, cms: CountMinSketch, k: int):
        self.cms = cms
        self.k = k
        self.mask = (1 << (2 * k)) - 1
        self.shift2 = 2 * (k - 1)

    def count_of(self, keys: np.ndarray) -> np.ndarray:
        return self.cms.query(np.asarray(keys, dtype=np.int64))
