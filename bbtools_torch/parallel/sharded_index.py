"""Sharded k-mer index and the multi-device BBDuk scan.

The counterpart of bbtools_tpu/parallel/sharded_index.py, the
descendant of the reference's kmer%WAYS table sharding
(kmer/KmerTableSet.java:273-285, bbduk/BBDukIndexMod.java:506 routing):
keys route to shard `key % n_shards` at build, and each shard is an
independent bucket table. A batch's rows are cut into one slab per dp row
of the mesh; each slab is scanned on its row's first device, and every
lookup inside the scan goes to all the row's tp shards, each on its own
device and probing only the keys it owns, whose parts are summed on the
row's device (`KScanConfig.tp_shards`, ops/bbduk_scan.py). The slabs'
outputs are concatenated in slab order, so BBDuk's host logic is
unchanged and its outputs are the same bytes at any mesh.

The sharded scan always runs the bucket gather on every shard
(`BucketKmerIndex.lookup`), whatever backend the panel takes on one
device, as the JAX package's does: B1, B2 and B3 are not on this path.
`ShardedKmerIndex.build` is the JAX package's host build, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops.bbduk_scan import KScanConfig, _lookup, canonical_keys, kscan_combined
from ..ops.kmer_index import BucketKmerIndex
from ..ops.kmers import rolling_kmers
from .mesh import Mesh, slabs


@dataclass
class ShardedKmerIndex:
    """n_shards independent bucketed tables stacked on a leading axis."""

    keys: np.ndarray  # int64 [S, nb, BUCKET]
    ids: np.ndarray  # int32 [S, nb, BUCKET]
    nb: int
    n_shards: int

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray, n_shards: int):
        from ..ops.kmer_index import _mix64

        parts = [
            ((keys % n_shards) == s).nonzero()[0] for s in range(n_shards)
        ]
        B = BucketKmerIndex.BUCKET
        nb = 64
        biggest = max((len(p) for p in parts), default=1)
        while nb * B * 0.5 < max(biggest, 1):
            nb *= 2
        while True:  # grow until every shard's buckets fit
            ok = True
            for p in parts:
                h = (_mix64(keys[p].astype(np.uint64)) & np.uint64(nb - 1)).astype(np.int64)
                if len(p) and np.bincount(h, minlength=nb).max() > B:
                    ok = False
                    break
            if ok or nb >= 1 << 28:
                break
            nb *= 2
        kt = np.full((n_shards, nb, B), -1, dtype=np.int64)
        it = np.zeros((n_shards, nb, B), dtype=np.int32)
        for s, p in enumerate(parts):
            if not len(p):
                continue
            h = (_mix64(keys[p].astype(np.uint64)) & np.uint64(nb - 1)).astype(np.int64)
            order = np.argsort(h, kind="stable")
            hs = h[order]
            slot = np.arange(len(p)) - np.searchsorted(hs, hs)
            kt[s, hs, slot] = keys[p][order]
            it[s, hs, slot] = ids[p][order]
        return ShardedKmerIndex(keys=kt, ids=it, nb=nb, n_shards=n_shards)

    def place(self, mesh: Mesh) -> list:
        """The tables on the mesh: for each dp row, the tuple of its tp
        shards' (keys, ids), shard s on device (row, s) (one copy per
        distinct device)."""
        if mesh.shape["tp"] != self.n_shards:
            raise ValueError(f"{self.n_shards} shards on a mesh of {mesh.shape['tp']} tp")
        copies: dict = {}

        def on(s, dev):
            if (s, dev) not in copies:
                copies[s, dev] = (torch.from_numpy(self.keys[s]).to(dev),
                                  torch.from_numpy(self.ids[s]).to(dev))
            return copies[s, dev]

        return [tuple(on(s, mesh.devices[d, s]) for s in range(self.n_shards))
                for d in range(mesh.shape["dp"])]


def _shard_cfg(cfg: KScanConfig, sidx: ShardedKmerIndex) -> KScanConfig:
    return replace(cfg, tp_shards=sidx.n_shards, nb=sidx.nb, packed=False,
                   lane=None, mm=None, join=None)


def make_sharded_kscan(mesh: Mesh, cfg: KScanConfig, sidx: ShardedKmerIndex,
                       short_left: bool, short_right: bool):
    """`kscan_combined` over a (dp, tp) mesh: fn(tables, bases [B, L]
    uint8, lengths [B] int32) -> (out, sl, sr) as kscan_combined returns
    them, on the mesh's first device. B divides by dp; `tables` is
    `sidx.place(mesh)`."""
    if mesh.shape["tp"] != sidx.n_shards:
        raise ValueError(f"{sidx.n_shards} shards on a mesh of {mesh.shape['tp']} tp")
    scfg = _shard_cfg(cfg, sidx)

    def step(tables, bases, lengths):
        outs = []
        for d, sl in enumerate(slabs(bases.shape[0], mesh.shape["dp"])):
            dev = mesh.row(d)
            outs.append(kscan_combined(scfg, tables[d], bases[sl].to(dev),
                                       lengths[sl].to(dev), short_left, short_right))
        dev0 = mesh.row(0)

        def cat(xs):
            return torch.cat([x.to(dev0) for x in xs])

        out = {k: cat([o[0][k] for o in outs]) for k in outs[0][0]}
        sl_ = (tuple(cat([o[1][i] for o in outs]) for i in range(3))
               if short_left else None)
        sr_ = (tuple(cat([o[2][i] for o in outs]) for i in range(3))
               if short_right else None)
        return out, sl_, sr_

    return step


def sharded_bbduk_step(mesh: Mesh, cfg: KScanConfig, sidx: ShardedKmerIndex):
    """The multi-device BBDuk filter step: fn(bases [B, L] uint8, lengths
    [B] int32, tables) -> (nhits [B] int32, the dp-summed histogram of
    min(nhits, 255), [256] int32), on the mesh's first device. `tables`
    is `sidx.place(mesh)`."""
    if mesh.shape["tp"] != sidx.n_shards:
        raise ValueError(f"{sidx.n_shards} shards on a mesh of {mesh.shape['tp']} tp")
    scfg = _shard_cfg(cfg, sidx)

    def step(bases, lengths, tables):
        parts = []
        for d, sl in enumerate(slabs(bases.shape[0], mesh.shape["dp"])):
            dev = mesh.row(d)
            b, ln = bases[sl].to(dev), lengths[sl].to(dev)
            fwd, rkm, runlen = rolling_kmers(b, cfg.k)
            keys = canonical_keys(cfg, fwd, rkm, cfg.k)
            i_idx = torch.arange(b.shape[1], dtype=torch.int32, device=dev)[None, :]
            eligible = ((runlen >= cfg.resolved_minlen2()) & (i_idx >= cfg.k - 1)
                        & (i_idx < ln[:, None]))
            full = torch.where(eligible, _lookup(scfg, tables[d], keys), 0)
            nhits = (full > 0).sum(dim=1, dtype=torch.int32)
            bins = torch.arange(256, dtype=torch.int32, device=dev)[:, None]
            hist = (nhits.clamp(max=255)[None, :] == bins).sum(dim=1, dtype=torch.int32)
            parts.append((nhits, hist))
        dev0 = mesh.row(0)
        nhits = torch.cat([p[0].to(dev0) for p in parts])
        hist = parts[0][1].to(dev0)
        for p in parts[1:]:
            hist = hist + p[1].to(dev0)
        return nhits, hist

    return step
