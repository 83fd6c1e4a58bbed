"""BBMap genome seed index — CSR key->positions, TPU-era layout.

Re-design of the reference BBIndex Block (align2/Block.java:18: int[] sites
+ int[] starts per chrom block, built by IndexMaker4) as one flat CSR over
the whole concatenated reference: `starts[key]..starts[key+1]` indexes into
`sites[]`, key = 2k-bit forward k-mer (default k=13, align2/BBMap.java:69).
Like the reference, only forward-strand genome k-mers are stored; reads
search with forward and reverse-complement keys (BBIndex.java:433).

High-frequency keys are clamped (the reference excludes the top
FRACTION_GENOME_TO_EXCLUDE of sites by key frequency, BBIndex.analyzeIndex
:119): keys with more than `max_hits` sites are dropped at build.

Build is a counting sort (numpy): O(G) time, 4 bytes/site + 4*4^k bytes of
starts — the same ~4-8 bytes/ref-base budget the docs quote
(BBMap_old_readme.txt:22).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import Reference
from ..ops.kmers import rolling_kmers_np

INDEX_VERSION = 1


@dataclass
class SeedIndex:
    k: int
    starts: np.ndarray  # int64 [4^k + 1]
    sites: np.ndarray  # int32 [n_sites] -- flat reference positions
    ref: Reference

    # ---- persistence (the reference caches built indexes under path=,
    # align2/IndexMaker4 writes block files reused on later runs) ----
    def save(self, path: str) -> None:
        """Serialize to one compressed npz. The 4^k `starts` table is
        stored as per-key counts — sparse (key, count) pairs when under
        quarter-full (small references), dense uint16 otherwise — so the
        load path never decompresses hundreds of idle megabytes."""
        counts = np.diff(self.starts)
        nz = np.flatnonzero(counts)
        payload = dict(
            version=np.int64(INDEX_VERSION),
            k=np.int64(self.k),
            space=np.int64(len(counts)),
            sites=self.sites,
            ref_codes=self.ref.codes,
            ref_starts=self.ref.starts,
            ref_lengths=self.ref.lengths,
            ref_names=np.array([n.decode() for n in self.ref.names]),
        )
        if len(nz) * 4 < len(counts):
            payload["nz_keys"] = nz.astype(np.int64)
            payload["nz_counts"] = counts[nz].astype(np.uint16)
        else:
            payload["counts"] = counts.astype(np.uint16)
        np.savez_compressed(path, **payload)

    @staticmethod
    def load(path: str) -> "SeedIndex":
        z = np.load(path, allow_pickle=False)
        if int(z["version"]) != INDEX_VERSION:
            raise ValueError(
                f"{path}: index version {int(z['version'])}, "
                f"expected {INDEX_VERSION} — rebuild with overwrite=t"
            )
        space = int(z["space"])
        starts = np.zeros(space + 1, dtype=np.int64)
        if "counts" in z:
            np.cumsum(z["counts"].astype(np.int64), out=starts[1:])
        else:
            counts = np.zeros(space, dtype=np.int64)
            counts[z["nz_keys"]] = z["nz_counts"]
            np.cumsum(counts, out=starts[1:])
        ref = Reference(
            codes=z["ref_codes"],
            names=[n.encode() for n in z["ref_names"]],
            starts=z["ref_starts"],
            lengths=z["ref_lengths"],
        )
        return SeedIndex(
            k=int(z["k"]), starts=starts, sites=z["sites"], ref=ref
        )

    @staticmethod
    def build(ref: Reference, k: int = 13, max_hits: int = 2000):
        codes = ref.codes
        L = len(codes)
        fwd, _, runlen = rolling_kmers_np(codes[None, :], k)
        fwd = fwd[0]
        runlen = runlen[0]
        valid = runlen >= k
        # key at position i covers [i-k+1, i]; site = start position
        keys = fwd[valid]
        positions = (np.flatnonzero(valid) - (k - 1)).astype(np.int32)
        space = 1 << (2 * k)
        counts = np.bincount(keys, minlength=space)
        over = counts > max_hits
        if over.any():
            keep = ~over[keys]
            keys = keys[keep]
            positions = positions[keep]
            counts = np.bincount(keys, minlength=space)
        starts = np.zeros(space + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        order = np.argsort(keys, kind="stable")
        sites = positions[order]
        return SeedIndex(k=k, starts=starts, sites=sites, ref=ref)

    def lookup_counts(self, keys: np.ndarray) -> np.ndarray:
        s = self.starts[keys]
        e = self.starts[keys + 1]
        return (e - s).astype(np.int32)

    def expand(self, keys: np.ndarray):
        """Return (flat_sites, owner) for a 1-D key array: all sites of all
        keys concatenated, with owner[i] = index into `keys`."""
        s = self.starts[keys]
        e = self.starts[keys + 1]
        n = (e - s).astype(np.int64)
        total = int(n.sum())
        owner = np.repeat(np.arange(len(keys)), n)
        # ragged gather: offsets within each run
        idx = np.arange(total) - np.repeat(np.cumsum(n) - n, n) + np.repeat(s, n)
        return self.sites[idx], owner
