"""Dedupe — duplicate-read removal and absorption (jgi/Dedupe.java).

Modes (reference flag semantics):
  - exact + reverse-complement duplicates (`ac=f` hot path): canonical
    form = min(seq, rc(seq)) hashed; first occurrence wins.
  - `s=N` substitutions / `e=N` edit distance: candidates are found via
    prefix/suffix k-mer affix maps (Dedupe.java's numAffixMaps design —
    an N-edit duplicate must share an unedited affix) and verified with
    a Hamming count (subs) or the BandedAligner kernel
    (ops/banded.py, alignQuadruple semantics, Dedupe.java:4832).
  - `ac=t` containment: shorter reads absorbed by kept reads when they
    occur as a (subs-tolerant) substring in either orientation; anchors
    come from a rolling k-mer index of kept reads (absorbContainment
    path, Dedupe.java:3137+).

  - `cluster=t pattern=out_%.fq`: instead of absorbing duplicates,
    connect reads that match (by any enabled criterion) with union-find
    and emit one file per connected cluster (Dedupe's cluster output,
    processClusters path).

The PyTorch port of bbtools_tpu/models/dedupe.py. Host tool by design
(like the reference's hash-table threads): the hashing, the affix maps
and the union-find are host code, copied. With e= > 0 a batch's fuzzy
candidate pairs against the reads kept before it are verified in one
call of the banded edit distance (ops/banded.banded_edits) on the run's
device (`device=`, cuda by default); pairs within one batch are checked
on the host, as in the JAX package.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, FastqWriter

AFFIX_K = 31


def _canon(codes: np.ndarray):
    """Canonical orientation: lexicographically smaller of seq/rc."""
    rc = np.where(codes < 4, 3 - codes, codes)[::-1].copy()
    a, b = codes.tobytes(), rc.tobytes()
    return (codes, False) if a <= b else (rc, True)


def _kmer_at(codes: np.ndarray, pos: int, k: int) -> int:
    if pos + k > len(codes):
        return -1
    w = codes[pos : pos + k]
    if (w >= 4).any():
        return -1
    v = 0
    for c in w:
        v = (v << 2) | int(c)
    return v


def _hamming(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) != len(b):
        return 1 << 30
    return int((a != b).sum())


class Dedupe:
    def __init__(self, subs=0, edist=0, containment=False, rcomp=True,
                 k=AFFIX_K, device: str | torch.device = "cuda"):
        self.device = resolve_device(str(device))
        self.subs = subs
        self.edist = edist
        self.containment = containment
        self.rcomp = rcomp
        self.k = k
        self.kept_codes: list[np.ndarray] = []
        self.exact: dict[bytes, int] = {}
        self.prefix: dict[int, list[int]] = {}
        self.suffix: dict[int, list[int]] = {}
        self.kindex: dict[int, tuple[int, int]] = {}
        self.dupes = 0
        self.contained = 0

    def _fuzzy_match(self, codes: np.ndarray) -> bool:
        k = self.k
        cands: set[int] = set()
        for km in (_kmer_at(codes, 0, k), _kmer_at(codes, len(codes) - k, k)):
            if km < 0:
                continue
            cands.update(self.prefix.get(km, ()))
            cands.update(self.suffix.get(km, ()))
        tol = max(self.subs, self.edist)
        for ci in cands:
            other = self.kept_codes[ci]
            if abs(len(other) - len(codes)) > self.edist:
                continue
            if self.subs > 0 and len(other) == len(codes):
                if _hamming(codes, other) <= self.subs:
                    return True
            if self.edist > 0:
                from ..ops.banded import banded_edits_np

                q, r = (
                    (codes, other)
                    if len(codes) <= len(other)
                    else (other, codes)
                )
                if banded_edits_np(q, r, self.edist) <= self.edist:
                    return True
            if self.subs > 0 and self.edist == 0 and len(other) == len(codes):
                continue
        return False

    def _contained_in_kept(self, codes: np.ndarray) -> bool:
        k = self.k
        for probe_rc in (False, True) if self.rcomp else (False,):
            c = (
                np.where(codes < 4, 3 - codes, codes)[::-1].copy()
                if probe_rc
                else codes
            )
            km = _kmer_at(c, 0, k)
            if km < 0:
                continue
            hit = self.kindex.get(km)
            if hit is None:
                continue
            ci, pos = hit
            other = self.kept_codes[ci]
            if pos + len(c) > len(other):
                continue
            if _hamming(c, other[pos : pos + len(c)]) <= self.subs:
                return True
        return False

    def _register(self, codes: np.ndarray, idx: int):
        k = self.k
        pk = _kmer_at(codes, 0, k)
        sk = _kmer_at(codes, len(codes) - k, k)
        if pk >= 0:
            self.prefix.setdefault(pk, []).append(idx)
        if sk >= 0:
            self.suffix.setdefault(sk, []).append(idx)
        if self.containment:
            for p in range(0, len(codes) - k + 1):
                km = _kmer_at(codes, p, k)
                if km >= 0 and km not in self.kindex:
                    self.kindex[km] = (idx, p)

    # ---- cluster mode (union-find over match edges) ----
    def _find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def _union(self, a, b):
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self.parent[rb] = ra

    def judge_cluster(self, raw_codes: np.ndarray) -> int:
        """Cluster mode: every read is kept; matching reads merge into
        one cluster. Returns the read's index."""
        codes, _ = _canon(raw_codes) if self.rcomp else (raw_codes, False)
        idx = len(self.kept_codes)
        if not hasattr(self, "parent"):
            self.parent = []
        self.parent.append(idx)
        h = codes.tobytes()
        mates = []
        if h in self.exact:
            mates.append(self.exact[h])
        else:
            self.exact[h] = idx
        if (self.subs > 0 or self.edist > 0) and len(codes) >= self.k:
            mates += self._fuzzy_candidates(codes)
        if self.containment and len(codes) >= self.k:
            m = self._containment_candidate(codes)
            if m is not None:
                mates.append(m)
        self.kept_codes.append(codes)
        if self.subs > 0 or self.edist > 0 or self.containment:
            self._register(codes, idx)
        for m in set(mates):
            self._union(idx, m)
        return idx

    def _fuzzy_candidates(self, codes):
        """Indices of kept reads matching within subs/edist."""
        k = self.k
        cands: set[int] = set()
        for km in (_kmer_at(codes, 0, k), _kmer_at(codes, len(codes) - k, k)):
            if km < 0:
                continue
            cands.update(self.prefix.get(km, ()))
            cands.update(self.suffix.get(km, ()))
        out = []
        for ci in cands:
            other = self.kept_codes[ci]
            if abs(len(other) - len(codes)) > max(self.edist, 0):
                continue
            if (
                self.subs > 0
                and len(other) == len(codes)
                and _hamming(codes, other) <= self.subs
            ):
                out.append(ci)
                continue
            if self.edist > 0:
                from ..ops.banded import banded_edits_np

                q, r = (
                    (codes, other)
                    if len(codes) <= len(other)
                    else (other, codes)
                )
                if banded_edits_np(q, r, self.edist) <= self.edist:
                    out.append(ci)
        return out

    def _containment_candidate(self, codes):
        k = self.k
        for probe_rc in (False, True) if self.rcomp else (False,):
            c = (
                np.where(codes < 4, 3 - codes, codes)[::-1].copy()
                if probe_rc
                else codes
            )
            km = _kmer_at(c, 0, k)
            if km < 0:
                continue
            hit = self.kindex.get(km)
            if hit is None:
                continue
            ci, pos = hit
            other = self.kept_codes[ci]
            if pos + len(c) <= len(other) and _hamming(
                c, other[pos : pos + len(c)]
            ) <= self.subs:
                return ci
        return None

    def clusters(self):
        """cluster id -> member read indices."""
        out: dict[int, list[int]] = {}
        for i in range(len(self.kept_codes)):
            out.setdefault(self._find(i), []).append(i)
        return out

    def judge(self, raw_codes: np.ndarray) -> bool:
        """True if the read should be kept (first of its cluster)."""
        codes, _ = (
            _canon(raw_codes) if self.rcomp else (raw_codes, False)
        )
        h = codes.tobytes()
        if h in self.exact:
            self.dupes += 1
            return False
        if (self.subs > 0 or self.edist > 0) and len(codes) >= self.k:
            if self._fuzzy_match(codes):
                self.dupes += 1
                return False
        if self.containment and len(codes) >= self.k:
            if self._contained_in_kept(codes):
                self.contained += 1
                return False
        idx = len(self.kept_codes)
        self.kept_codes.append(codes)
        self.exact[h] = idx
        if self.subs > 0 or self.edist > 0 or self.containment:
            self._register(codes, idx)
        return True

    # -------------------------------------------------- batched edist path
    def _collect_cands(self, codes) -> list[int]:
        """Candidate kept-read indices (length-filtered, unverified)."""
        k = self.k
        cands: set[int] = set()
        for km in (_kmer_at(codes, 0, k), _kmer_at(codes, len(codes) - k, k)):
            if km < 0:
                continue
            cands.update(self.prefix.get(km, ()))
            cands.update(self.suffix.get(km, ()))
        tol = max(self.edist, 0)
        return [
            ci
            for ci in cands
            if abs(len(self.kept_codes[ci]) - len(codes)) <= tol
            or (self.subs > 0 and len(self.kept_codes[ci]) == len(codes))
        ]

    def _verify_host(self, codes, other) -> bool:
        if (
            self.subs > 0
            and len(other) == len(codes)
            and _hamming(codes, other) <= self.subs
        ):
            return True
        if self.edist > 0:
            from ..ops.banded import banded_edits_np

            q, r = (codes, other) if len(codes) <= len(other) else (other, codes)
            return banded_edits_np(q, r, self.edist) <= self.edist
        return False

    def judge_batch(self, codes_list: list[np.ndarray]) -> list[bool]:
        """Batch verdicts identical to sequential judge() calls, with the
        banded edit-distance verifications of the whole batch in ONE call
        of ops/banded.banded_edits on the run's device instead of a
        per-pair host loop. Intra-batch candidate pairs (a read matching
        a read kept earlier in the same batch) are checked on the host;
        they are rare and preserve exact sequential semantics."""
        canon_list = [
            (_canon(c)[0] if self.rcomp else c) for c in codes_list
        ]
        snap = len(self.kept_codes)
        pairs: list[tuple[int, int]] = []
        if self.edist > 0:
            seen_hashes: set[bytes] = set(self.exact)
            for i, codes in enumerate(canon_list):
                if len(codes) < self.k:
                    continue
                h = codes.tobytes()
                if h in seen_hashes:
                    continue  # exact dupe regardless of fuzzy outcome
                seen_hashes.add(h)
                for ci in self._collect_cands(codes):
                    pairs.append((i, ci))
        verdict: dict[tuple[int, int], bool] = {}
        if pairs:
            from ..ops.banded import banded_edits

            Lmax = max(
                max(len(canon_list[i]), len(self.kept_codes[ci]))
                for i, ci in pairs
            )
            P = len(pairs)
            qs = np.full((P, Lmax), 4, np.uint8)
            rs = np.full((P, Lmax), 4, np.uint8)
            qls = np.zeros(P, np.int32)
            rls = np.zeros(P, np.int32)
            subs_hit = np.zeros(P, dtype=bool)
            for t, (i, ci) in enumerate(pairs):
                a, b = canon_list[i], self.kept_codes[ci]
                if (
                    self.subs > 0
                    and len(a) == len(b)
                    and _hamming(a, b) <= self.subs
                ):
                    subs_hit[t] = True
                q, r = (a, b) if len(a) <= len(b) else (b, a)
                qs[t, : len(q)] = q
                rs[t, : len(r)] = r
                qls[t], rls[t] = len(q), len(r)
            dev = self.device
            ed = banded_edits(
                torch.from_numpy(qs).to(dev), torch.from_numpy(qls).to(dev),
                torch.from_numpy(rs).to(dev), torch.from_numpy(rls).to(dev),
                self.edist,
            ).cpu().numpy()
            for t, (i, ci) in enumerate(pairs):
                verdict[(i, ci)] = bool(subs_hit[t] or ed[t] <= self.edist)
        out = []
        for i, codes in enumerate(canon_list):
            out.append(self._judge_one(codes, i, snap, verdict))
        return out

    def _judge_one(self, codes, i, snap, verdict) -> bool:
        """judge() with pre-verified fuzzy pairs (device) for candidates
        below the batch snapshot; later (intra-batch) candidates verify
        on host."""
        h = codes.tobytes()
        if h in self.exact:
            self.dupes += 1
            return False
        if (self.subs > 0 or self.edist > 0) and len(codes) >= self.k:
            for ci in self._collect_cands(codes):
                if ci < snap and self.edist > 0:
                    hit = verdict.get((i, ci), False)
                else:
                    hit = self._verify_host(codes, self.kept_codes[ci])
                if hit:
                    self.dupes += 1
                    return False
        if self.containment and len(codes) >= self.k:
            if self._contained_in_kept(codes):
                self.contained += 1
                return False
        idx = len(self.kept_codes)
        self.kept_codes.append(codes)
        self.exact[h] = idx
        if self.subs > 0 or self.edist > 0 or self.containment:
            self._register(codes, idx)
        return True


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    outd = a.get("outd", "outduplicate")
    rcomp = a.get_bool("rcomp", "absorbrc", "arc", default=True)
    subs = a.get_int("s", "subs", "maxsubs", default=0)
    edist = a.get_int("e", "edist", "maxedits", default=0)
    containment = a.get_bool("ac", "absorbcontainment", default=False)
    cluster = a.get_bool("cluster", "clusters", default=False)
    pattern = a.get("pattern", "outpattern")
    from ..core.parser import test_output_files

    test_output_files(
        a.get_bool("overwrite", "ow", default=True),
        out1, outd, inputs=(in1,),
    )
    t0 = time.time()
    dd = Dedupe(subs=subs, edist=edist, containment=containment, rcomp=rcomp,
                device=a.get("device", default="cuda"))
    reader = FastqReader(in1)
    if cluster:
        if not pattern or "%" not in pattern:
            raise ValueError("cluster=t requires pattern= containing %")
        rows = []  # (name, seq, qual)
        for b in reader:
            for i in range(b.n):
                L = int(b.lengths[i])
                dd.judge_cluster(b.bases[i, :L].copy())
                rows.append((b.ids[i], b.sequence(i), b.quality_string(i)))
        cl = dd.clusters()
        for ci, (root, members) in enumerate(sorted(cl.items())):
            from ..io.readwrite import open_output

            with open_output(pattern.replace("%", str(ci))) as fh:
                for m in members:
                    nm, seq, qual = rows[m]
                    fh.write(b"@%s\n%s\n+\n%s\n" % (nm, seq, qual))
        print(f"Input:               \t{reader.reads_in} reads", file=sys.stderr)
        print(f"Clusters:            \t{len(cl)}", file=sys.stderr)
        print(f"Time:                \t{time.time()-t0:.3f} seconds.",
              file=sys.stderr)
        return len(cl), reader.reads_in
    w = FastqWriter(out1) if out1 else None
    wd = FastqWriter(outd) if outd else None
    kept = 0
    for b in reader:
        keep = np.zeros(b.n, dtype=bool)
        if edist > 0:
            codes_list = [
                b.bases[i, : int(b.lengths[i])].copy() for i in range(b.n)
            ]
            for i, ok in enumerate(dd.judge_batch(codes_list)):
                keep[i] = ok
                kept += int(ok)
        else:
            for i in range(b.n):
                L = int(b.lengths[i])
                if dd.judge(b.bases[i, :L].copy()):
                    keep[i] = True
                    kept += 1
        if w:
            w.add(b, keep)
        if wd:
            wd.add(b, ~keep)
    for x in (w, wd):
        if x:
            x.close()
    dupes = dd.dupes + dd.contained
    print(f"Input:               \t{reader.reads_in} reads", file=sys.stderr)
    print(
        f"Duplicates:          \t{dupes} reads "
        f"({100.0*dupes/max(reader.reads_in,1):.2f}%)"
        + (f", {dd.contained} contained" if containment else ""),
        file=sys.stderr,
    )
    print(f"Result:              \t{kept} reads", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return kept, dupes


if __name__ == "__main__":
    main()
