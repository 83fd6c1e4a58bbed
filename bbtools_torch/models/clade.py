"""QuickClade — k-mer-frequency taxonomic classification.

Reference: clade/ package (quickclade.sh): a Clade is a profile of
canonical 1..5-mer counts plus GC/strandedness stats (Clade.java:25-47);
queries match the reference clade with the smallest k-mer-frequency
difference, with the 5-mer difference as the primary signal and GC as a
pruning key (CladeIndex.java findBestBinary's gc/hh-pruned absdif scan,
:290). Here profiles are numpy frequency vectors and the comparison is a
batched absolute-difference matrix (one [Q, R] einsum-shaped pass —
pruning is unnecessary at this scale; the GC key is retained for parity
of output).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..ops.kmers import rolling_kmers_np

KS = (1, 2, 3, 4, 5)
W5 = {1: 0.05, 2: 0.1, 3: 0.15, 4: 0.25, 5: 0.45}  # k5 primary


def _canon_map(k: int) -> np.ndarray:
    """kmer id -> canonical id (min of self and rc)."""
    n = 1 << (2 * k)
    ids = np.arange(n, dtype=np.int64)
    rc = np.zeros(n, dtype=np.int64)
    x = ids.copy()
    for _ in range(k):
        rc = (rc << 2) | (3 - (x & 3))
        x >>= 2
    return np.minimum(ids, rc)


_CANON = {k: _canon_map(k) for k in KS}


@dataclass
class Clade:
    name: str
    freqs: dict = field(default_factory=dict)  # k -> canonical freq vector
    gc: float = 0.0
    bases: int = 0


def profile_codes(chunks, name: str) -> Clade:
    """Build a Clade from an iterable of code arrays."""
    counts = {k: np.zeros(1 << (2 * k), dtype=np.int64) for k in KS}
    gc = 0
    total = 0
    for codes in chunks:
        codes = np.asarray(codes, np.uint8)
        total += len(codes)
        gc += int(((codes == 1) | (codes == 2)).sum())
        for k in KS:
            fwd, _, runlen = rolling_kmers_np(codes[None, :], k)
            valid = runlen[0] >= k
            np.add.at(counts[k], fwd[0][valid], 1)
    c = Clade(name)
    c.bases = total
    c.gc = gc / max(total, 1)
    for k in KS:
        folded = np.bincount(
            _CANON[k], weights=counts[k].astype(np.float64),
            minlength=1 << (2 * k),
        )
        vec = folded[np.unique(_CANON[k])]  # canonical slots only
        s = vec.sum()
        c.freqs[k] = vec / s if s else vec
    return c


def profile_fasta(path: str) -> Clade:
    from ..core.dna import BASE_TO_CODE

    def chunks():
        for rec in iter_fasta(path):
            yield BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]

    return profile_codes(chunks(), path)


def compare(a: Clade, b: Clade) -> float:
    """Weighted mean absolute frequency difference (lower = closer)."""
    d = 0.0
    for k in KS:
        d += W5[k] * float(np.abs(a.freqs[k] - b.freqs[k]).sum())
    return d


def classify(query: Clade, refs: list[Clade]):
    scored = sorted(
        ((compare(query, r), r) for r in refs), key=lambda t: t[0]
    )
    return scored


def save_db(clades: list[Clade], path: str) -> None:
    """CladeLoader role (clade/CladeLoader.java): persist reference
    clade profiles as one .npz the server/classifier can load."""
    arrs = {}
    names = []
    for i, c in enumerate(clades):
        names.append(c.name)
        arrs[f"gc_{i}"] = np.float64(c.gc)
        arrs[f"bases_{i}"] = np.int64(c.bases)
        for k in KS:
            arrs[f"f{k}_{i}"] = c.freqs[k].astype(np.float32)
    arrs["names"] = np.array(names)
    np.savez_compressed(path, **arrs)


def load_db(path: str) -> list[Clade]:
    data = np.load(path, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    out = []
    for i, name in enumerate(names):
        c = Clade(name)
        c.gc = float(data[f"gc_{i}"])
        c.bases = int(data[f"bases_{i}"])
        for k in KS:
            c.freqs[k] = data[f"f{k}_{i}"].astype(np.float64)
        out.append(c)
    return out


def cladeloader_main(argv=None):
    """cladeloader.sh -> clade.CladeLoader: build a clade profile DB
    from reference fastas (one profile per file, or per=sequence for
    one per record)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    out = a.get("out", "db")
    paths = [p.strip() for p in (a.get("ref", "in") or "").split(",")
             if p.strip()]
    if not out or not paths:
        raise ValueError(
            "Usage: cladeloader ref=a.fa,b.fa out=db.npz [per=file|sequence]")
    per_seq = (a.get("per", default="file").lower() in
               ("sequence", "seq", "record"))
    clades = []
    from ..core.dna import BASE_TO_CODE

    for p in paths:
        if per_seq:
            for rec in iter_fasta(p):
                clades.append(profile_codes(
                    [BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]],
                    rec.name.decode(errors="replace")))
        else:
            clades.append(profile_fasta(p))
    save_db(clades, out)
    print(f"Saved {len(clades)} clade profiles to {out}", file=sys.stderr)
    return 0


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    refs = [
        profile_fasta(p.strip())
        for p in (a.get("ref") or "").split(",")
        if p.strip()
    ]
    if a.get("db"):
        refs.extend(load_db(a.get("db")))
    if not refs:
        raise ValueError("quickclade requires ref=a.fa,b.fa,... or db=")
    in1 = a.get("in", "in1")
    out_rows = []
    for rec in iter_fasta(in1):
        from ..core.dna import BASE_TO_CODE

        q = profile_codes(
            [BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]],
            rec.name.decode(errors="replace"),
        )
        scored = classify(q, refs)
        best_d, best = scored[0]
        second = scored[1][0] if len(scored) > 1 else float("inf")
        out_rows.append((q.name, best.name, best_d, second, q.gc))
        print(
            f"{q.name}\t{best.name}\tdif={best_d:.5f}"
            f"\tsecond={second:.5f}\tgc={q.gc:.3f}"
        )
    return out_rows
