"""Protein tools — proteinsearch/clusterproteins/markerfactory/
markervector/magqc (prot/ package).

Reference mains and semantics:
  - proteinsearch.sh -> prot.ProteinSearch(+ProteinSearcher): blastp-
    style search. K-mer (k=5) seeding picks candidate targets (>=
    minSeedHits shared distinct kmers), each candidate is aligned with
    a Smith-Waterman affine-gap BLOSUM62 aligner (Gotoh; gap open 11,
    extend 1; AAAligner.java), hits filtered by rawScore/pident/evalue
    with BLAST statistics lambda=0.267 K=0.041 (Blosum62.java:28-37),
    written as BLAST outfmt-6 TSV in the frozen total order (query asc,
    evalue asc, bitscore desc, target asc, tstart, qstart)
    (ProteinSearcher.java:95-250).
  - clusterproteins.sh -> prot.ProteinClusterer: greedy longest-first
    identity clustering (CD-HIT-style): each sequence joins the best
    representative with pident >= threshold and coverage >= mincov,
    else becomes a new representative; output rep<TAB>member rows
    (ProteinClusterer.java:13-42).
  - markerfactory.sh -> prot.MarkerFactory: cluster all proteins across
    a manifest of per-genome FASTAs; marker families = clusters present
    exactly once in >= selectionThreshold of the genomes.
  - markervector.sh -> prot.MarkerVectorizer: count a bin's hits per
    marker family -> fixed-order count vector + derived completeness/
    contamination scalars.
  - magqc.sh -> prot.MagQC: CheckM1-style report from a marker vector:
    completeness = detected/denominator, contamination = excess copies/
    denominator (MagQC.java:19-31).

The BLOSUM62 matrix is the standard public NCBI constant.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..core.parser import tokenize

AAS = "ARNDCQEGHILKMFPSTWYV"
AA_INDEX = {c: i for i, c in enumerate(AAS)}
X = 20  # ambiguous

_BLOSUM62_TEXT = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -2
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -2  4
"""

BLOSUM62 = np.array(
    [[int(v) for v in row.split()] for row in _BLOSUM62_TEXT.strip().split(
        "\n")], np.int32)
# pad with X row/col (score -1 vs everything, matching common practice)
_M = np.full((21, 21), -1, np.int32)
_M[:20, :20] = BLOSUM62
MATRIX = _M

GAP_OPEN, GAP_EXTEND = 11, 1
LAMBDA, KPARAM = 0.267, 0.041
LN2 = math.log(2.0)


def encode_protein(seq: bytes) -> np.ndarray:
    out = np.full(len(seq), X, np.int8)
    for i, ch in enumerate(seq.upper().decode(errors="replace")):
        out[i] = AA_INDEX.get(ch, X)
    return out


def sw_align(q: np.ndarray, t: np.ndarray):
    """Gotoh local affine SW with traceback (AAAligner semantics).
    Returns None if best score <= 0, else a dict of HSP fields."""
    m, n = len(q), len(t)
    if m == 0 or n == 0:
        return None
    NEG = -(1 << 28)
    M = np.zeros((m + 1, n + 1), np.int32)
    Ix = np.full((m + 1, n + 1), NEG, np.int32)  # gap in target
    Iy = np.full((m + 1, n + 1), NEG, np.int32)  # gap in query
    ptrM = np.zeros((m + 1, n + 1), np.int8)  # 0 diag, 1 fromIx, 2 fromIy
    ptrX = np.zeros((m + 1, n + 1), np.int8)  # 0 open, 1 extend
    ptrY = np.zeros((m + 1, n + 1), np.int8)
    sub_rows = MATRIX[q.astype(np.int32)]  # [m, 21]
    best, bi, bj = 0, 0, 0
    tt = t.astype(np.int32)
    for i in range(1, m + 1):
        s = sub_rows[i - 1][tt]  # [n]
        mprev = M[i - 1, :-1]
        xprev = Ix[i - 1, :-1]
        yprev = Iy[i - 1, :-1]
        dstate = np.where(mprev >= xprev, 0, 1).astype(np.int8)
        dbest = np.maximum(mprev, xprev)
        dstate = np.where(yprev > dbest, 2, dstate)
        dbest = np.maximum(dbest, yprev)
        mm = dbest + s
        # local floor
        ptrM[i, 1:] = np.where(mm > 0, dstate, 0)
        M[i, 1:] = np.maximum(mm, 0)
        # Ix: gap in target (consume query) — vertical
        open_x = M[i - 1, 1:] - (GAP_OPEN + GAP_EXTEND)
        ext_x = Ix[i - 1, 1:] - GAP_EXTEND
        Ix[i, 1:] = np.maximum(open_x, ext_x)
        ptrX[i, 1:] = (ext_x > open_x).astype(np.int8)
        # Iy: gap in query (consume target) — horizontal, sequential
        # relaxation Iy[i,j] = max(M[i,j-1]-open-ext, Iy[i,j-1]-ext)
        cur = NEG
        for j in range(1, n + 1):
            opn = M[i, j - 1] - (GAP_OPEN + GAP_EXTEND)
            ext = cur - GAP_EXTEND
            if ext > opn:
                cur = ext
                ptrY[i, j] = 1
            else:
                cur = opn
                ptrY[i, j] = 0
            Iy[i, j] = cur
        row_best = int(M[i].max())
        if row_best > best:
            best = row_best
            bi, bj = i, int(M[i].argmax())
    if best <= 0:
        return None
    # traceback from (bi, bj) in state M
    i, j, state = bi, bj, 0
    identities = mismatches = gap_opens = length = 0
    qstop, tstop = bi - 1, bj - 1
    while i > 0 and j > 0:
        if state == 0:
            if M[i, j] == 0:
                break
            length += 1
            if q[i - 1] == t[j - 1] and q[i - 1] != X:
                identities += 1
            else:
                mismatches += 1
            state = int(ptrM[i, j])
            i -= 1
            j -= 1
        elif state == 1:  # Ix: query residue vs gap
            length += 1
            if ptrX[i, j] == 0:
                gap_opens += 1
                state = 0
            i -= 1
        else:  # Iy: target residue vs gap
            length += 1
            if ptrY[i, j] == 0:
                gap_opens += 1
                state = 0
            j -= 1
    qstart, tstart = i, j
    return {
        "rawScore": best, "qstart": qstart, "qstop": qstop,
        "tstart": tstart, "tstop": tstop, "identities": identities,
        "mismatches": mismatches, "gapOpens": gap_opens, "length": length,
    }


def pident(h) -> float:
    return 0.0 if h["length"] == 0 else 100.0 * h["identities"] / h["length"]


def bitscore(h) -> float:
    return (LAMBDA * h["rawScore"] - math.log(KPARAM)) / LN2


def evalue(h, search_space: float) -> float:
    return search_space * KPARAM * math.exp(-LAMBDA * h["rawScore"])


def _kmer_set(enc: np.ndarray, k: int = 5) -> set:
    out = set()
    km = 0
    valid = 0
    mask = (1 << (5 * k)) - 1
    for e in enc:
        if e >= 20:
            km, valid = 0, 0
            continue
        km = ((km << 5) | int(e)) & mask
        valid += 1
        if valid >= k:
            out.add(km)
    return out


def _read_proteins(path):
    from ..io.fasta import iter_fasta

    out = []
    seen = set()
    for rec in iter_fasta(path):
        rid = rec.name.split()[0].decode()
        if rid in seen:
            raise RuntimeError(f"Duplicate identifier: '{rid}'")
        seen.add(rid)
        out.append((rid, encode_protein(rec.seq)))
    return out


def search(queries, targets, k=5, min_seed_hits=1, min_raw=1,
           min_pident=0.0, evalue_cutoff=10.0, max_targets=500):
    """ProteinSearcher.search — returns outfmt6-ready hit dicts."""
    total_db = sum(len(t) for _, t in targets)
    index: dict[int, list[int]] = {}
    for ti, (_, enc) in enumerate(targets):
        for km in _kmer_set(enc, k):
            index.setdefault(km, []).append(ti)
    all_hits = []
    for qid, q in queries:
        space = float(len(q)) * total_db
        qk = _kmer_set(q, k)
        counts: dict[int, int] = {}
        if not qk:
            cand = range(len(targets))
        else:
            for km in qk:
                for ti in index.get(km, ()):
                    counts[ti] = counts.get(ti, 0) + 1
            cand = [ti for ti, c in counts.items() if c >= min_seed_hits]
        qhits = []
        for ti in cand:
            tid, tenc = targets[ti]
            h = sw_align(q, tenc)
            if h is None or h["rawScore"] < min_raw:
                continue
            if pident(h) < min_pident:
                continue
            e = evalue(h, space)
            if e > evalue_cutoff:
                continue
            h["query"], h["target"], h["evalue"] = qid, tid, e
            h["bitscore"] = bitscore(h)
            qhits.append(h)
        qhits.sort(key=lambda h: (-h["bitscore"], h["target"]))
        all_hits.extend(qhits[:max_targets])
    all_hits.sort(key=lambda h: (h["query"], h["evalue"], -h["bitscore"],
                                 h["target"], h["tstart"], h["qstart"]))
    return all_hits


def _fmt6(h) -> str:
    return (f"{h['query']}\t{h['target']}\t{pident(h):.3f}\t{h['length']}"
            f"\t{h['mismatches']}\t{h['gapOpens']}\t{h['qstart'] + 1}"
            f"\t{h['qstop'] + 1}\t{h['tstart'] + 1}\t{h['tstop'] + 1}"
            f"\t{h['evalue']:.2e}\t{h['bitscore']:.1f}")


def proteinsearch_main(args):
    a = tokenize(args)
    qpath, dbpath = a.get("query", "in", "in1"), a.get("db", "ref")
    if not qpath or not dbpath:
        print("Usage: proteinsearch query=<fa> db=<fa> [out=] [k=5]"
              " [minpident=0] [evalue=10]", file=sys.stderr)
        return 1
    hits = search(
        _read_proteins(qpath), _read_proteins(dbpath),
        k=int(a.get("k", default="5")),
        min_seed_hits=int(a.get("minseedhits", default="1")),
        min_pident=float(a.get("minpident", "pident", default="0")),
        evalue_cutoff=float(a.get("evalue", default="10")),
        max_targets=int(a.get("maxtargetseqs", default="500")),
    )
    text = "\n".join(_fmt6(h) for h in hits) + ("\n" if hits else "")
    out = a.get("out", "out1")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"{len(hits)} hits.", file=sys.stderr)
    return 0


def cluster(proteins, min_id=50.0, min_cov=0.8):
    """Greedy longest-first clustering; returns {rep_id: [member_ids]}."""
    order = sorted(range(len(proteins)), key=lambda i: -len(proteins[i][1]))
    reps: list[int] = []
    clusters: dict[str, list[str]] = {}
    assign: dict[str, str] = {}
    for i in order:
        pid_i, enc = proteins[i]
        best_rep, best_id = None, -1.0
        for r in reps:
            rid, renc = proteins[r]
            h = sw_align(enc, renc)
            if h is None:
                continue
            cov = h["length"] / max(len(enc), 1)
            if pident(h) >= min_id and cov >= min_cov and pident(h) > best_id:
                best_rep, best_id = rid, pident(h)
        if best_rep is None:
            reps.append(i)
            clusters[pid_i] = [pid_i]
            assign[pid_i] = pid_i
        else:
            clusters[best_rep].append(pid_i)
            assign[pid_i] = best_rep
    return clusters


def clusterproteins_main(args):
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: clusterproteins in=<proteins.fa> out=<tsv>"
              " [minid=50] [mincov=0.8]", file=sys.stderr)
        return 1
    prots = _read_proteins(inpath)
    clusters = cluster(
        prots, min_id=float(a.get("minid", "id", default="50")),
        min_cov=float(a.get("mincov", "cov", default="0.8")))
    lines = []
    for rep in sorted(clusters):
        for mem in clusters[rep]:
            lines.append(f"{rep}\t{mem}")
    out = a.get("out", "out1")
    text = "\n".join(lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"{len(clusters)} clusters over {len(prots)} proteins.",
          file=sys.stderr)
    return 0


def markerfactory_main(args):
    """Build single-copy marker families from per-genome protein FASTAs
    (manifest= one path per line, or in=a.faa,b.faa,...)."""
    a = tokenize(args)
    paths = [p for p in (a.get("in", "in1") or "").split(",") if p]
    if a.get("manifest"):
        paths += [ln.strip() for ln in open(a.get("manifest"))
                  if ln.strip() and not ln.startswith("#")]
    out = a.get("out")
    if not paths or not out:
        print("Usage: markerfactory in=<g1.faa,g2.faa,...>|manifest=<txt>"
              " out=<markers.tsv> [minid=50] [selection=0.9]",
              file=sys.stderr)
        return 1
    min_id = float(a.get("minid", default="50"))
    selection = float(a.get("selection", "selectionthreshold", default="0.9"))
    all_prots = []
    genome_of = {}
    for gi, p in enumerate(paths):
        for pid_, enc in _read_proteins(p):
            uid = f"g{gi}|{pid_}"
            all_prots.append((uid, enc))
            genome_of[uid] = gi
    clusters = cluster(all_prots, min_id=min_id, min_cov=0.7)
    enc_of = dict(all_prots)
    markers = []
    for rep, members in clusters.items():
        per_genome: dict[int, int] = {}
        for m in members:
            g = genome_of[m]
            per_genome[g] = per_genome.get(g, 0) + 1
        single = sum(1 for c in per_genome.values() if c == 1)
        if single >= selection * len(paths) and all(
                c == 1 for c in per_genome.values()):
            markers.append((rep, len(per_genome)))
    from ..core.parser import parse_boolean  # noqa: F401
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        fh.write(b"#marker\tgenomes\trepseq\n")
        for rep, ng in sorted(markers):
            seq = "".join(AAS[c] if c < 20 else "X" for c in enc_of[rep])
            fh.write(f"{rep}\t{ng}\t{seq}\n".encode())
    print(f"{len(markers)} single-copy markers from {len(paths)} genomes"
          f" ({len(clusters)} families).", file=sys.stderr)
    return 0


def _load_markers(path):
    from ..io.readwrite import read_bytes

    out = []
    for ln in read_bytes(path).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(b"\t")
        out.append((f[0].decode(), encode_protein(f[2])))
    return out


def markervector_main(args):
    a = tokenize(args)
    inpath, markers_p, out = a.get("in", "in1"), a.get("markers", "ref"), \
        a.get("out")
    if not inpath or not markers_p:
        print("Usage: markervector in=<bin.faa> markers=<markers.tsv>"
              " [out=] [minid=50]", file=sys.stderr)
        return 1
    min_id = float(a.get("minid", default="50"))
    markers = _load_markers(markers_p)
    prots = _read_proteins(inpath)
    counts = np.zeros(len(markers), np.int64)
    for pid_, enc in prots:
        best_mi, best_id = -1, -1.0
        for mi, (mid, menc) in enumerate(markers):
            h = sw_align(enc, menc)
            if h is None:
                continue
            p = pident(h)
            cov = h["length"] / max(len(menc), 1)
            if p >= min_id and cov >= 0.7 and p > best_id:
                best_mi, best_id = mi, p
        if best_mi >= 0:
            counts[best_mi] += 1
    detected = int((counts > 0).sum())
    excess = int(np.maximum(counts - 1, 0).sum())
    denom = max(len(markers), 1)
    completeness = 100.0 * detected / denom
    contamination = 100.0 * excess / denom
    lines = ["#marker\tcount"]
    lines += [f"{mid}\t{int(c)}" for (mid, _), c in zip(markers, counts)]
    lines.append(f"#completeness\t{completeness:.2f}")
    lines.append(f"#contamination\t{contamination:.2f}")
    text = "\n".join(lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"completeness={completeness:.2f}%"
          f" contamination={contamination:.2f}%", file=sys.stderr)
    return 0


def magqc_main(args):
    """magqc.sh: QC report from a markervector TSV."""
    a = tokenize(args)
    inpath = a.get("in", "in1", "vector")
    if not inpath:
        print("Usage: magqc in=<vector.tsv (markervector output)> [out=]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    counts = []
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        counts.append(int(ln.split(b"\t")[1]))
    c = np.array(counts, np.int64)
    denom = max(len(c), 1)
    detected = int((c > 0).sum())
    excess = int(np.maximum(c - 1, 0).sum())
    multi = int((c > 1).sum())
    rows = [
        ("markers", len(c)),
        ("detected", detected),
        ("multiCopyMarkers", multi),
        ("excessCopies", excess),
        ("completeness", f"{100.0 * detected / denom:.2f}"),
        ("contamination", f"{100.0 * excess / denom:.2f}"),
        ("contaminationMulti", f"{100.0 * multi / denom:.2f}"),
    ]
    text = "\n".join(f"{k}\t{v}" for k, v in rows) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0
