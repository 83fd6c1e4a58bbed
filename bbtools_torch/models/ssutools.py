"""SSU/Silva ribosomal tool family.

Reference mains:
  - comparessu.sh -> sketch.CompareSSU: all-to-all (or one-per-level)
    SSU identity comparisons grouped by the taxonomic level of the
    pair's common ancestor; rows `level  identity  qid  rid` plus a
    per-level summary (CompareSSU.java:404-447).
  - findssu.sh -> ddl.SSUCompare: best SSU match per query vs a ref
    panel.
  - filtersilva.sh -> prok.FilterSilva: drop Silva records with no
    parseable taxonomy, and euk-classified records whose header names
    them organellar (Chloroplast/Mitochondria) or cross-domain
    (Bacteria;/Archaea;) (FilterSilva.java:236-251).
  - reducesilva.sh -> driver.ReduceSilva: keep the first record per
    taxon at semicolon column N from the end (ReduceSilva.java:276-284).
  - addssu.sh -> sketch.AddSSU: merge per-taxID 16S/18S files into one
    SSU set (the reference attaches them to TaxTree nodes; here the
    merged per-tid fasta is the artifact the other ribo tools consume).
  - idtree.sh -> tax.IDTree: identity matrix TSV -> UPGMA Newick tree.
  - trnaconsensus.sh -> prok.TrnaConsensusBuilder: majority consensus
    over tRNA sequences.

Pairwise identities run through the batched glocal aligner on the run's
device (models/ribo._batch_identities -> ops/idalign.glocal_identity;
`device=`, cuda by default), one call per query row instead of per-pair
host loops. Every other function is the JAX package's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import parse_boolean, tokenize


def _read_fasta_records(path):
    from ..io.fasta import iter_fasta

    return list(iter_fasta(path))


def _tid_of(name: bytes) -> int:
    """taxID from `tid|1234` / `tid_1234` / `ncbi 1234` header tokens."""
    for sep in (b"tid|", b"tid_", b"ncbi:", b"taxid="):
        p = name.find(sep)
        if p >= 0:
            tail = name[p + len(sep):]
            num = tail.split(b"|")[0].split(b"_")[0].split()[0]
            try:
                return int(num)
            except ValueError:
                continue
    tok = name.split(b"|")[0].split()[0]
    try:
        return int(tok)
    except ValueError:
        return -1




def comparessu_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath:
        print("Usage: comparessu in=<ssu fasta (tid headers)> [out=]"
              " [tree=<taxtree.npz>] [ata=f] [minlen=0] [maxns=-1]",
              file=sys.stderr)
        return 1
    from ..device import resolve_device

    device = resolve_device(a.get("device", default="cuda"))
    all_to_all = parse_boolean(a.get("ata", "alltoall", default="f"))
    minlen = int(a.get("minlen", "minlength", default="0"))
    maxlen = int(a.get("maxlen", "maxlength", default="1000000"))
    tree = None
    if a.get("tree"):
        from .taxonomy import TaxTree

        tree = TaxTree.load_tree(a.get("tree"))
    from ..core.dna import encode
    from .ribo import _batch_identities

    recs = [(r.name, encode(r.seq)) for r in _read_fasta_records(inpath)
            if minlen <= len(r.seq) <= maxlen]
    tids = [_tid_of(n) for n, _ in recs]
    seqs = [s for _, s in recs]
    n = len(recs)
    lines = []
    counts = {}
    sums = {}
    for qi in range(n):
        if tids[qi] <= 0:
            continue
        cands = [ri for ri in range(n) if ri != qi and tids[ri] > 0]
        if not cands:
            continue
        levels = []
        keep = []
        seen = set()
        for ri in cands:
            if tree is not None:
                from .taxonomy import LEVELS

                aid = tree.common_ancestor(tids[qi], tids[ri])
                lvl = (LEVELS[int(tree.level[aid])]
                       if tree.valid(aid) else "unknown")
            else:
                lvl = "all" if all_to_all else "pair"
            if not all_to_all and lvl in seen:
                continue
            seen.add(lvl)
            keep.append(ri)
            levels.append(lvl)
        if not keep:
            continue
        ident = _batch_identities([seqs[qi]],
                                  [seqs[ri] for ri in keep], device)[0]
        for lvl, ri, idv in zip(levels, keep, ident):
            lines.append(f"{lvl}\t{idv:.6f}\t{tids[qi]}\t{tids[ri]}")
            counts[lvl] = counts.get(lvl, 0) + 1
            sums[lvl] = sums.get(lvl, 0.0) + float(idv)
    text = "\n".join(lines) + "\n" if lines else ""
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print("#level\tcount\tmeanID", file=sys.stderr)
    for lvl in sorted(counts):
        print(f"{lvl}\t{counts[lvl]}\t{sums[lvl] / counts[lvl]:.6f}",
              file=sys.stderr)
    return 0


def findssu_main(args):
    """findssu.sh -> ddl.SSUCompare: best ref panel match per query."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    refpath = a.get("ref")
    if not inpath:
        print("Usage: findssu in=<queries.fa> [ref=<panel.fa>] [out=]"
              " (default panel: bundled SSU consensus set)",
              file=sys.stderr)
        return 1
    from ..core.dna import encode
    from ..device import resolve_device
    from .ribo import _batch_identities, load_consensus

    device = resolve_device(a.get("device", default="cuda"))

    if refpath:
        panel = [(r.name.decode(), encode(r.seq))
                 for r in _read_fasta_records(refpath)]
    else:
        panel = [
            (f"{t}_{i}", rec)
            for t, recs in load_consensus(
                ("16S", "18S", "23S", "5S", "m16S", "p16S"))
            for i, rec in enumerate(recs)
        ]
    out_lines = ["#query\tbest\tidentity"]
    for rec in _read_fasta_records(inpath):
        q = encode(rec.seq)
        ident = _batch_identities([q], [s for _, s in panel], device)[0]
        best = int(np.argmax(ident))
        out_lines.append(
            f"{rec.name.decode()}\t{panel[best][0]}\t{float(ident[best]):.6f}")
    out = a.get("out", "out1")
    text = "\n".join(out_lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    return 0


def filtersilva_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: filtersilva in=<silva.fa> out=<clean.fa>",
              file=sys.stderr)
        return 1
    from ..io.readwrite import open_output

    kept = dropped = 0
    with open_output(out) as fh:
        for rec in _read_fasta_records(inpath):
            name = rec.name
            # Silva headers: "<acc> <Domain>;<path>;...;<species>"
            sp = name.find(b" ")
            tax = name[sp + 1:] if sp >= 0 else b""
            keep = b";" in tax
            if keep and tax.startswith(b"Eukaryota"):
                if (b";Chloroplast;" in name or b"Mitochondria" in name
                        or b"Bacteria;" in tax[10:]
                        or b"Archaea;" in tax[10:]):
                    keep = False
            if keep:
                kept += 1
                fh.write(b">" + name + b"\n" + rec.seq + b"\n")
            else:
                dropped += 1
    print(f"Kept {kept}, dropped {dropped}.", file=sys.stderr)
    return 0


def reducesilva_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: reducesilva in=<silva.fa> out=<fa> [column=1]",
              file=sys.stderr)
        return 1
    column = int(a.get("column", default="1"))
    from ..io.readwrite import open_output

    seen = set()
    kept = 0
    with open_output(out) as fh:
        for rec in _read_fasta_records(inpath):
            parts = rec.name.split(b";")
            if len(parts) <= column:
                taxa = None
            else:
                taxa = parts[len(parts) - column - 1]
            if taxa is not None:
                if taxa in seen:
                    continue
                seen.add(taxa)
            kept += 1
            fh.write(b">" + rec.name + b"\n" + rec.seq + b"\n")
    print(f"Kept {kept} records ({len(seen)} taxa).", file=sys.stderr)
    return 0


def addssu_main(args):
    """addssu.sh: merge 16S= and 18S= per-taxID fastas into out=; on tid
    collision euks prefer 18S, proks prefer 16S (needs tree=); without a
    tree, first file wins (16S)."""
    a = tokenize(args)
    f16, f18, out = a.get("16s", "16sfile"), a.get("18s", "18sfile"), a.get(
        "out")
    if not out or not (f16 or f18):
        print("Usage: addssu 16S=<fa> 18S=<fa> out=<fa> [tree=<npz>]",
              file=sys.stderr)
        return 1
    tree = None
    if a.get("tree"):
        from .taxonomy import TaxTree

        tree = TaxTree.load_tree(a.get("tree"))

    def is_euk(tid: int) -> bool:
        if tree is None or not tree.valid(tid):
            return False
        return tree.is_descendant(tid, 2759)  # Eukaryota

    best: dict[int, tuple[str, bytes, bytes]] = {}
    for path, kind in ((f16, "16S"), (f18, "18S")):
        if not path:
            continue
        for rec in _read_fasta_records(path):
            tid = _tid_of(rec.name)
            if tid <= 0:
                continue
            prefer = "18S" if is_euk(tid) else "16S"
            cur = best.get(tid)
            if cur is None or (kind == prefer and cur[0] != prefer):
                best[tid] = (kind, rec.name, rec.seq)
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        for tid in sorted(best):
            kind, name, seq = best[tid]
            fh.write(b">tid|%d|%s %s\n%s\n"
                     % (tid, kind.encode(), name, seq))
    print(f"Wrote {len(best)} SSU records.", file=sys.stderr)
    return 0


def idtree_main(args):
    """idtree.sh -> tax.IDTree: identity matrix TSV -> UPGMA Newick."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: idtree in=<identity matrix tsv> [out=<newick>]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    rows = [ln.split(b"\t") for ln in read_bytes(inpath).split(b"\n")
            if ln.strip()]
    # matrix with optional header row/col of names
    if all(_is_float(x) for x in rows[0][1:]) and not _is_float(rows[0][0]):
        names = [r[0].decode() for r in rows]
        mat = np.array([[float(x) for x in r[1:]] for r in rows])
    elif not any(_is_float(x) for x in rows[0]):
        names = [x.decode() for x in rows[0]]
        mat = np.array([[float(x) for x in r] for r in rows[1:]])
    else:
        names = [f"n{i}" for i in range(len(rows))]
        mat = np.array([[float(x) for x in r] for r in rows])
    if mat.max() > 1.5:  # percent identities
        mat = mat / 100.0
    newick = upgma_newick(1.0 - mat, names)
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(newick + "\n")
    else:
        print(newick)
    return 0


def _is_float(x: bytes) -> bool:
    try:
        float(x)
        return True
    except ValueError:
        return False


def upgma_newick(dist: np.ndarray, names: list[str]) -> str:
    """UPGMA clustering of a distance matrix -> Newick string."""
    n = len(names)
    d = dist.astype(float).copy()
    np.fill_diagonal(d, np.inf)
    clusters = {i: (names[i], 1, 0.0) for i in range(n)}  # (nwk, size, h)
    active = list(range(n))
    nxt = n
    full = np.full((2 * n, 2 * n), np.inf)
    full[:n, :n] = d
    while len(active) > 1:
        best = (np.inf, None, None)
        for ii, i in enumerate(active):
            for j in active[ii + 1:]:
                if full[i, j] < best[0]:
                    best = (full[i, j], i, j)
        dij, i, j = best
        ni, nj = clusters.pop(i), clusters.pop(j)
        h = dij / 2
        nwk = (f"({ni[0]}:{max(h - ni[2], 0):.5f},"
               f"{nj[0]}:{max(h - nj[2], 0):.5f})")
        size = ni[1] + nj[1]
        clusters[nxt] = (nwk, size, h)
        active = [x for x in active if x not in (i, j)]
        for x in active:
            full[nxt, x] = full[x, nxt] = (
                ni[1] * full[i, x] + nj[1] * full[j, x]) / size
        active.append(nxt)
        nxt += 1
    root = clusters[active[0]]
    return root[0] + ";"


def trnaconsensus_main(args):
    """trnaconsensus.sh: per-length-bin majority consensus of tRNAs."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: trnaconsensus in=<trna.fa> out=<consensus.fa>",
              file=sys.stderr)
        return 1
    from ..core.dna import decode, encode

    recs = _read_fasta_records(inpath)
    if not recs:
        print("No input records.", file=sys.stderr)
        return 1
    lens = np.array([len(r.seq) for r in recs])
    modal = int(np.bincount(lens).argmax())
    keep = [r for r in recs if abs(len(r.seq) - modal) <= 3]
    L = modal
    counts = np.zeros((L, 5), np.int64)
    for r in keep:
        c = encode(r.seq)[:L]
        idx = np.where(c < 4, c, 4)
        counts[np.arange(len(idx)), idx] += 1
    cons = counts[:, :4].argmax(axis=1).astype(np.uint8)
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        fh.write(b">tRNA_consensus n=%d len=%d\n%s\n"
                 % (len(keep), L, decode(cons)))
    print(f"Consensus over {len(keep)}/{len(recs)} records, len {L}.",
          file=sys.stderr)
    return 0


class HMMSearchLine:
    """One hmmsearch --domtblout row (hmm/HMMSearchLine.java:37-176).

    Whitespace-tokenized with the reference's exact 23-field typing:
    name/field1/hmmName/accession/field22 strings; length(tlen) and
    qlen + the six domain coordinates ints; E-values doubles; scores /
    biases / acc floats.  field22 is the FIRST token of the free-text
    description — the reference stops tokenizing there too."""

    __slots__ = (
        "name", "field1", "length", "hmm_name", "accession", "qlen",
        "evalue", "score", "bias", "dom_n", "dom_of", "c_evalue",
        "i_evalue", "dom_score", "dom_bias", "hmm_from", "hmm_to",
        "ali_from", "ali_to", "env_from", "env_to", "acc", "field22",
    )

    def __init__(self, line: bytes):
        f = line.split()
        if len(f) < 23:
            raise ValueError(f"domtbl line has {len(f)} fields, need 23")
        (self.name, self.field1) = (f[0], f[1])
        self.length = int(f[2])
        (self.hmm_name, self.accession) = (f[3], f[4])
        self.qlen = int(f[5])
        self.evalue = float(f[6])
        self.score = float(f[7])
        self.bias = float(f[8])
        self.dom_n = float(f[9])
        self.dom_of = float(f[10])
        self.c_evalue = float(f[11])
        self.i_evalue = float(f[12])
        self.dom_score = float(f[13])
        self.dom_bias = float(f[14])
        self.hmm_from = int(f[15])
        self.hmm_to = int(f[16])
        self.ali_from = int(f[17])
        self.ali_to = int(f[18])
        self.env_from = int(f[19])
        self.env_to = int(f[20])
        self.acc = float(f[21])
        self.field22 = f[22]

    def to_text(self) -> bytes:
        # HMMSearchLine.toText: name \t length \t hmmName
        return b"%s\t%d\t%s" % (self.name, self.length, self.hmm_name)


class ProteinSummary:
    """hmm/ProteinSummary.java: per-query map of name -> max hit length
    (keyed by line.name, preserving the reference's behavior)."""

    def __init__(self, name: bytes):
        self.name = name
        self.map: dict[bytes, int] = {}

    def add(self, line: HMMSearchLine) -> bool:
        old = self.map.get(line.name)
        if old is None or old < line.length:
            self.map[line.name] = line.length
            return True
        return False


def parse_domtbl(path: str):
    """Load an hmmsearch --domtblout report: skip blank and '#' comment
    lines, parse the rest (HMMSearchReport.load :229-246). Returns
    (lines, summary_map, lines_processed, bytes_processed)."""
    from ..io.readwrite import open_input

    lines: list[HMMSearchLine] = []
    summaries: dict[bytes, ProteinSummary] = {}
    nlines = nbytes = 0
    with open_input(path) as fh:
        for raw in fh:
            raw = raw.rstrip(b"\r\n")
            if not raw:
                continue
            nlines += 1
            nbytes += len(raw) + 1
            if raw.startswith(b"#"):
                continue
            hl = HMMSearchLine(raw)
            lines.append(hl)
            ps = summaries.get(hl.name)
            if ps is None:
                ps = ProteinSummary(hl.name)
                summaries[hl.name] = ps
            ps.add(hl)
    return lines, summaries, nlines, nbytes


def runhmm_main(args):
    """runhmm.sh -> hmm.HMMSearchReport: parses an hmmsearch domtbl
    report (in=), builds the per-protein summary map, and echoes each
    parsed line as `name\\tlength\\thmmName` (HMMSearchReport
    processInner :200-206 + toText).  The reference does NOT run
    hmmsearch itself — it is purely the report parser."""
    import time

    a = tokenize(args)
    path = a.get("in", "in1", default=None)
    if path is None:
        # bare-filename fallback (reference Parser's File-exists branch)
        for k, v in a.pairs:
            if v is None and os.path.exists(k):
                path = k
                break
    if path is None:
        print("runhmm.sh in=<domtbl file>", file=sys.stderr)
        return 1
    t0 = time.time()
    lines, summaries, nlines, nbytes = parse_domtbl(path)
    for hl in lines:
        sys.stderr.buffer.write(hl.to_text() + b"\n")
    dt = max(time.time() - t0, 1e-9)
    print(
        f"Time:                         \t{dt:.3f} seconds.\n"
        f"Lines Processed:    {nlines:9d} \t"
        f"{nlines / dt / 1e3:.2f}k lines/sec\n"
        f"Bytes Processed:    {nbytes:9d} \t"
        f"{nbytes / dt / 1e6:.2f}m bytes/sec",
        file=sys.stderr,
    )
    return 0
