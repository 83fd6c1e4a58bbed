"""Taxonomy — NCBI tree loading and lineage queries (tax/ package).

Reference: tax/TaxTree.java — parses NCBI `names.dmp`/`nodes.dmp`
(tab-pipe-delimited; getNodes :431-470, getNames), normalizes ranks to the
canonical level ladder (taxLevelNames :2611: no rank, subspecies, species,
genus, family, order, class, phylum, kingdom, superkingdom/domain, life),
and answers ancestry queries (commonAncestor :959-975, getAncestorAtLevel,
getLineage). tax/GiToTaxid + AccessionToTaxid map sequence ids; here a
simple `accession<TAB>taxid` table covers that role. The tool surface is
`taxonomy` (print lineages) and `filterbytaxa` (keep/exclude sequences
under given nodes — tax/FilterByTaxa.java).

Host-side component by design: the tree is pointer-chasing metadata, not a
device workload; arrays are numpy (id -> parent / level vectors) so
lineage walks are tight loops over int arrays.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..core.parser import tokenize

LEVELS = [
    "no rank", "subspecies", "species", "genus", "family", "order",
    "class", "phylum", "kingdom", "superkingdom", "domain", "life",
]
LEVEL_OF = {n: i for i, n in enumerate(LEVELS)}
# NCBI rank aliases seen in nodes.dmp, mapped onto the canonical ladder
ALIASES = {
    "strain": "subspecies", "varietas": "subspecies", "forma": "subspecies",
    "subgenus": "genus", "species group": "genus",
    "species subgroup": "genus", "subfamily": "family", "tribe": "family",
    "subtribe": "family", "superfamily": "order", "suborder": "order",
    "infraorder": "order", "parvorder": "order", "superorder": "class",
    "subclass": "class", "infraclass": "class", "cohort": "class",
    "subcohort": "class", "superclass": "phylum", "subphylum": "phylum",
    "subkingdom": "kingdom", "superphylum": "kingdom",
    "cellular root": "domain", "acellular root": "domain", "realm": "domain",
    "clade": "no rank", "section": "genus", "series": "genus",
    "subsection": "genus", "pathogroup": "species", "serogroup": "species",
    "serotype": "subspecies", "genotype": "subspecies",
    "morph": "subspecies", "isolate": "subspecies", "biotype": "subspecies",
    "forma specialis": "subspecies",
}
LIFE_ID = 1


@dataclass
class TaxNode:
    id: int
    pid: int
    level: int
    name: str = ""


class TaxTree:
    def __init__(self, parent: np.ndarray, level: np.ndarray, names: dict):
        self.parent = parent  # int64 [max_id+1], -1 = absent
        self.level = level  # int8
        self.names = names  # id -> scientific name
        self.name_to_id = {v.lower(): k for k, v in names.items()}

    # ---- construction ----
    @classmethod
    def load(cls, names_dmp: str, nodes_dmp: str) -> "TaxTree":
        ids, pids, levels = [], [], []
        with open(nodes_dmp) as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                tid, pid, rank = int(parts[0]), int(parts[1]), parts[2]
                rank = ALIASES.get(rank, rank)
                ids.append(tid)
                pids.append(pid)
                levels.append(LEVEL_OF.get(rank, 0))
        size = max(ids) + 1
        parent = np.full(size, -1, dtype=np.int64)
        level = np.zeros(size, dtype=np.int8)
        parent[ids] = pids
        level[ids] = levels
        if parent[LIFE_ID] == LIFE_ID:
            level[LIFE_ID] = LEVEL_OF["life"]
        names = {}
        with open(names_dmp) as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) >= 4 and parts[3] == "scientific name":
                    names[int(parts[0])] = parts[1]
        return cls(parent, level, names)

    # ---- persistence (.taxtree analog, TaxTree.java main :56-66) ----
    def save(self, path: str) -> None:
        """Serialize to one npz (ids/parents/levels + names table)."""
        ids = np.flatnonzero(self.parent >= 0)
        names_arr = np.array(
            [self.names.get(int(t), "") for t in ids], dtype=object
        )
        np.savez_compressed(
            path,
            size=np.int64(len(self.parent)),
            ids=ids,
            parents=self.parent[ids],
            levels=self.level[ids],
            names=names_arr.astype(str),
        )

    @classmethod
    def load_tree(cls, path: str) -> "TaxTree":
        z = np.load(path, allow_pickle=False)
        size = int(z["size"])
        parent = np.full(size, -1, dtype=np.int64)
        level = np.zeros(size, dtype=np.int8)
        ids = z["ids"]
        parent[ids] = z["parents"]
        level[ids] = z["levels"]
        names = {
            int(t): str(n) for t, n in zip(ids, z["names"]) if n
        }
        return cls(parent, level, names)

    # ---- queries (TaxTree.java :925-1005) ----
    def valid(self, tid: int) -> bool:
        return 0 <= tid < len(self.parent) and self.parent[tid] >= 0

    def lineage(self, tid: int) -> list[int]:
        out = []
        while self.valid(tid):
            out.append(tid)
            p = int(self.parent[tid])
            if p == tid:
                break
            tid = p
        return out

    def ancestor_at_level(self, tid: int, level_name: str) -> int:
        want = LEVEL_OF[level_name]
        for t in self.lineage(tid):
            if int(self.level[t]) >= want:
                return t
        return -1

    def common_ancestor(self, a: int, b: int) -> int:
        seen = set(self.lineage(a))
        for t in self.lineage(b):
            if t in seen:
                return t
        return -1

    def is_descendant(self, tid: int, ancestor: int) -> bool:
        return ancestor in self.lineage(tid)

    def name_of(self, tid: int) -> str:
        return self.names.get(tid, f"tid_{tid}")

    def id_of(self, name: str) -> int:
        return self.name_to_id.get(name.lower(), -1)

    def lineage_string(self, tid: int) -> str:
        """kingdom;...;species formatted lineage (printTaxonomy style)."""
        parts = []
        for t in reversed(self.lineage(tid)):
            lv = int(self.level[t])
            if lv > 0 or t == tid:
                parts.append(f"{LEVELS[lv]}:{self.name_of(t)}")
        return ";".join(parts)

    def resolve(self, token: str) -> int:
        """taxid, name, or accession-style token -> taxid."""
        if token.isdigit():
            return int(token)
        return self.id_of(token)


class AccessionIndex:
    """Scale-grade accession -> taxid (tax/AccessionToTaxid.java role).

    NCBI accession2taxid files run to hundreds of millions of rows; a
    python dict costs ~100 bytes/entry and dies at scale. Here standard
    accessions (<=12 chars of [A-Z0-9_.], version stripped) pack
    injectively into int64 (base-37 per char, 37^12 < 2^63 — the same
    numeric-encoding idea as AccessionToTaxid's char packing), stored as
    ONE sorted int64 array + int32 taxids: 12 bytes/entry, binary-search
    lookups. Parsing is fully vectorized per chunk (numpy field
    extraction, no per-line python); odd accessions fall into a small
    dict sidecar.
    """

    #: A-Z -> 1..26, 0-9 -> 27..36, '_' -> 0 is reserved pad... chars
    #: map 1..37 with 0 = empty so shorter accessions never collide
    _CODE = None

    def __init__(self):
        self.keys = np.zeros(0, np.int64)
        self.taxids = np.zeros(0, np.int32)
        self.extra: dict = {}

    @classmethod
    def _codes(cls):
        if cls._CODE is None:
            c = np.zeros(256, np.int8)
            for i in range(26):
                c[ord("A") + i] = 1 + i
                c[ord("a") + i] = 1 + i
            for i in range(10):
                c[ord("0") + i] = 27 + i
            c[ord("_")] = 37
            cls._CODE = c
        return cls._CODE

    MAXLEN = 12

    @classmethod
    def encode_np(cls, mat: np.ndarray, lens: np.ndarray):
        """[N, MAXLEN] right-padded byte matrix -> (keys, ok). ok=False
        where a char is outside the alphabet or the name is too long."""
        c = cls._codes()[mat]
        jj = np.arange(mat.shape[1])[None, :]
        inlen = jj < lens[:, None]
        ok = (lens <= cls.MAXLEN) & (lens > 0)
        ok &= ~((c == 0) & inlen).any(axis=1)
        # fixed positional dot: keys = sum c_j * 38^(MAXLEN-1-j) over j<len
        pows = 38 ** np.arange(cls.MAXLEN - 1, -1, -1, dtype=np.int64)
        cz = np.where(inlen, c, 0).astype(np.int64)
        keys = (cz * pows[None, :]).sum(axis=1)
        return keys, ok

    @classmethod
    def encode_one(cls, acc: bytes) -> int:
        acc = acc.split(b".")[0].upper()
        if not (0 < len(acc) <= cls.MAXLEN):
            return -1
        c = cls._codes()
        key = 0
        for j in range(cls.MAXLEN):
            v = int(c[acc[j]]) if j < len(acc) else 0
            if j < len(acc) and v == 0:
                return -1
            key = key * 38 + v
        return key

    @classmethod
    def build(cls, path: str, chunk_bytes: int = 32 << 20):
        from ..io.readwrite import open_input

        self = cls()
        key_parts: list[np.ndarray] = []
        tid_parts: list[np.ndarray] = []
        leftover = b""
        with open_input(path) as fh:
            while True:
                data = fh.read(chunk_bytes)
                if not data:
                    data = b""
                buf = leftover + data
                if not buf:
                    break
                cut = buf.rfind(b"\n") + 1 if data else len(buf)
                if cut <= 0:
                    leftover = buf
                    continue
                leftover = buf[cut:] if data else b""
                self._parse_chunk(buf[:cut], key_parts, tid_parts)
                if not data:
                    break
        if key_parts:
            keys = np.concatenate(key_parts)
            tids = np.concatenate(tid_parts)
            order = np.argsort(keys, kind="stable")
            self.keys = keys[order]
            self.taxids = tids[order]
        return self

    def _parse_chunk(self, blob: bytes, key_parts, tid_parts):
        """Vectorized NCBI accession2taxid / 2-column TSV parsing: field
        boundaries from one newline/tab scan, accession bytes gathered
        into a fixed-width matrix, taxid digits accumulated in numpy."""
        buf = np.frombuffer(blob, np.uint8)
        nl = np.flatnonzero(buf == 10)
        if not len(nl):
            return
        starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
        ends = nl.astype(np.int64)
        # field 0 = accession (to first tab or '.'), taxid column = field
        # 2 for 4/3-column NCBI format, field 1 for plain 2-column TSV
        istab = buf == 9
        tabs = np.flatnonzero(istab).astype(np.int64)
        t1 = np.searchsorted(tabs, starts)  # first tab at/after start
        tab_count = np.searchsorted(tabs, ends) - t1
        # accession span
        W = self.MAXLEN + 1
        idx = starts[:, None] + np.arange(W)[None, :]
        np.clip(idx, 0, len(buf) - 1, out=idx)
        rows = buf[idx]
        stop = (rows == 9) | (rows == ord(".")) | (rows == 10)
        first_stop = np.where(
            stop.any(axis=1), stop.argmax(axis=1), W
        ).astype(np.int64)
        acc_len = np.minimum(first_stop, ends - starts)
        up = rows.copy()
        lower = (up >= ord("a")) & (up <= ord("z"))
        up[lower] -= 32
        keys, ok = self.encode_np(up[:, : self.MAXLEN], acc_len)
        # taxid column offset: after (2 tabs) for NCBI 3/4-col, (1 tab)
        # for 2-col rows; header rows ("accession...") parse to taxid 0
        ncbi = np.asarray(tab_count) >= 2
        tab1 = tabs[np.minimum(t1, max(len(tabs) - 1, 0))] if len(tabs) else ends
        tab2 = (
            tabs[np.minimum(t1 + 1, max(len(tabs) - 1, 0))]
            if len(tabs)
            else ends
        )
        tid_start = np.where(ncbi, tab2, tab1) + 1
        tid_start = np.minimum(tid_start, ends)
        # accumulate digits until a non-digit
        D = 10
        didx = tid_start[:, None] + np.arange(D)[None, :]
        np.clip(didx, 0, len(buf) - 1, out=didx)
        drows = buf[didx]
        isdig = (drows >= ord("0")) & (drows <= ord("9"))
        isdig &= didx < ends[:, None]
        # digit-run length without a cumulative pass: first non-digit
        nondig = ~isdig
        runlen = np.where(nondig.any(axis=1), nondig.argmax(axis=1), D)
        # right-aligned positional dot: tids = sum d_j * 10^(run-1-j)
        pow10 = 10 ** np.arange(D, dtype=np.int64)
        exp = runlen[:, None] - 1 - np.arange(D)[None, :]
        mult = np.where(exp >= 0, pow10[np.maximum(exp, 0)], 0)
        digits = (drows.astype(np.int64) - ord("0")) * isdig
        tids = (digits * mult).sum(axis=1)
        good = ok & (tids > 0)
        key_parts.append(keys[good])
        tid_parts.append(tids[good].astype(np.int32))
        # sidecar for rows the packing can't represent
        bad = np.flatnonzero(~ok & (tids > 0))
        for i in bad[:100000]:
            acc = blob[starts[i] : starts[i] + int(ends[i] - starts[i])]
            acc = acc.split(b"\t")[0].split(b".")[0]
            self.extra[acc.decode("latin1").upper()] = int(tids[i])

    # dict-compatible surface (taxid_of_header uses .get)
    def get(self, acc, default=0):
        if isinstance(acc, bytes):
            acc_b = acc
        else:
            acc_b = str(acc).encode()
        key = self.encode_one(acc_b)
        if key >= 0 and len(self.keys):
            pos = np.searchsorted(self.keys, key)
            if pos < len(self.keys) and self.keys[pos] == key:
                return int(self.taxids[pos])
        return self.extra.get(acc_b.split(b".")[0].decode("latin1").upper(),
                              default)

    def __contains__(self, acc):
        return self.get(acc, 0) != 0

    def __len__(self):
        return len(self.keys) + len(self.extra)


def load_accession_map(path: str, big_threshold: int = 64 << 20):
    """Accession -> taxid (AccessionToTaxid's role). Accepts BOTH the
    simple `accession<TAB>taxid` table and NCBI's accession2taxid format
    (`accession  accession.version  taxid  gi`, header line included,
    tax/AccessionToTaxid.java parsing); versioned accessions index both
    with and without the .version suffix, and the gi column (when
    present) registers `gi|<n>` keys — the gitable role.

    Files past `big_threshold` bytes load as an AccessionIndex (packed
    int64 keys, 12 bytes/entry, vectorized parse) instead of a python
    dict (~100 bytes/entry) — the NCBI-scale path. The two expose the
    same .get/.__contains__ surface; gi| rows are dict-path only."""
    import os

    from ..io.readwrite import open_input

    try:
        big = os.path.getsize(path) > big_threshold
    except OSError:
        big = False
    if big:
        return AccessionIndex.build(path)
    out = {}
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            f = line.decode(errors="replace").rstrip("\n").split("\t")
            if len(f) < 2 or f[0] == "accession":
                continue
            if len(f) >= 3 and f[2].lstrip("-").isdigit():
                # NCBI accession2taxid: acc, acc.version, taxid[, gi]
                tid = int(f[2])
                out[f[0]] = tid
                if f[1] and f[1] != "null":
                    out[f[1]] = tid
                    out[f[1].split(".")[0]] = tid
                if len(f) >= 4 and f[3].isdigit():
                    out["gi|" + f[3]] = tid
            elif f[1].lstrip("-").isdigit():
                out[f[0]] = int(f[1])
                out[f[0].split(".")[0]] = int(f[1])
    return out


def taxid_of_header(header: bytes, acc_map: dict | None) -> int:
    """Sequence header -> taxid: `tid|1234|...` (reference ncbi style),
    or accession lookup on the first token."""
    s = header.decode(errors="replace")
    if s.startswith("tid|"):
        try:
            return int(s.split("|")[1])
        except (IndexError, ValueError):
            return -1
    tok = s.split()[0].split(".")[0] if s else ""
    if acc_map:
        return acc_map.get(tok, acc_map.get(s.split()[0] if s else "", -1))
    return -1


def filter_by_taxa(argv) -> tuple[int, int]:
    """FilterByTaxa: keep (or exclude) fasta records under given nodes."""
    from ..io.fasta import iter_fasta, write_fasta

    a = tokenize(argv)
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    tree = TaxTree.load(a.get("names"), a.get("nodes"))
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    include = a.get_bool("include", default=True)
    wanted = set()
    for token in (a.get("ids", "id", "taxa") or "").split(","):
        token = token.strip()
        if token:
            t = tree.resolve(token)
            if t < 0:
                raise ValueError(f"unknown taxon {token!r}")
            wanted.add(t)
    level = a.get("level")  # optional: promote each read's tid to level
    kept, dropped = 0, 0
    records = []
    for rec in iter_fasta(in1):
        tid = taxid_of_header(rec.name, acc_map)
        if level and tid >= 0:
            tid = tree.ancestor_at_level(tid, level)
        hit = any(tree.is_descendant(tid, w) for w in wanted) if tid >= 0 else False
        if hit == include:
            records.append((rec.name, rec.seq))
            kept += 1
        else:
            dropped += 1
    if out1:
        write_fasta(out1, records)
    print(f"Kept:                \t{kept}", file=sys.stderr)
    print(f"Dropped:             \t{dropped}", file=sys.stderr)
    return kept, dropped


def main(argv=None):
    """`taxonomy names= nodes= ids=...` prints lineages;
    `tree=x.taxtree.npz` loads (or, with names=/nodes= present, writes)
    the serialized tree."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    tree_path = a.get("tree", "taxtree")
    if tree_path and not a.get("names"):
        tree = TaxTree.load_tree(tree_path)
    else:
        tree = TaxTree.load(a.get("names"), a.get("nodes"))
        if tree_path:
            tree.save(tree_path)
            print(f"Wrote {tree_path}", file=sys.stderr)
    for token in (a.get("ids", "id", "taxa") or "").split(","):
        token = token.strip()
        if not token:
            continue
        tid = tree.resolve(token)
        if tid < 0 or not tree.valid(tid):
            print(f"{token}\t<not found>")
        else:
            print(f"{token}\t{tree.lineage_string(tid)}")
    return tree


def split_by_taxa(argv):
    """splitbytaxa.sh (tax/SplitByTaxa.java): route sequences to one
    output file per taxon at level= (out pattern uses %)."""
    from ..io.fasta import iter_fasta

    a = tokenize(argv)
    in1 = a.get("in", "in1")
    pattern = a.get("out", "pattern", default="%.fa")
    tree = TaxTree.load(a.get("names"), a.get("nodes"))
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    level = a.get("level", default="phylum")
    from ..io.readwrite import open_output

    handles = {}
    counts: dict[bytes, int] = {}
    for rec in iter_fasta(in1):
        tid = taxid_of_header(rec.name, acc_map)
        anc = tree.ancestor_at_level(tid, level) if tid >= 0 else -1
        label = tree.names.get(anc, "unknown") if anc >= 0 else "unknown"
        label = label.replace(" ", "_")
        if label not in handles:
            handles[label] = open_output(pattern.replace("%", label))
        fh = handles[label]
        fh.write(b">" + rec.name + b"\n")
        for i in range(0, len(rec.seq), 70):
            fh.write(rec.seq[i : i + 70] + b"\n")
        counts[label] = counts.get(label, 0) + 1
    for fh in handles.values():
        fh.close()
    for label, n in sorted(counts.items()):
        print(f"{label}\t{n}", file=sys.stderr)
    return counts


def fuse_by_taxa(argv):
    """fusebytaxa.sh (tax/FuseByTaxa role): fuse all sequences sharing a
    taxonomic ancestor at level= into one scaffold per taxon, joined by
    npad= Ns (the summarize-cross-contamination reference prep)."""
    from ..io.fasta import iter_fasta, write_fasta

    a = tokenize(argv)
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    tree = TaxTree.load(a.get("names"), a.get("nodes"))
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    level = a.get("level", default="species")
    npad = a.get_int("npad", "pad", default=300)
    groups: dict[str, list[bytes]] = {}
    for rec in iter_fasta(in1):
        tid = taxid_of_header(rec.name, acc_map)
        anc = tree.ancestor_at_level(tid, level) if tid >= 0 else -1
        label = tree.names.get(anc, "unknown") if anc >= 0 else "unknown"
        groups.setdefault(
            f"tid_{anc}_{label.replace(' ', '_')}", []
        ).append(rec.seq)
    recs = [
        (name.encode(), (b"N" * npad).join(seqs))
        for name, seqs in groups.items()
    ]
    if out1:
        write_fasta(out1, recs)
    print(f"Fused into {len(recs)} scaffolds.", file=sys.stderr)
    return recs


def gi2taxid(argv):
    """gi2taxid.sh (tax/RenameGiToTaxid.java): rename sequence headers
    to tid|<taxid>|<original> using gi numbers / accessions / organism
    names (names= + nodes= enable name resolution)."""
    from ..io.fasta import iter_fasta

    a = tokenize(argv)
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    tree = (
        TaxTree.load(a.get("names"), a.get("nodes"))
        if a.get("names") and a.get("nodes")
        else None
    )

    def by_name(header: bytes) -> int:
        if tree is None:
            return -1
        words = header.decode(errors="replace").split()
        # longest name prefix wins (genus+species before genus)
        for end in range(len(words), 0, -1):
            tid = tree.name_to_id.get(" ".join(words[:end]).lower(), -1)
            if tid >= 0:
                return tid
        return -1

    from ..io.readwrite import open_output

    n = known = 0
    with open_output(out1) as fh:
        for rec in iter_fasta(in1):
            tid = taxid_of_header(rec.name, acc_map)
            if tid < 0:
                tid = by_name(rec.name)
            known += tid >= 0
            n += 1
            fh.write(b">tid|%d|%s\n" % (max(tid, -1), rec.name))
            for i in range(0, len(rec.seq), 70):
                fh.write(rec.seq[i : i + 70] + b"\n")
    print(f"Renamed {n} sequences ({known} with taxIDs).", file=sys.stderr)
    return n, known


def _load_tree(a) -> "TaxTree":
    """tree= (.npz) or names=/nodes= dmp pair."""
    tree_path = a.get("tree", "taxtree")
    if tree_path and not a.get("names"):
        return TaxTree.load_tree(tree_path)
    return TaxTree.load(a.get("names"), a.get("nodes"))


def taxsize(argv=None):
    """taxsize.sh (tax/TaxSize.java): per-node sequence size report.
    Streams a taxid-annotated fasta, accumulates bases/seqs per node,
    then percolates cumulative values up the tree (percolateUp :217).
    Output: `#taxID bases basesC seqs seqsC nodesC` sorted by taxid —
    plain columns are node-local, *C columns include all descendants.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.fasta import iter_fasta

    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    tree = _load_tree(a)
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    size: dict[int, int] = {}
    seqs: dict[int, int] = {}
    for rec in iter_fasta(in1):
        tid = taxid_of_header(rec.name, acc_map)
        if tid < 0:
            continue
        size[tid] = size.get(tid, 0) + len(rec.seq)
        seqs[tid] = seqs.get(tid, 0) + 1
    csize: dict[int, int] = {}
    cseqs: dict[int, int] = {}
    cnodes: dict[int, int] = {}
    for tid in size:
        s, q = size[tid], seqs[tid]
        for anc in tree.lineage(tid):
            csize[anc] = csize.get(anc, 0) + s
            cseqs[anc] = cseqs.get(anc, 0) + q
            cnodes[anc] = cnodes.get(anc, 0) + 1
    lines = [b"#taxID\tbases\tbasesC\tseqs\tseqsC\tnodesC"]
    for tid in sorted(csize):
        lines.append(
            b"%d\t%d\t%d\t%d\t%d\t%d"
            % (
                tid, size.get(tid, 0), csize[tid], seqs.get(tid, 0),
                cseqs[tid], cnodes[tid],
            )
        )
    blob = b"\n".join(lines) + b"\n"
    from ..io.readwrite import open_output

    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return size, csize


def explodetree(argv=None):
    """explodetree.sh (tax/ExplodeTree.java): write each sequence into a
    directory tree mirroring the taxonomy — path root/<id0>/<id1>/.../
    from the tree root down to the node (TaxTree.toDir :998), file
    `<taxid>.fa.gz` analog `<taxid>.fa`, plus `<name>.name` marker files
    and an optional results= per-node size report."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.fasta import iter_fasta

    in1 = a.get("in", "in1")
    out_root = a.get("out", "path", default=".") or "."
    results = a.get("results")
    tree = _load_tree(a)
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    import os

    sizes: dict[int, int] = {}
    handles: dict[int, object] = {}
    try:
        for rec in iter_fasta(in1):
            tid = taxid_of_header(rec.name, acc_map)
            if tid < 0 or not tree.valid(tid):
                continue
            fh = handles.get(tid)
            if fh is None:
                rel = "/".join(
                    str(t) for t in reversed(tree.lineage(tid))
                )
                d = os.path.join(out_root, rel)
                os.makedirs(d, exist_ok=True)
                name_file = os.path.join(
                    d, tree.name_of(tid).replace("/", "_") + ".name"
                )
                if not os.path.exists(name_file):
                    with open(name_file, "w") as nf:
                        nf.write(tree.name_of(tid))
                fh = open(os.path.join(d, f"{tid}.fa"), "ab")
                handles[tid] = fh
            fh.write(b">" + rec.name + b"\n")
            for i in range(0, len(rec.seq), 70):
                fh.write(rec.seq[i : i + 70] + b"\n")
            sizes[tid] = sizes.get(tid, 0) + len(rec.seq)
    finally:
        for fh in handles.values():
            fh.close()
    if results:
        with open(results, "w") as fh:
            for tid, sz in sorted(sizes.items()):
                fh.write(f"{tid}\t{sz}\t{tree.name_of(tid)}\n")
    print(f"Exploded {len(sizes)} taxa under {out_root}", file=sys.stderr)
    return sizes


def shrinkaccession(argv=None):
    """shrinkaccession.sh (tax/ShrinkAccession.java processSeq :145):
    shrink an NCBI accession2taxid table to `accession\\ttaxid[\\tgi]`,
    dropping the accession.version column; gzip in/out supported; lines
    with taxid<1 are dropped. keepgi=f drops the gi column too."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    keep_gi = a.get_bool("keepgi", "gi", default=True)
    n_out = bad = 0
    with open_input(in1) as src, open_output(out1) as dst:
        for line in src:
            line = line.rstrip(b"\n")
            if not line:
                continue
            if line.startswith(b"accession\t"):
                dst.write(line + b"\n")
                continue
            if line.startswith(b"accession.version\ttaxid"):
                dst.write(b"accession\t\ttaxid\t\n")
                continue
            f = line.split(b"\t")
            if len(f) >= 3:
                acc, tid = f[0], f[2]
                gi = f[3] if len(f) > 3 else b""
            elif len(f) == 2:
                acc, tid, gi = f[0], f[1], b""
            else:
                bad += 1
                continue
            try:
                if int(tid) < 1:
                    bad += 1
                    continue
            except ValueError:
                bad += 1
                continue
            row = acc + b"\t" + tid
            if keep_gi and gi and gi != b"na" and gi.isdigit():
                row += b"\t" + gi
            dst.write(row + b"\n")
            n_out += 1
    print(f"Wrote {n_out} rows, dropped {bad}.", file=sys.stderr)
    return n_out, bad


def gi2ancestors(argv=None):
    """gi2ancestors.sh (tax/FindAncestors role): for each query line of
    taxids (or gi|/accession tokens), print the common ancestor taxid
    and its lineage."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    tree = _load_tree(a)
    acc_map = (
        load_accession_map(a.get("accession"))
        if a.get("accession")
        else None
    )
    lines_out = []
    with open_input(in1) as fh:
        for line in fh.read().splitlines():
            toks = line.replace(b",", b"\t").split(b"\t")
            tids = []
            for t in toks:
                t = t.strip()
                if not t:
                    continue
                tid = (
                    int(t) if t.isdigit()
                    else taxid_of_header(t, acc_map)
                )
                if tid >= 0 and tree.valid(tid):
                    tids.append(tid)
            if not tids:
                lines_out.append(line + b"\t<not found>")
                continue
            anc = tids[0]
            for t in tids[1:]:
                anc = tree.common_ancestor(anc, t)
            lines_out.append(
                line + b"\t%d\t" % anc
                + tree.lineage_string(anc).encode()
            )
    blob = b"\n".join(lines_out) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return lines_out


def filterassemblysummary(argv=None):
    """filterassemblysummary.sh (driver/FilterAssemblySummary.java) —
    filter an NCBI assembly_summary.txt by taxonomy: a row is kept when
    its species_taxid (column 7, :167) is under one of the requested
    nodes (ids= names or taxids, tree from names=/nodes= or tree=)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    tree = _load_tree(a)
    want = set()
    for tok in (a.get("ids", "id", "taxa") or "").split(","):
        tok = tok.strip()
        if tok:
            tid = tree.resolve(tok)
            if tid >= 0:
                want.add(tid)
    kept = n = 0
    with open_input(in1) as src, open_output(out1) as dst:
        for line in src:
            if line.startswith(b"#"):
                dst.write(line)
                continue
            n += 1
            f = line.split(b"\t")
            if len(f) <= 6:
                continue
            try:
                tid = int(f[6])
            except ValueError:
                continue
            if any(tree.is_descendant(tid, w) for w in want):
                dst.write(line)
                kept += 1
    print(f"Lines Retained: {kept}/{n}", file=sys.stderr)
    return kept, n


def analyzeaccession(argv=None):
    """analyzeaccession.sh (tax/AnalyzeAccession.java) — count accession
    shape patterns (letter->L, digit->D, others literal) across
    accession2taxid files; output `#Pattern Count Combos Bits` rows
    (:149-154), combos = 26^letters * 10^digits."""
    import math

    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    ins = (a.get("in", "in1") or "").split(",")
    out1 = a.get("out", "out1")
    counts: dict[bytes, int] = {}
    for path in ins:
        with open_input(path) as fh:
            for line in fh:
                if line.startswith(b"accession"):
                    continue
                acc = line.split(b"\t", 1)[0].split(b".", 1)[0].strip()
                if not acc:
                    continue
                pat = bytes(
                    (ord("L") if bytes([c]).isalpha()
                     else ord("D") if bytes([c]).isdigit() else c)
                    for c in acc
                )
                counts[pat] = counts.get(pat, 0) + 1
    lines = [b"#Pattern\tCount\tCombos\tBits"]
    for pat in sorted(counts, key=lambda p: -counts[p]):
        nl = pat.count(b"L")
        nd = pat.count(b"D")
        combos = (26 ** nl) * (10 ** nd)
        bits = math.log2(combos) if combos > 0 else 0.0
        lines.append(
            b"%s\t%d\t%d\t%.2f" % (pat, counts[pat], combos, bits)
        )
    blob = b"\n".join(lines) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return counts


def fetchproks(argv=None):
    """fetchproks.sh (prok/FetchProks.java role) — write a shell script
    of download commands for genome assemblies listed in an NCBI
    assembly_summary.txt, keeping at most maxspeciespergenus= species
    per genus and preferring reference/representative genomes and
    higher assembly levels. No network access is performed; the output
    script is the deliverable."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1", default="fetch.sh")
    max_per_genus = a.get_int("maxspeciespergenus", "mspg", default=1)
    level_rank = {
        b"Complete Genome": 0, b"Chromosome": 1, b"Scaffold": 2,
        b"Contig": 3,
    }
    cat_rank = {b"reference genome": 0, b"representative genome": 1}
    rows = []
    with open_input(in1) as fh:
        for line in fh:
            if line.startswith(b"#"):
                continue
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) < 20 or not f[19].startswith(b"ftp"):
                continue
            organism = f[7]
            genus = organism.split()[0] if organism.split() else b"?"
            species = b" ".join(organism.split()[:2])
            rank = (
                cat_rank.get(f[4], 2), level_rank.get(f[11], 4),
            )
            rows.append((genus, species, rank, f[0], f[19]))
    rows.sort(key=lambda r: (r[0], r[2]))
    taken: dict[bytes, set] = {}
    n = 0
    with open_output(out1) as fh:
        fh.write(b"#!/bin/bash\n")
        for genus, species, rank, acc, ftp in rows:
            seen = taken.setdefault(genus, set())
            if species in seen:
                continue
            if len(seen) >= max_per_genus:
                continue
            seen.add(species)
            base = ftp.rsplit(b"/", 1)[-1]
            fh.write(
                b"wget -q -O %s.fa.gz %s/%s_genomic.fna.gz\n"
                % (acc, ftp, base)
            )
            n += 1
    print(f"Wrote {n} fetch commands.", file=sys.stderr)
    return n


def gitable(argv=None):
    """gitable.sh (tax/GiToTaxid table builder role) — condense NCBI
    accession2taxid / gi dump files into a 2-column `gi<TAB>taxid`
    table consumed by gi2taxid renaming."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from ..io.readwrite import open_input, open_output

    ins = (a.get("in", "in1") or "").split(",")
    out1 = a.get("out", "out1")
    n = 0
    with open_output(out1) as dst:
        for path in ins:
            with open_input(path) as src:
                for line in src:
                    if line.startswith(b"accession"):
                        continue
                    f = line.rstrip(b"\n").split(b"\t")
                    if len(f) >= 4 and f[3].isdigit():
                        dst.write(f[3] + b"\t" + f[2] + b"\n")
                        n += 1
                    elif len(f) == 2 and f[0].isdigit():
                        dst.write(f[0] + b"\t" + f[1] + b"\n")
                        n += 1
    print(f"Wrote {n} gi->taxid rows.", file=sys.stderr)
    return n
