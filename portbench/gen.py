"""Inputs from the seed: genomes, reads with their truth, FASTQ and FASTA.

One general generator for every traffic mix: a traffic file under
`traffic/` names its `kind` and parameters, and `make_reads` builds them.
Every seed gets the same set of sizes (the same number of indel reads,
the same multiset of indel lengths and insert sizes, the same number of
substitutions); the seed decides where they fall and in which order. So
two seeds ask the same work of the tool and differ only in the draw.

Vectorised NumPy throughout: no Python loop a read.
"""

from __future__ import annotations

import numpy as np

ASCII = np.frombuffer(b"ACGTN", np.uint8)
#: separate random streams of one seed, so that adding a draw to one
#: input never moves another
STREAMS = {"genome": 1, "reads": 2, "walk": 4}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), STREAMS[stream]])


def genome(length: int, seed: int) -> np.ndarray:
    """Uniform random codes 0-3 (uint8) of `length` bases."""
    return rng_for(seed, "genome").integers(0, 4, length, dtype=np.uint8)


def exact_fraction(rng, n: int, frac: float) -> np.ndarray:
    """A mask of exactly round(n * frac) rows, placed by the seed."""
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[: int(round(n * frac))]] = True
    return mask


def spread(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n values covering lo..hi as evenly as n allows, in seeded order:
    the same multiset for every seed."""
    return rng.permutation(lo + (np.arange(n) * (hi - lo + 1)) // max(n, 1))


def substitute(rng, codes: np.ndarray, rate: float) -> int:
    """Change exactly round(rate * size) distinct defined positions of
    `codes` (in place) to another base; returns the count."""
    flat = codes.reshape(-1)
    k = int(round(rate * flat.size))
    if k == 0:
        return 0
    pos = rng.choice(flat.size, k, replace=False)
    pos = pos[flat[pos] < 4]
    flat[pos] = (flat[pos] + rng.integers(1, 4, len(pos), dtype=np.uint8)) % 4
    return len(pos)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of rows of codes (4 = N stays N)."""
    r = codes[..., ::-1]
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def genome_reads(g: np.ndarray, n: int, read_len: int, sub_rate: float,
                 indel_frac: float, indel_range, seed: int, margin: int = 100,
                 walk: dict | None = None):
    """Single-end reads of `g`: each from a seeded start and strand, an
    indel (half deletions, half insertions) planted at a position at
    least 15 bases from either end in exactly `indel_frac` of them, then
    substitutions at `sub_rate` over all bases. With `walk` (see
    `hold_walk_classes`), the starts of a few indel reads are drawn
    again until every seed gives each batch the same wide windows.
    Returns the read codes as sequenced and the truth: start (0-based,
    forward strand), strand, indel kind (0 none, 1 deletion, 2
    insertion), length and position."""
    rng = rng_for(seed, "reads")
    L = read_len
    lo, hi = int(indel_range[0]), int(indel_range[1])
    start = rng.integers(margin, len(g) - L - hi - margin, n)
    strand = rng.integers(0, 2, n).astype(np.uint8)
    has = exact_fraction(rng, n, indel_frac)
    kind = np.zeros(n, np.uint8)
    m = int(has.sum())
    kind[has] = 1 + (np.arange(m) % 2)[rng.permutation(m)]
    ilen = np.zeros(n, np.int64)
    ilen[has] = spread(rng, m, lo, hi)
    ipos = rng.integers(15, L - 15, n)
    ipos[~has] = L
    truth = {"start": start, "strand": strand, "kind": kind, "ilen": ilen, "ipos": ipos}
    j = np.arange(L)[None, :]
    inserted = (kind == 2)[:, None] & (j >= ipos[:, None]) & (j < (ipos + ilen)[:, None])
    fill = np.zeros((n, L), np.uint8)
    fill[inserted] = rng.integers(0, 4, int(inserted.sum()), dtype=np.uint8)
    k = int(round(sub_rate * n * L))
    shift = np.zeros(n * L, np.uint8)
    if k:
        at = rng.choice(n * L, k, replace=False)
        shift[at] = rng.integers(1, 4, k, dtype=np.uint8)
    shift = shift.reshape(n, L)

    def build(rows, starts):
        """The reads `rows` as sequenced, laid from `starts`."""
        after = j >= ipos[rows, None]
        kd = kind[rows, None]
        src = starts[:, None] + j
        src = np.where((kd == 1) & after, src + ilen[rows, None], src)
        src = np.where((kd == 2) & after, src - ilen[rows, None], src)
        codes = g[np.clip(src, 0, len(g) - 1)]
        ins = inserted[rows]
        codes[ins] = fill[rows][ins]
        rc = strand[rows] == 1
        codes[rc] = revcomp(codes[rc])
        return ((codes + shift[rows]) % 4).astype(np.uint8)

    if walk:
        hold_walk_classes(g, build, truth, walk, seed, (margin, len(g) - L - hi - margin))
    return build(np.arange(n), start), truth


def kmer_index(g: np.ndarray, k: int):
    """Every k-mer of `g` as a 2-bit code, sorted, with its positions."""
    codes = np.zeros(len(g) - k + 1, np.int64)
    for i in range(k):
        codes = codes * 4 + g[i:len(g) - k + 1 + i]
    order = np.argsort(codes, kind="stable")
    return codes[order], order


def walk_class(index, seqs: np.ndarray, start: np.ndarray, ilen: np.ndarray,
               walk: dict) -> np.ndarray:
    """The DP window class BBMap gives each read's true site (its seed
    rule, copied: width * key_density / k keys a read, where width is
    the batch's padded read width, at evenly spaced offsets, looked up
    in the genome; hits of one strand clustered where their diagonals
    lie within `bridge`; the class the smallest whose `spreads` limit
    covers the cluster's diagonal range). `seqs` are the reads laid on
    the forward strand."""
    keys_sorted, pos_sorted = index
    k = int(walk["k"])
    n, L = seqs.shape
    slots = L - k + 1
    K = max(2, min(slots, int(walk["width"] * walk["key_density"] / k)))
    offs = np.unique(np.round(np.linspace(0, 1, K) * (slots - 1)).astype(np.int64))
    key = np.zeros((n, len(offs)), np.int64)
    for i in range(k):
        key = key * 4 + seqs[:, offs + i]
    a = np.searchsorted(keys_sorted, key.reshape(-1), "left")
    b = np.searchsorted(keys_sorted, key.reshape(-1), "right")
    cnt = b - a
    slot = np.repeat(np.arange(key.size), cnt)
    first = np.repeat(a - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    site = pos_sorted[first + np.arange(len(slot))]
    read = slot // len(offs)
    diag = site - offs[slot % len(offs)]
    order = np.lexsort((diag, read))
    read, diag = read[order], diag[order]
    cut = np.ones(len(diag), bool)
    cut[1:] = (read[1:] != read[:-1]) | (np.diff(diag) > int(walk["bridge"]))
    cid = np.cumsum(cut) - 1
    lo = np.minimum.reduceat(diag, np.flatnonzero(cut)) if len(diag) else diag
    hi = np.maximum.reduceat(diag, np.flatnonzero(cut)) if len(diag) else diag
    true = np.abs(diag - start[read]) <= ilen[read]
    width = np.zeros(n, np.int64)
    np.maximum.at(width, read[true], (hi - lo)[cid[true]])
    return np.searchsorted(np.asarray(walk["spreads"]), width, "left")


def hold_walk_classes(g, build, truth, walk: dict, seed: int, start_range):
    """Give every seed's reads the same wide DP windows, batch by batch.

    BBMap walks each DP window class that holds a gap-improved winner
    once a batch, in R + Cc steps, so an indel read whose true site's
    seed cluster is wide (a chance seed hit within `bridge` of it)
    costs its batch a walk of the wide class. Such reads come by chance,
    about as often as `per_job` says (a mean over seeds), and the seed
    alone would decide how many batches walk which class. So for each
    class c of `per_job`, exactly per_job[c] batches of `batch` reads
    (chosen by the seed) hold one indel read of class c, and the rest
    none: a surplus read, or a read chosen to carry the class, gets its
    start drawn again (same strand, indel and substitutions) until its
    class is the one wanted. `truth["start"]` is changed in place."""
    rng = rng_for(seed, "walk")
    start, ilen = truth["start"], truth["ilen"]
    n = len(start)
    index = kmer_index(g, int(walk["k"]))

    def forward(rows, starts):
        codes = build(rows, starts)
        return np.where((truth["strand"][rows] == 1)[:, None], revcomp(codes), codes)

    indel = np.flatnonzero(truth["kind"] > 0)
    cls = np.zeros(n, np.int64)
    cls[indel] = walk_class(index, forward(indel, start[indel]), start[indel], ilen[indel], walk)
    batch = int(walk["batch"])
    nb = -(-n // batch)
    wide = sorted(int(c) for c in walk["per_job"])
    plain = list(range(min(wide)))
    want = {c: np.zeros(nb, bool) for c in wide}
    for c in wide:
        want[c][rng.permutation(nb)[:int(walk["per_job"][str(c)])]] = True

    def redraw(r, classes):
        while True:
            cand = rng.integers(start_range[0], start_range[1], 4096)
            rows = np.full(len(cand), r)
            got = walk_class(index, forward(rows, cand), cand, ilen[rows], walk)
            ok = np.flatnonzero(np.isin(got, classes))
            if len(ok):
                start[r] = cand[ok[0]]
                cls[r] = got[ok[0]]
                return

    for b in range(nb):
        rows = indel[(indel >= b * batch) & (indel < (b + 1) * batch)]
        for c in wide:
            have = rows[cls[rows] == c]
            keep = 1 if want[c][b] else 0
            for r in have[keep:]:
                redraw(r, plain)
            if keep and not len(have):
                r = rng.choice(rows[np.isin(cls[rows], plain)])
                redraw(r, [c])


def adapter_pairs(n: int, read_len: int, insert_range, sub_rate: float,
                  adapters, n_every: int, seed: int):
    """Pairs of `read_len` from random inserts of insert_range (the same
    multiset for every seed): r1 the insert's start, r2 its reverse
    complemented end, each read running into its adapter past the insert
    and into A past the adapter; substitutions at `sub_rate`, phred
    2-40 (41 less an exponential of mean 7) and an N in every
    `n_every`-th r1. Returns (codes, quals) for each mate: uint8 [n, L]
    codes 0-4 and phred."""
    rng = rng_for(seed, "reads")
    L = read_len
    lo, hi = int(insert_range[0]), int(insert_range[1])
    ins = spread(rng, n, lo, hi)
    frag = rng.integers(0, 4, (n, hi), dtype=np.uint8)
    pos = np.arange(L)[None, :]
    out = []
    for mate, adapter in enumerate(adapters):
        ad = np.frombuffer(adapter.encode(), np.uint8)
        ad_codes = np.searchsorted(ASCII[:4], ad).astype(np.uint8)
        src = pos if mate == 0 else ins[:, None] - 1 - pos
        codes = np.take_along_axis(frag, np.clip(src, 0, hi - 1), 1)
        if mate == 1:
            codes = 3 - codes
        past = pos - ins[:, None]
        in_ad = (past >= 0) & (past < len(ad_codes))
        codes[in_ad] = ad_codes[past[in_ad]]
        codes[past >= len(ad_codes)] = 0
        substitute(rng, codes, sub_rate)
        q = np.clip(41 - rng.exponential(7, (n, L)), 2, 40).astype(np.uint8)
        if mate == 0 and n_every:
            rows = np.arange(0, n, n_every)
            codes[rows, rng.integers(0, L, len(rows))] = 4
        out.append((codes, q))
    return out


def fastq_bytes(codes: np.ndarray, quals: np.ndarray, prefix: bytes,
                suffix: bytes = b"") -> bytes:
    """Fixed-width FASTQ records "@<prefix><8 digits><suffix>" of full
    rows, built as one byte matrix."""
    n, L = codes.shape
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)[None, :]) % 10
    head = np.frombuffer(b"@" + prefix, np.uint8)[None, :].repeat(n, 0)
    tail = np.frombuffer(suffix + b"\n", np.uint8)[None, :].repeat(n, 0)
    rec = np.concatenate([
        head, (48 + digits).astype(np.uint8), tail, ASCII[codes],
        np.full((n, 3), [10, 43, 10], np.uint8), (quals + 33).astype(np.uint8),
        np.full((n, 1), 10, np.uint8)], axis=1)
    return rec.tobytes()


def write_fasta(path: str, name: bytes, codes: np.ndarray, width: int = 80):
    n = len(codes)
    full = n // width * width
    body = np.concatenate([ASCII[codes[:full]].reshape(-1, width),
                           np.full((full // width, 1), 10, np.uint8)], axis=1).tobytes()
    tail = ASCII[codes[full:]].tobytes() + b"\n" if n > full else b""
    with open(path, "wb") as fh:
        fh.write(b">" + name + b"\n" + body + tail)
