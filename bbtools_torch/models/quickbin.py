"""QuickBin — metagenome contig binning by composition + depth.

Reference: bin/ package (quickbin.sh): QuickBin groups assembly contigs
into genome bins using tetramer composition, coverage depth, and sketch
refinement (Binner/Oracle). Round-1 scope: the core signal subset —
canonical tetramer frequency vectors (the clade profile machinery) plus
per-contig mean depth (from a SAM/BAM via pileup, or `cov=` table),
greedy agglomerative binning: seeds in size order, a contig joins a bin
when both the tetramer absdif and the log-depth ratio are under
thresholds (Binner's dual-gate merge test). Outputs per-bin fastas and
a TSV summary.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.dna import BASE_TO_CODE
from ..core.parser import tokenize
from ..io.fasta import iter_fasta, write_fasta

TETRA_DIF_LIMIT = 0.18
DEPTH_RATIO_LIMIT = 1.6
MIN_CONTIG = 1000


def tetramer_profile(codes: np.ndarray) -> np.ndarray:
    from .clade import _CANON

    from ..ops.kmers import rolling_kmers_np

    fwd, _, runlen = rolling_kmers_np(codes[None, :], 4)
    valid = runlen[0] >= 4
    counts = np.bincount(fwd[0][valid], minlength=256).astype(np.float64)
    folded = np.bincount(_CANON[4], weights=counts, minlength=256)
    vec = folded[np.unique(_CANON[4])]
    s = vec.sum()
    return vec / s if s else vec


@dataclass
class Contig:
    name: bytes
    seq: bytes
    profile: np.ndarray
    #: per-sample mean coverage vector (multi-sample depth is QuickBin's
    #: discriminating signal: bin/DataLoader.java loads one depth column
    #: per sam/cov input and Bin similarity compares each sample)
    depth: np.ndarray
    bin_id: int = -1


def _max_ratio(A: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Worst per-sample depth ratio between bin depth rows A [n, S] and
    one contig's depth vector d [S] (Bin.java per-sample ratio gate)."""
    A2 = np.atleast_2d(A)
    d = np.atleast_1d(d)
    hi = np.maximum(A2, d[None, :])
    lo = np.maximum(np.minimum(A2, d[None, :]), 1e-9)
    return (hi / lo).max(axis=1)


def load_depths(path: str) -> dict:
    """covstats table (pileup.sh format: #ID  Avg_fold ...)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split("\t")
            out[f[0].encode()] = float(f[1])
    return out


def bin_contigs(contigs: list[Contig],
                tetra_limit: float = TETRA_DIF_LIMIT,
                depth_limit: float = DEPTH_RATIO_LIMIT,
                refine_passes: int = 2):
    """Greedy agglomeration: largest contig seeds a bin; others join the
    closest qualifying bin (dual gate on composition and depth). The
    per-contig bin scan is a single vectorized [B, 136] distance compute,
    and `refine_passes` reassignment sweeps against the FINAL bin
    profiles (the Binner refinement role) fix early greedy mistakes."""
    contigs = sorted(contigs, key=lambda c: -len(c.seq))
    if not contigs:
        return []
    for c in contigs:
        c.depth = np.atleast_1d(np.asarray(c.depth, np.float64))
    nprof = len(contigs[0].profile)
    ns = len(contigs[0].depth)
    cap = len(contigs)
    P = np.zeros((cap, nprof), np.float64)
    D = np.zeros((cap, ns), np.float64)
    S = np.zeros(cap)
    nb = 0

    def best_bin(c, exclude=-1):
        if nb == 0:
            return -1
        dif = np.abs(P[:nb] - c.profile).sum(axis=1)
        ratio = _max_ratio(D[:nb], c.depth)
        ok = (dif < tetra_limit) & (ratio <= depth_limit)
        if exclude >= 0:
            ok[exclude] = False
        if not ok.any():
            return -1
        return int(np.argmin(np.where(ok, dif, np.inf)))

    for c in contigs:
        best = best_bin(c)
        if best < 0:
            P[nb] = c.profile
            D[nb] = c.depth
            S[nb] = len(c.seq)
            c.bin_id = nb
            nb += 1
        else:
            c.bin_id = best
            w0, w1 = S[best], len(c.seq)
            P[best] = (P[best] * w0 + c.profile * w1) / (w0 + w1)
            D[best] = (D[best] * w0 + c.depth * w1) / (w0 + w1)
            S[best] = w0 + w1
    # refinement: reassign each contig to its best bin under the final
    # profiles; recompute profiles between passes
    for _ in range(max(refine_passes, 0)):
        moved = 0
        for c in contigs:
            nb_best = best_bin(c)
            if nb_best >= 0 and nb_best != c.bin_id:
                c.bin_id = nb_best
                moved += 1
        if not moved:
            break
        P[:nb] = 0
        D[:nb] = 0
        S[:nb] = 0
        for c in contigs:
            w = len(c.seq)
            P[c.bin_id] += c.profile * w
            D[c.bin_id] += c.depth * w
            S[c.bin_id] += w
        nz = S[:nb] > 0
        P[:nb][nz] /= S[:nb][nz, None]
        D[:nb][nz] /= S[:nb][nz, None]
    bins: list[list[Contig]] = [[] for _ in range(nb)]
    for c in contigs:
        bins[c.bin_id].append(c)
    return [b for b in bins if b]


def purify_pass(bins: list[list["Contig"]],
                tetra_limit: float = TETRA_DIF_LIMIT,
                depth_limit: float = DEPTH_RATIO_LIMIT,
                stringency: float = 0.75):
    """Binner.purify (bin/Binner.java:715-765): eject contigs that no
    longer belong to their cluster under a TIGHTER gate computed against
    the leave-one-out bin profile; ejected contigs form residue
    singletons that the residue pass re-places."""
    out: list[list[Contig]] = []
    residue: list[list[Contig]] = []
    for members in bins:
        if len(members) < 3:
            out.append(members)
            continue
        W = np.array([len(c.seq) for c in members], np.float64)
        Pm = np.stack([c.profile for c in members])
        Dm = np.stack([np.atleast_1d(c.depth) for c in members])
        wsum = W.sum()
        psum = (Pm * W[:, None]).sum(axis=0)
        dsum = (Dm * W[:, None]).sum(axis=0)
        keep = []
        for idx, c in enumerate(members):
            w0 = wsum - W[idx]
            loo_p = (psum - Pm[idx] * W[idx]) / max(w0, 1e-9)
            loo_d = (dsum - Dm[idx] * W[idx]) / max(w0, 1e-9)
            dif = float(np.abs(loo_p - c.profile).sum())
            ratio = float(_max_ratio(loo_d[None, :], c.depth)[0])
            if (
                dif > tetra_limit * stringency
                or ratio > 1 + (depth_limit - 1) / max(stringency, 1e-9)
            ):
                residue.append([c])
            else:
                keep.append(c)
        out.append(keep if keep else members)
    return [b for b in out if b], residue


def residue_pass(bins: list[list["Contig"]],
                 residue: list[list["Contig"]],
                 tetra_limit: float = TETRA_DIF_LIMIT,
                 depth_limit: float = DEPTH_RATIO_LIMIT,
                 stringency: float = 1.5):
    """Binner.processResidue role: re-place ejected/leftover contigs
    into the best surviving bin under a LOOSER gate (residueStringency);
    anything still unplaced stays a singleton bin."""
    if not residue:
        return bins
    prof = []
    dep = []
    for members in bins:
        W = np.array([len(c.seq) for c in members], np.float64)
        Pm = np.stack([c.profile for c in members])
        Dm = np.stack([np.atleast_1d(c.depth) for c in members])
        w = W.sum()
        prof.append((Pm * W[:, None]).sum(axis=0) / max(w, 1e-9))
        dep.append((Dm * W[:, None]).sum(axis=0) / max(w, 1e-9))
    P = np.stack(prof) if prof else np.zeros((0, 136))
    D = np.stack(dep) if dep else np.zeros((0, 1))
    leftover = []
    for group in residue:
        for c in group:
            if len(P):
                dif = np.abs(P - c.profile).sum(axis=1)
                ratio = _max_ratio(D, c.depth)
                ok = (dif < tetra_limit * stringency) & (
                    ratio <= 1 + (depth_limit - 1) * stringency
                )
                if ok.any():
                    bins[int(np.argmin(np.where(ok, dif, np.inf)))].append(c)
                    continue
            leftover.append([c])
    return bins + leftover


def sketch_refine(bins: list[list["Contig"]], depth_limit: float,
                  min_ani: float = 0.96, sketch_size: int = 2000):
    """Sketch-based bin merging (BinSketcher/Oracle role): bottom-k
    sketch each bin; merge bin pairs whose sketch ANI estimate >=
    min_ani and whose depths agree — same-organism bins the greedy
    composition pass left split."""
    from .sketch import compare_sketches, sketch_sequences

    if len(bins) < 2:
        return bins
    sketches = []
    depths = []
    for b in bins:
        sketches.append(
            sketch_sequences(
                (
                    BASE_TO_CODE[np.frombuffer(c.seq, np.uint8)]
                    for c in b
                ),
                size=sketch_size,
            )
        )
        w = sum(len(c.seq) for c in b)
        depths.append(
            sum(np.atleast_1d(c.depth) * len(c.seq) for c in b)
            / max(w, 1)
        )
    parent = list(range(len(bins)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(bins)):
        for j in range(i + 1, len(bins)):
            ratio = float(_max_ratio(depths[i][None, :], depths[j])[0])
            if ratio > depth_limit:
                continue
            _, ani, matches, n = compare_sketches(sketches[i], sketches[j])
            if n and matches >= 3 and ani >= min_ani:
                parent[find(j)] = find(i)
    merged: dict[int, list[Contig]] = {}
    for i, b in enumerate(bins):
        merged.setdefault(find(i), []).extend(b)
    return list(merged.values())


def crystal_split(members: list["Contig"],
                  tetra_limit: float = TETRA_DIF_LIMIT,
                  depth_limit: float = DEPTH_RATIO_LIMIT,
                  seed: int = 12345,
                  max_iter: int = 50,
                  min_improvement: float = 0.1):
    """CrystalChamber refiner (bin/CrystalChamber.java, Binner.recluster
    reclusterClusters=t): dissolve a bin and recrystallize it as k=2 via
    k-means on (tetramer profile, log depth). Centroid init is
    farthest-first from the largest contig (the reference's medoid
    convention); a split is accepted only when (a) the mean intra-bin
    distance improves by >= min_improvement and (b) the two halves would
    NOT immediately merge back under the standard dual gate
    (shouldMergeBack self-consistency check). Returns (half1, half2) or
    None."""
    if len(members) < 4:
        return None
    rng = np.random.default_rng(seed)
    feats = np.stack([
        np.concatenate([c.profile,
                        0.25 * np.log1p(np.atleast_1d(c.depth))])
        for c in members
    ])
    W = np.array([len(c.seq) for c in members], np.float64)
    # farthest-first init: largest contig, then the member maximizing
    # distance to it (k-means++ shape, deterministic apart from ties)
    c0 = int(np.argmax(W))
    d0 = np.abs(feats - feats[c0]).sum(axis=1)
    c1 = int(np.argmax(d0))
    if c1 == c0:
        return None
    cents = feats[[c0, c1]].copy()
    assign = np.zeros(len(members), np.int64)
    for _ in range(max_iter):
        d = np.abs(feats[:, None, :] - cents[None, :, :]).sum(axis=2)
        new = d.argmin(axis=1)
        if (new == assign).all() and _ > 0:
            break
        assign = new
        for k in (0, 1):
            sel = assign == k
            if not sel.any():
                return None
            w = W[sel]
            cents[k] = (feats[sel] * w[:, None]).sum(axis=0) / w.sum()
    if (assign == 0).all() or (assign == 1).all():
        return None
    base = np.abs(feats - (feats * W[:, None]).sum(axis=0)
                  / W.sum()).sum(axis=1).mean()
    split = np.abs(feats - cents[assign]).sum(axis=1).mean()
    if base <= 0 or (base - split) / base < min_improvement:
        return None
    halves = ([m for m, a in zip(members, assign) if a == 0],
              [m for m, a in zip(members, assign) if a == 1])
    # shouldMergeBack: compare the two halves under the standard gate
    hp, hd = [], []
    for h in halves:
        w = np.array([len(c.seq) for c in h], np.float64)
        hp.append((np.stack([c.profile for c in h]) * w[:, None])
                  .sum(axis=0) / w.sum())
        hd.append((np.stack([np.atleast_1d(c.depth) for c in h])
                   * w[:, None]).sum(axis=0) / w.sum())
    dif = float(np.abs(hp[0] - hp[1]).sum())
    ratio = float(_max_ratio(hd[0][None, :], hd[1])[0])
    if dif < tetra_limit and ratio <= depth_limit:
        return None  # the Oracle would just merge them back
    return halves


def follow_edges_pass(bins: list[list["Contig"]],
                      pair_edges: dict,
                      tetra_limit: float = TETRA_DIF_LIMIT,
                      depth_limit: float = DEPTH_RATIO_LIMIT,
                      stringency: float = 1.1,
                      max_edges: int = 2,
                      min_edge_weight: int = 2,
                      min_edge_ratio: float = 0.4,
                      passes: int = 5):
    """Pair-link graph merging (Binner.followEdges, bin/Binner.java:261,
    391-431; cascade position and defaults from bin/QuickBin.java:1043-47
    followEdge2Passes=5 / edgeStringency=1.1, Binner.java:1679-85
    maxEdges=2 minEdgeWeight=2 minEdgeRatio=0.4).

    Contigs whose read mates map onto another contig carry pairMap edges;
    a bin merges into the best-similarity neighbor among its strongest
    edges when the edge weight clears max(minEdgeWeight,
    ceil(minEdgeRatio * strongest)) and the composition/depth gate
    (relaxed by `stringency`) agrees. Runs up to `passes` sweeps or until
    no merge happens."""
    import math

    name_to_bin: dict[bytes, int] = {}
    total_merges = 0
    for _ in range(max(passes, 0)):
        name_to_bin.clear()
        for bi, members in enumerate(bins):
            for c in members:
                name_to_bin[c.name.split()[0]] = bi
        # per-bin outgoing edge weights to other bins
        out_w: list[dict[int, int]] = [dict() for _ in bins]
        for (a_name, b_name), w in pair_edges.items():
            ba = name_to_bin.get(a_name)
            bb = name_to_bin.get(b_name)
            if ba is None or bb is None or ba == bb:
                continue
            out_w[ba][bb] = out_w[ba].get(bb, 0) + w
        P = np.array([
            np.average([c.profile for c in m], axis=0,
                       weights=[len(c.seq) for c in m])
            for m in bins
        ])
        D = np.array([
            np.average([c.depth for c in m], axis=0,
                       weights=[len(c.seq) for c in m])
            for m in bins
        ])
        # merge targets, smallest bins first (they benefit most and a
        # merged bin must not also be a destination this sweep)
        sizes = [sum(len(c.seq) for c in m) for m in bins]
        order = np.argsort(sizes)
        merged_into = {}
        claimed: set[int] = set()
        for bi in order:
            bi = int(bi)
            if bi in claimed or not out_w[bi]:
                continue
            edges = sorted(out_w[bi].items(), key=lambda kv: -kv[1])
            cap = max_edges + min(2, max_edges) * min(8, len(bins[bi]) - 1)
            edges = edges[:cap]
            min_w = max(
                min_edge_weight,
                math.ceil(min_edge_ratio * edges[0][1]),
            )
            best, best_dif = -1, np.inf
            for tb, w in edges:
                if w < min_w or tb in merged_into or tb in claimed:
                    continue
                dif = float(np.abs(P[tb] - P[bi]).sum())
                ratio = float(_max_ratio(D[tb][None], D[bi])[0])
                if (dif < tetra_limit * stringency
                        and ratio <= depth_limit * stringency
                        and dif < best_dif):
                    best, best_dif = tb, dif
            if best >= 0:
                merged_into[bi] = best
                claimed.add(bi)
                claimed.add(best)
        if not merged_into:
            break
        for src, dst in merged_into.items():
            bins[dst].extend(bins[src])
            bins[src] = []
        bins = [m for m in bins if m]
        total_merges += len(merged_into)
    return bins, total_merges


def fuse_pass(bins: list[list["Contig"]],
              tetra_limit: float = TETRA_DIF_LIMIT,
              depth_limit: float = DEPTH_RATIO_LIMIT,
              stringency: float = 1.6,
              passes: int = 4,
              lower: int = 5000,
              upper_src: int = 900_000,
              upper_dst: int = 9_000_000):
    """Small-bin fusion (Binner.fuse, bin/Binner.java:1053; defaults
    :1661-1667 — fuseLowerLimit=5 kb, fuseUpperLimit=900 kb source /
    9 Mb destination, fuseStringency=1.6, up to 4 passes as in
    QuickBin.java:555-565): genome fragments that agglomeration left as
    separate mid-size bins merge into their composition/depth-nearest
    neighbor under gates relaxed by `stringency`."""
    total = 0
    for _ in range(max(passes, 0)):
        sizes = np.array([sum(len(c.seq) for c in m) for m in bins])
        if len(bins) < 2:
            break
        P = np.array([
            np.average([c.profile for c in m], axis=0,
                       weights=[len(c.seq) for c in m])
            for m in bins
        ])
        D = np.array([
            np.average([c.depth for c in m], axis=0,
                       weights=[len(c.seq) for c in m])
            for m in bins
        ])
        src = [int(i) for i in np.argsort(sizes)
               if lower <= sizes[i] <= upper_src]
        claimed: set[int] = set()
        plan = {}
        dr = 1.0 + (depth_limit - 1.0) * stringency
        for bi in src:
            if bi in claimed:
                continue
            best, best_dif = -1, tetra_limit * stringency
            for bj in range(len(bins)):
                if (
                    bj == bi or bj in claimed or bj in plan
                    or sizes[bj] > upper_dst or sizes[bj] < lower
                ):
                    continue
                dif = float(np.abs(P[bj] - P[bi]).sum())
                ratio = float(_max_ratio(D[bj][None], D[bi])[0])
                if dif < best_dif and ratio <= dr:
                    best, best_dif = bj, dif
            if best >= 0:
                plan[bi] = best
                claimed.add(bi)
                claimed.add(best)
        if not plan:
            break
        for s, d in plan.items():
            bins[d].extend(bins[s])
            bins[s] = []
        bins = [m for m in bins if m]
        total += len(plan)
    return bins, total


def recluster_pass(bins: list[list["Contig"]],
                   tetra_limit: float = TETRA_DIF_LIMIT,
                   depth_limit: float = DEPTH_RATIO_LIMIT):
    """Binner.recluster: run the CrystalChamber refiner over every bin,
    replacing accepted splits (one level, like the reference)."""
    out = []
    nsplit = 0
    for members in bins:
        halves = crystal_split(members, tetra_limit, depth_limit)
        if halves is None:
            out.append(members)
        else:
            out.extend(halves)
            nsplit += 1
    return out, nsplit


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1", "contigs")
    out_pat = a.get("out", "pattern", default="bin_%.fa")
    cov = a.get("cov", "covstats")
    sam = a.get("sam", "bam", "reads")
    min_contig = a.get_int("mincontig", "minlen", default=MIN_CONTIG)
    tetra_limit = a.get_float("tetradif", default=TETRA_DIF_LIMIT)
    depth_limit = a.get_float("depthratio", default=DEPTH_RATIO_LIMIT)

    # one depth SAMPLE per cov/sam input (comma lists): multi-sample
    # depth vectors are the reference's main discriminating signal
    samples: list[dict] = []
    if cov:
        for path in cov.split(","):
            samples.append(load_depths(path.strip()))
    pair_edges: dict[tuple[bytes, bytes], int] = {}
    min_mapq = a.get_int("minmapq", default=20)  # bin/DataLoader.java:1625
    if sam and not cov:
        from ..io.sam_read import iter_sam, parse_cigar

        for path in sam.split(","):
            span: dict[bytes, int] = {}
            for rec in iter_sam(path.strip()):
                if not rec.mapped or rec.secondary:
                    continue
                n = sum(x for x, op in parse_cigar(rec.cigar)
                        if op in "M=XDN")
                span[rec.rname] = span.get(rec.rname, 0) + n
                # pair-link graph edge (bin/SamLoader3.java:344-371):
                # mate mapped onto a DIFFERENT contig with decent mapq
                if (
                    rec.flag & 0x1
                    and not rec.flag & 0x8
                    and rec.rnext not in (b"*", b"=")
                    and rec.rnext != rec.rname
                    and rec.mapq >= min_mapq
                ):
                    key = (rec.rname, rec.rnext)
                    pair_edges[key] = pair_edges.get(key, 0) + 1
            samples.append(span)  # normalized by length below

    contigs = []
    for rec in iter_fasta(in1):
        if len(rec.seq) < min_contig:
            continue
        codes = BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]
        key = rec.name.split()[0]
        if samples:
            d = np.array([s.get(key, 0.0) for s in samples], np.float64)
            if sam and not cov:
                d = d / max(len(rec.seq), 1)
            d = np.maximum(d, 1e-3)
        else:
            d = np.ones(1)
        contigs.append(
            Contig(rec.name, rec.seq, tetramer_profile(codes), d)
        )
    bins = bin_contigs(contigs, tetra_limit, depth_limit)
    if (
        pair_edges
        and a.get_bool("followedges", "e2", default=True)
        and len(bins) > 1
    ):
        es = a.get_float("edgestringency", "edgestringency2", default=1.1)
        bins, nmerged = follow_edges_pass(
            bins, pair_edges, tetra_limit, depth_limit, es,
            max_edges=a.get_int("maxedges", default=2),
            min_edge_weight=a.get_int("minedgeweight", default=2),
            min_edge_ratio=a.get_float("minedgeratio", default=0.4),
            passes=a.get_int("followedges2", "e2passes", default=5),
        )
        if nmerged:
            print(f"Edge following merged {nmerged} bins.",
                  file=sys.stderr)
    if a.get_bool("purify", default=True) and bins:
        ps = a.get_float("purifystringency", default=0.75)
        rs = a.get_float("residuestringency", default=1.5)
        bins, residue = purify_pass(bins, tetra_limit, depth_limit, ps)
        if residue:
            print(f"Purify ejected {len(residue)} contigs.",
                  file=sys.stderr)
            bins = residue_pass(bins, residue, tetra_limit, depth_limit, rs)
    if a.get_bool("fuse", default=True) and len(bins) > 1:
        fs = a.get_float("fusestringency", default=1.6)
        fp = a.get_int("fusepasses", default=4)
        bins, nfused = fuse_pass(
            bins, tetra_limit, depth_limit, fs, fp,
            lower=a.get_int("fuselowerlimit", default=5000),
            upper_src=a.get_int("fuseupperlimit", default=900_000),
            upper_dst=a.get_int("fuseupperlimit2", default=9_000_000),
        )
        if nfused:
            print(f"Fusion merged {nfused} bins.", file=sys.stderr)
    if a.get_bool("recluster", "reclusterclusters", default=False):
        bins, nsplit = recluster_pass(bins, tetra_limit, depth_limit)
        if nsplit:
            print(f"Recluster split {nsplit} bins.", file=sys.stderr)
    if a.get_bool("sketch", "refine", default=True):
        before = len(bins)
        bins = sketch_refine(
            bins, depth_limit,
            min_ani=a.get_float("minani", default=0.96),
        )
        if len(bins) != before:
            print(
                f"Sketch refinement merged {before - len(bins)} bins.",
                file=sys.stderr,
            )
    for bi, members in enumerate(bins):
        if out_pat:
            write_fasta(
                out_pat.replace("%", str(bi)),
                [(c.name, c.seq) for c in members],
            )
    print(f"Contigs binned:      \t{len(contigs)}", file=sys.stderr)
    print(f"Bins:                \t{len(bins)}", file=sys.stderr)
    for bi, members in enumerate(bins):
        size = sum(len(c.seq) for c in members)
        print(
            f"bin_{bi}\t{len(members)} contigs\t{size} bp"
            f"\tdepth "
            f"{np.mean([np.mean(c.depth) for c in members]):.1f}",
            file=sys.stderr,
        )
    return bins
