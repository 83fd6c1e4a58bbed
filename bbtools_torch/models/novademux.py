"""NovaDemux — probability-model barcode demultiplexing.

Re-design of barcode/NovaDemux.java + the PCRMatrix family
(barcode/PCRMatrix.java abstract, PCRMatrixHDist.java, and the
TILE_TYPE/PROB_TYPE variants whose shipped sources are empty license
stubs — barcode/stub/PCRMatrixTile.java:11-14).  Three matrix types,
selected by mode=/matrixtype= (PCRMatrix.parseStatic :179-187):

  prob (default, novademux.sh doc :90): an error model is learned from
    the run's own barcode population; each observed barcode is assigned
    to the expected barcode with the highest log-probability, if above
    `minprob` (default -5.6 log10) and the best/second probability
    ratio clears `minratio` (default 1e6).
    Model, vectorized: (1) tally observed barcodes; (2) provisional
    nearest-expected by Hamming distance; (3) per-position substitution
    counts -> per-position probability matrix; (4) score log10
    P(obs|exp) = sum_pos log10 M[pos][exp_base][obs_base].
    Scoring runs once per UNIQUE observed barcode, not per read.

  tile (PCRMatrix.byTile, NovaDemux.getKey :860 keys barcodes by
    bc+tile): the same model fit PER FLOWCELL TILE with the global
    matrix as a shrinkage prior, so spatially localized error modes
    (edge tiles, bubbles, dim quadrants) get their own substitution
    statistics while thin tiles fall back to the global fit.  Tile
    numbers come from the Illumina header (field 5 of the ':'-split).

  hdist (PCRMatrixHDist.findClosestSingleHDist :491 semantics):
    fewest-mismatches assignment under maxhdist (novademux.sh doc
    default 6) with a clearzone margin to the second-best (default 1);
    dual indexes (a '+' in the barcode) measure each half separately
    unless pairhdist=t sums them (hdistSum, findClosestDualHDist :543).

Flags: in/in2, out/out2 (% patterns), outu/outu2, expected= (list or
files), mode=/matrixtype=, minprob=, minratio=, maxhdist=, clearzone=,
pairhdist=, tileprior=, rename=, nosplit=, stats=.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import parse_boolean, parse_kmg, tokenize
from ..io.fastq import FastqReader, FastqWriter
from ..io.readwrite import open_input, open_output

SYMS = b"ACGTN+"
SYM_IDX = {c: i for i, c in enumerate(SYMS)}


def _encode_bc(bc: bytes, L: int) -> np.ndarray:
    a = np.full(L, SYM_IDX[ord("N")], np.int8)
    for i, c in enumerate(bc[:L]):
        a[i] = SYM_IDX.get(c, SYM_IDX[ord("N")])
    return a


def _load_expected(spec: str) -> list[bytes]:
    out = []
    for tok in spec.split(","):
        if os.path.exists(tok):
            with open_input(tok) as fh:
                for line in fh.read().splitlines():
                    line = line.strip().split(b"\t")[0]
                    if line and not line.startswith(b"#"):
                        out.append(line)
        elif tok:
            out.append(tok.encode())
    return out


def _parse_header(rid: bytes) -> tuple[bytes, int]:
    """(barcode, tile) from an Illumina header: barcode is the text
    after the last ':' (index field of the comment), tile is field 5 of
    the ':'-split coordinate part (IlluminaHeaderParser role)."""
    bc = rid.rsplit(b":", 1)[-1].strip()
    coord = rid.split(b" ", 1)[0].split(b"\t", 1)[0]
    f = coord.split(b":")
    tile = 0
    if len(f) >= 5:
        try:
            tile = int(f[4])
        except ValueError:
            tile = 0
    return bc, tile


class PCRMatrixProb:
    """Per-position substitution probability model (PROB_TYPE)."""

    def __init__(self, expected: list[bytes]):
        self.L = max(len(e) for e in expected)
        self.expected = expected
        self.exp_mat = np.stack([_encode_bc(e, self.L) for e in expected])
        self.logm: np.ndarray | None = None

    # -- fitting ------------------------------------------------------
    def _tally(self, observed: dict[bytes, int]) -> np.ndarray:
        """Per-position substitution counts [L, S, S] from provisional
        nearest-expected assignments."""
        E, L = self.exp_mat.shape
        counts = np.zeros((L, len(SYMS), len(SYMS)), np.float64)
        if not observed:
            return counts
        obs_mat = np.stack([_encode_bc(b, L) for b in observed])
        wts = np.fromiter(observed.values(), np.float64, len(observed))
        d = (self.exp_mat[:, None, :] != obs_mat[None, :, :]).sum(axis=2)
        j = d.argmin(axis=0)
        keep = d[j, np.arange(len(obs_mat))] <= max(2, L // 4)
        e_rows = self.exp_mat[j]
        pos = np.arange(L)
        for oi in np.flatnonzero(keep):
            counts[pos, e_rows[oi], obs_mat[oi]] += wts[oi]
        return counts

    def fit(self, observed: dict[bytes, int]):
        counts = self._tally(observed) + 0.5  # Laplace floor
        self.logm = np.log10(
            counts / counts.sum(axis=2, keepdims=True)
        ).astype(np.float32)

    # -- scoring ------------------------------------------------------
    def score(self, observed: list[bytes], logm=None):
        """(best_expected_index, log10_prob, log10_margin) per observed
        barcode — vectorized: gather the per-position log-probs for
        every (expected, observed) pair and sum."""
        E, L = self.exp_mat.shape
        O = len(observed)
        if O == 0:
            z = np.zeros(0)
            return z.astype(int), z, z
        logm = self.logm if logm is None else logm
        obs_mat = np.stack([_encode_bc(b, L) for b in observed])  # [O, L]
        pos = np.arange(L)
        lp = logm[pos[None, None, :], self.exp_mat[:, None, :],
                  obs_mat[None, :, :]]
        tot = lp.sum(axis=2)  # [E, O]
        best = tot.argmax(axis=0)
        o = np.arange(O)
        bestlp = tot[best, o]
        if E > 1:
            tot2 = tot.copy()
            tot2[best, o] = -np.inf
            margin = bestlp - tot2.max(axis=0)
        else:
            margin = np.full(O, np.inf)
        return best, bestlp, margin

    def assign(self, observed: dict[bytes, int], minprob: float,
               minratio_log: float) -> dict[bytes, bytes | None]:
        self.fit(observed)
        obs_list = list(observed)
        best, logp, margin = self.score(obs_list)
        return {
            bc: (
                self.expected[int(b)]
                if lp >= minprob and mg >= minratio_log else None
            )
            for bc, b, lp, mg in zip(obs_list, best, logp, margin)
        }


class PCRMatrixTile(PCRMatrixProb):
    """TILE_TYPE: one substitution matrix per flowcell tile, shrunk
    toward the global fit (the shipped reference class is a license
    stub; this is the real per-tile statistics the tool documents —
    novademux.sh doc :92-94)."""

    def __init__(self, expected: list[bytes], prior_weight: float = 32.0):
        super().__init__(expected)
        self.prior_weight = prior_weight

    def assign_tiles(
        self, by_tile: dict[int, dict[bytes, int]], minprob: float,
        minratio_log: float,
    ) -> dict[tuple[bytes, int], bytes | None]:
        # global fit = the prior
        all_obs: dict[bytes, int] = {}
        for obs in by_tile.values():
            for bc, n in obs.items():
                all_obs[bc] = all_obs.get(bc, 0) + n
        g_counts = self._tally(all_obs) + 0.5
        g_prob = g_counts / g_counts.sum(axis=2, keepdims=True)
        self.logm = np.log10(g_prob).astype(np.float32)
        out: dict[tuple[bytes, int], bytes | None] = {}
        for tile, obs in by_tile.items():
            t_counts = self._tally(obs)
            mix = t_counts + self.prior_weight * g_prob
            logm = np.log10(
                mix / mix.sum(axis=2, keepdims=True)
            ).astype(np.float32)
            obs_list = list(obs)
            best, logp, margin = self.score(obs_list, logm=logm)
            for bc, b, lp, mg in zip(obs_list, best, logp, margin):
                out[(bc, tile)] = (
                    self.expected[int(b)]
                    if lp >= minprob and mg >= minratio_log else None
                )
        return out


class PCRMatrixHDist:
    """HDIST_TYPE: fewest-mismatches with clearzone margin
    (PCRMatrix.findClosestSingleHDist / findClosestDualHDist)."""

    def __init__(self, expected: list[bytes], maxhdist: int = 6,
                 clearzone: int = 1, hdist_sum: bool = False):
        self.expected = expected
        self.maxhdist = maxhdist
        self.clearzone = clearzone
        self.hdist_sum = hdist_sum
        self.dual = all(b"+" in e for e in expected) and len(expected) > 0

    @staticmethod
    def _closest(qmat: np.ndarray, emat: np.ndarray):
        """[O] (best_idx, hdist, hdist2) against expected rows [E, L]."""
        d = (emat[:, None, :] != qmat[None, :, :]).sum(axis=2)  # [E, O]
        best = d.argmin(axis=0)
        o = np.arange(qmat.shape[0])
        h1 = d[best, o]
        if emat.shape[0] > 1:
            d2 = d.copy()
            d2[best, o] = np.iinfo(np.int64).max
            h2 = d2.min(axis=0)
        else:
            h2 = np.full(len(o), np.iinfo(np.int32).max, np.int64)
        return best, h1, h2

    def assign(self, observed: dict[bytes, int]
               ) -> dict[bytes, bytes | None]:
        obs_list = list(observed)
        out: dict[bytes, bytes | None] = {}
        if not obs_list:
            return out
        if not self.dual:
            L = max(len(e) for e in self.expected)
            emat = np.stack([_encode_bc(e, L) for e in self.expected])
            qmat = np.stack([_encode_bc(b, L) for b in obs_list])
            best, h1, h2 = self._closest(qmat, emat)
            ok = (h1 <= self.maxhdist) & (h2 - h1 >= self.clearzone)
            for bc, b, k in zip(obs_list, best, ok):
                out[bc] = self.expected[int(b)] if k else None
            return out
        # dual index: split on '+', match halves independently
        lefts = [e.split(b"+")[0] for e in self.expected]
        rights = [e.split(b"+", 1)[1] for e in self.expected]
        L1 = max(len(x) for x in lefts)
        L2 = max(len(x) for x in rights)
        elmat = np.stack([_encode_bc(x, L1) for x in lefts])
        ermat = np.stack([_encode_bc(x, L2) for x in rights])
        ql, qr = [], []
        for b in obs_list:
            l, _, r = b.partition(b"+")
            ql.append(_encode_bc(l, L1))
            qr.append(_encode_bc(r if r else b"", L2))
        lbest, lh1, lh2 = self._closest(np.stack(ql), elmat)
        rbest, rh1, rh2 = self._closest(np.stack(qr), ermat)
        if self.hdist_sum:
            # findClosestDualHDist hdistSum branch :543-551: the max
            # and the clearzone apply to the summed distances
            ok = ((lh1 + rh1 <= self.maxhdist)
                  & ((lh2 + rh2) - (lh1 + rh1) >= self.clearzone))
        else:
            ok = ((lh1 <= self.maxhdist) & (rh1 <= self.maxhdist)
                  & (lh2 - lh1 >= self.clearzone)
                  & (rh2 - rh1 >= self.clearzone))
        for i, bc in enumerate(obs_list):
            if not ok[i]:
                out[bc] = None
                continue
            combo = lefts[int(lbest[i])] + b"+" + rights[int(rbest[i])]
            # the combined pair must itself be an expected barcode
            out[bc] = combo if combo in set(self.expected) else None
        return out


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out", "out1")
    outu = a.get("outu")
    stats = a.get("stats")
    minprob = a.get_float("minprob", default=-5.6)
    minratio = parse_kmg(a.get("minratio", default="1m"))
    rename = a.get_bool("rename", default=False)
    nosplit = a.get_bool("nosplit", default=False)
    mode = (a.get("mode", "matrixtype", default="prob") or "prob").lower()
    if mode == "probability":
        mode = "prob"
    if mode == "bytile":
        mode = "tile"
    # probability=/bytile= boolean toggles, applied in argument order
    # (PCRMatrix.parseStatic :184-187 exact demotion semantics)
    for k, v in a.pairs:
        if k == "probability":
            mode = ("prob" if parse_boolean(v)
                    else "hdist" if mode == "prob" else mode)
        elif k == "bytile":
            mode = ("tile" if parse_boolean(v)
                    else "prob" if mode == "tile" else mode)
    maxhdist = a.get_int("maxhdist", "hdist", default=6)
    clearzone = a.get_int("clearzone", "cz", default=1)
    pairhdist = a.get_bool("pairhdist", default=False)
    tileprior = a.get_float("tileprior", default=32.0)
    expected = _load_expected(a.get("expected", "barcodes", default="") or "")
    if not expected:
        raise SystemExit("novademux: expected= is required")
    if out and "%" not in out and not nosplit:
        raise SystemExit("novademux: out= must contain %")
    minratio_log = float(np.log10(max(minratio, 1)))

    # pass 1: tally observed barcodes (per tile in tile mode)
    by_tile: dict[int, dict[bytes, int]] = {}
    observed: dict[bytes, int] = {}
    for b in FastqReader(in1):
        for rid in b.ids:
            bc, tile = _parse_header(rid)
            observed[bc] = observed.get(bc, 0) + 1
            if mode == "tile":
                t = by_tile.setdefault(tile, {})
                t[bc] = t.get(bc, 0) + 1

    tiled = mode == "tile"
    if tiled:
        model = PCRMatrixTile(expected, prior_weight=tileprior)
        assign_t = model.assign_tiles(by_tile, minprob, minratio_log)
        assign = None
    elif mode == "hdist":
        assign = PCRMatrixHDist(
            expected, maxhdist, clearzone, pairhdist
        ).assign(observed)
        assign_t = None
    else:
        assign = PCRMatrixProb(expected).assign(
            observed, minprob, minratio_log
        )
        assign_t = None

    # pass 2: route reads
    writers: dict[bytes, FastqWriter] = {}
    counts: dict[bytes, int] = {e: 0 for e in expected}
    unknown = 0

    def writer_for(label: bytes) -> FastqWriter | None:
        if nosplit or not out:
            return None
        if label not in writers:
            writers[label] = FastqWriter(
                out.replace("%", label.decode().replace("+", "-"))
            )
        return writers[label]

    wu = FastqWriter(outu) if outu else None

    for b in FastqReader(in1):
        routes: dict[bytes | None, list[int]] = {}
        for i, rid in enumerate(b.ids):
            bc, tile = _parse_header(rid)
            label = (
                assign_t.get((bc, tile)) if tiled else assign.get(bc)
            )
            routes.setdefault(label, []).append(i)
        for label, idxs in routes.items():
            keep = np.zeros(b.n, bool)
            keep[idxs] = True
            if rename:
                for i in idxs:
                    b.ids[i] = b.ids[i] + b" bc=" + (label or b"unknown")
            if label is None:
                unknown += len(idxs)
                if wu is not None:
                    wu.add(b, keep)
            else:
                counts[label] += len(idxs)
                w = writer_for(label)
                if w is not None:
                    w.add(b, keep)
    for w in writers.values():
        w.close()
    if wu is not None:
        wu.close()
    if stats:
        with open_output(stats) as fh:
            fh.write(b"#barcode\treads\n")
            for e in expected:
                fh.write(b"%s\t%d\n" % (e, counts[e]))
            fh.write(b"unknown\t%d\n" % unknown)
    total = sum(counts.values()) + unknown
    print(f"Reads Processed:    \t{total}", file=sys.stderr)
    print(f"Assigned:           \t{total - unknown}", file=sys.stderr)
    print(f"Unknown:            \t{unknown}", file=sys.stderr)
    return counts, unknown
