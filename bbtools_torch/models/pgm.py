"""Prokaryotic gene model (.pgm) — FrameStats tables for CallGenes.

Parses the reference's text .pgm format (prok/GeneModel.java write/read:
header stats, then per-type blocks each holding FrameStats sections:
`#name`, `#k`, `#frames`, `#offset`, `#valid` header row, then count rows
`valid frame c0 c1 ...`). Scoring follows prok/FrameStats.java:
  prob[frame][kmer] = valid/(valid+invalid)
  scorePoint(p) = mean over the frame window of (prob - 0.99)
with positions before the sequence start padded with 'A'
(FrameStats.java:127-160).

The port's copy of bbtools_tpu/models/pgm.py; the bundled model.pgm is
read from the JAX package's resources by path, not copied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.readwrite import open_input


@dataclass
class FrameStats:
    name: str
    k: int
    frames: int
    offset: int
    probs: np.ndarray  # [frames, 4^k] float32

    def score_points(self, codes: np.ndarray, points: np.ndarray):
        """scorePoint vectorized over `points` (0-based coords into the
        2-bit `codes`; N=4 resets the kmer run)."""
        k, frames, off = self.k, self.frames, self.offset
        n = len(codes)
        # kmer ending at i (A-padded left of 0); invalid runs tracked
        pad = np.zeros(k - 1 + max(off, 0) + 1, np.uint8)  # 'A' = 0
        ext = np.concatenate([pad, np.minimum(codes, 4)])
        base0 = len(pad)
        valid = ext < 4
        run = np.zeros(len(ext), np.int32)
        r = 0
        kmers = np.zeros(len(ext), np.int64)
        mask = (1 << (2 * k)) - 1
        km = 0
        for i in range(len(ext)):
            x = int(ext[i])
            if x < 4:
                km = ((km << 2) | x) & mask
                r += 1
            else:
                r = 0
            run[i] = r
            kmers[i] = km
        out = np.zeros(len(points), np.float32)
        for pi, p in enumerate(np.asarray(points)):
            s = 0.0
            start = base0 + int(p) - off
            for frame in range(1 - k, frames):
                i = start + (frame - (1 - k))
                if i >= len(ext):
                    break
                if frame >= 0 and run[i] >= k:
                    s += self.probs[frame, kmers[i]] - 0.99
            out[pi] = s
        return out

    def inner_cumulative(self, codes: np.ndarray):
        """For frame-cyclic stats (CDS inner, frames=3): cumulative
        (prob - 0.99) per codon phase. Returns cum [3, n+1] where
        cum[ph, i] sums contributions of kmers ENDING at positions < i
        whose (end-position - phase_anchor) % 3 selects the frame row —
        the GeneCaller cumulative-score trick (GeneCaller.java:938):
        innerScore(orf) = (cum[stop] - cum[start]) / len."""
        k = self.k
        n = len(codes)
        mask = (1 << (2 * k)) - 1
        kmers = np.zeros(n, np.int64)
        run = np.zeros(n, np.int32)
        km = 0
        r = 0
        for i in range(n):
            x = int(codes[i])
            if x < 4:
                km = ((km << 2) | x) & mask
                r += 1
            else:
                km = ((km << 2)) & mask
                r = 0
            kmers[i] = km
            run[i] = r
        ok = run >= k
        contrib = np.zeros((3, n), np.float32)
        pos = np.arange(n)
        for ph in range(3):
            frame = (pos - ph) % 3
            c = np.where(ok, self.probs[frame, kmers] - 0.99, 0.0)
            contrib[ph] = c
        cum = np.zeros((3, n + 1), np.float32)
        np.cumsum(contrib, axis=1, out=cum[:, 1:])
        return cum


@dataclass
class GeneModel:
    stats: dict  # name -> FrameStats

    def __getitem__(self, name: str) -> FrameStats:
        return self.stats[name]

    def __contains__(self, name):
        return name in self.stats


def parse_pgm(path: str | None = None) -> GeneModel:
    if path is None:
        # the bundled model is the JAX package's, read by path
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "bbtools_tpu", "resources", "model.pgm",
        )
    stats: dict[str, FrameStats] = {}
    name = None
    k = frames = offset = 0
    counts = None  # [2, frames, 4^k]
    with open_input(path) as fh:
        for raw in fh.read().splitlines():
            if raw.startswith(b"#"):
                f = raw[1:].split(b"\t")
                key = f[0]
                if key == b"name" and len(f) > 1:
                    if counts is not None and counts.any():
                        _finish(stats, name, k, frames, offset, counts)
                    name = f[1].decode()
                    counts = None
                elif key == b"k":
                    k = int(f[1])
                elif key == b"frames":
                    frames = int(f[1])
                elif key == b"offset":
                    offset = int(f[1])
                elif key == b"valid":
                    counts = np.zeros((2, frames, 4 ** k), np.float64)
                continue
            if counts is None or not raw.strip():
                continue
            f = raw.split(b"\t")
            v, fr = int(f[0]), int(f[1])
            row = np.array([int(x) for x in f[2:]], np.float64)
            counts[v, fr, : len(row)] = row
    if counts is not None and counts.any():
        _finish(stats, name, k, frames, offset, counts)
    return GeneModel(stats)


def _finish(stats, name, k, frames, offset, counts):
    # FrameStats.calculate (FrameStats.java:108-121): Laplace-smoothed
    # P(valid) per cell, scaled by the inverse GLOBAL valid rate, so
    # average kmers score ~1.0 and gene-enriched kmers score >1
    t, f = counts[1], counts[0]
    average = (t.sum() + 1.0) / (t.sum() + f.sum() + 1.0)
    probs = (t / (t + f + 1.0)) / average
    stats[name] = FrameStats(
        name, k, frames, offset, probs.astype(np.float32)
    )
