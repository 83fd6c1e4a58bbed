"""DemuxByName — split reads into per-key output files.

Reference: jgi/DemuxByName2.java (demuxbyname.sh). Key-extraction modes
(getKey :1057-1110): header (whole id), barcode (text after the last ':'
of an Illumina header), affix (prefix/suffix of fixed or per-name
lengths), delimiter (token of the id split on a delimiter, `column=`
1-based, default last). Expected names may be listed inline or in files;
`hdist=` pre-expands barcode mutants into the assignment map with
collision removal (addMutants :793-870). `out=` must contain `%`
(replaced by key); `outu=` catches unmatched reads; paired reads follow
read 1's key.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from ..core.parser import tokenize
import numpy as np

from ..io.fastq import encode_fastq
from ..io.readwrite import open_output
from ..io.stream import read_batches


@dataclass
class DemuxConfig:
    in1: str = ""
    in2: str | None = None
    out: str = ""
    out2: str | None = None
    outu: str | None = None
    outu2: str | None = None
    names: list = field(default_factory=list)
    mode: str = "affix"  # affix | header | barcode | delimiter
    prefix_mode: bool = True
    length: int = 0
    delimiter: str | None = None
    column: int = -1  # 1-based; -1 = last token
    hdist: int = 0


def parse_args(argv) -> DemuxConfig:
    a = tokenize(argv)
    c = DemuxConfig()
    c.in1 = a.get("in", "in1", default="")
    c.in2 = a.get("in2")
    c.out = a.get("out", "out1", default="")
    c.out2 = a.get("out2")
    c.outu = a.get("outu", "outu1")
    c.outu2 = a.get("outu2")
    for nv in (a.get("names", "name") or "").split(","):
        nv = nv.strip()
        if not nv:
            continue
        if os.path.exists(nv):
            with open(nv) as fh:
                c.names += [l.strip() for l in fh if l.strip()]
        else:
            c.names.append(nv)
    if a.get_bool("headermode", "header", default=False):
        c.mode = "header"
    if a.get_bool("barcode", "barcodemode", "index", default=False):
        c.mode = "barcode"
    d = a.get("delimiter")
    if d:
        c.delimiter = {"tab": "\t", "whitespace": " ", "space": " "}.get(
            d, d
        )
        c.mode = "delimiter"
    if a.get("prefixmode", "prefix", "pm") is not None:
        c.prefix_mode = a.get_bool("prefixmode", "prefix", "pm", default=True)
    if a.get_bool("suffixmode", "suffix", default=False):
        c.prefix_mode = False
    c.length = a.get_int("length", "len", "fixedlength", default=0)
    c.column = a.get_int("column", default=-1)
    c.hdist = a.get_int("hdist", "hamming", "hammingdistance", default=0)
    # interleaved # expansion
    if c.in2 is None and c.in1 and "#" in c.in1:
        c.in2 = c.in1.replace("#", "2")
        c.in1 = c.in1.replace("#", "1")
    if c.out2 is None and c.out and "#" in c.out:
        c.out2 = c.out.replace("#", "2")
        c.out = c.out.replace("#", "1")
    if c.outu2 is None and c.outu and "#" in c.outu:
        c.outu2 = c.outu.replace("#", "2")
        c.outu = c.outu.replace("#", "1")
    if c.out and "%" not in c.out:
        raise ValueError("out= must contain % (replaced by the demux key)")
    return c


def add_mutants(names, hdist: int):
    """Map mutant barcode -> canonical name; collisions dropped
    (DemuxByName2.addMutants collision semantics)."""
    assign = {n: n for n in names}
    if hdist <= 0:
        return assign
    collisions = set()
    frontier = {n: n for n in names}
    for _ in range(hdist):
        nxt = {}
        for mut, canon in frontier.items():
            for i in range(len(mut)):
                for ch in "ACGTN":
                    if ch == mut[i]:
                        continue
                    m2 = mut[:i] + ch + mut[i + 1 :]
                    prev = assign.get(m2) or nxt.get(m2)
                    if prev is None:
                        nxt[m2] = canon
                    elif prev != canon:
                        collisions.add(m2)
        for m2, canon in nxt.items():
            if m2 not in assign:
                assign[m2] = canon
        frontier = nxt
    for m in collisions:
        if m in assign and assign[m] not in (m,):
            # ambiguous mutants are unassigned unless they are exact names
            if m not in names:
                del assign[m]
    return assign


class Demux:
    def __init__(self, cfg: DemuxConfig):
        self.cfg = cfg
        lengths = sorted({len(n) for n in cfg.names}, reverse=True)
        self.length_array = lengths
        if cfg.mode in ("affix", "barcode", "delimiter") and cfg.names:
            self.assignment = add_mutants(cfg.names, cfg.hdist)
        elif cfg.names:
            self.assignment = {n: n for n in cfg.names}
        else:
            self.assignment = None  # every key is its own file
        self.counts: dict[str, int] = {}

    # ---- key extraction (getKey :1057-1110) ----
    def key_of(self, rid: bytes) -> str | None:
        cfg = self.cfg
        s = rid.decode(errors="replace")
        if cfg.mode == "header":
            key = s
        elif cfg.mode == "barcode":
            key = s.rsplit(":", 1)[-1] if ":" in s else s
        elif cfg.mode == "delimiter":
            parts = s.split(cfg.delimiter)
            idx = cfg.column - 1 if cfg.column > 0 else len(parts) - 1
            key = parts[idx] if 0 <= idx < len(parts) else None
        else:  # affix
            if cfg.length > 0:
                key = (
                    s
                    if len(s) <= cfg.length
                    else (
                        s[: cfg.length]
                        if cfg.prefix_mode
                        else s[-cfg.length :]
                    )
                )
            else:
                for ln in self.length_array:
                    sub = (
                        s[:ln] if cfg.prefix_mode else s[-ln:]
                    ) if len(s) >= ln else s
                    if self.assignment and sub in self.assignment:
                        return self.assignment[sub]
                return None
        if key is None:
            return None
        if self.assignment is not None:
            return self.assignment.get(key)
        return key

    def run(self):
        """Sequential stream: batches arrive in order, so per-key output
        files are written append-in-order (no reorder buffer needed)."""
        cfg = self.cfg
        writers: dict[str, tuple] = {}

        def get_writer(key):
            if key not in writers:
                safe = key.replace("/", "_").replace("\\", "_")
                w1 = open_output(cfg.out.replace("%", safe))
                w2 = (
                    open_output(cfg.out2.replace("%", safe))
                    if cfg.in2 and cfg.out2
                    else None
                )
                writers[key] = (w1, w2)
            return writers[key]

        wu = open_output(cfg.outu) if cfg.outu else None
        wu2 = (
            open_output(cfg.outu2) if cfg.outu and cfg.in2 and cfg.outu2
            else None
        )

        it1 = read_batches(cfg.in1)
        it2 = read_batches(cfg.in2) if cfg.in2 else None
        for b1 in it1:
            b2 = next(it2) if it2 is not None else None
            keys = [self.key_of(rid) for rid in b1.ids]
            by_key: dict[str | None, list[int]] = {}
            for i, k in enumerate(keys):
                by_key.setdefault(k, []).append(i)
            for k, rows in by_key.items():
                label = k if k is not None else "(unmatched)"
                self.counts[label] = self.counts.get(label, 0) + len(rows)
                mask = np.zeros(b1.n, dtype=bool)
                mask[rows] = True
                if k is None:
                    if wu is not None:
                        wu.write(encode_fastq(b1, mask))
                        if b2 is not None:
                            (wu2 or wu).write(encode_fastq(b2, mask))
                    continue
                w1, w2 = get_writer(k)
                w1.write(encode_fastq(b1, mask))
                if b2 is not None:
                    (w2 or w1).write(encode_fastq(b2, mask))
        for w1, w2 in writers.values():
            w1.close()
            if w2 is not None:
                w2.close()
        if wu is not None:
            wu.close()
        if wu2 is not None:
            wu2.close()
        total = sum(self.counts.values())
        sys.stderr.write(f"Reads Processed: {total}\n")
        for k in sorted(self.counts):
            sys.stderr.write(f"{k}\t{self.counts[k]}\n")
        return self


def main(argv):
    Demux(parse_args(argv)).run()
