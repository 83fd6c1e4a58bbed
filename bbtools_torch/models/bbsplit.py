"""BBSplit — bin reads by which reference set they map best to.

The port of bbtools_tpu/models/bbsplit.py, which follows
align2/BBSplitter.java (bbsplit.sh; scaffold-name prefixing
:setPrefix, per-set output streams) driving the shared BBMap pipeline,
with `ambiguous2=` deciding reads whose best sites tie across sets
(AbstractMapper.java:330-343: best/first | split | toss | random | all).

Design: the member fastas are concatenated into one Reference whose
scaffold names are prefixed `setname$scafname` (the reference's merge
step writes a merged ref the same way); one BBMap pass maps everything;
routing reads the prefix off the aligned scaffold. Ties across sets are
detected from BBMap's ambiguous flag plus top-2 site scores landing in
different sets. The mapper runs on `device=` (cuda by default); the
rest is the JAX package's host code.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import encode_fastq
from ..io.readwrite import open_output
from ..io.stream import read_batches


@dataclass
class BBSplitConfig:
    in1: str = ""
    in2: str | None = None
    refs: dict = field(default_factory=dict)  # setname -> fasta path
    out_pattern: str = ""  # must contain %
    outu: str | None = None
    ambig2: str = "best"
    batch_reads: int = 4096
    refstats: str | None = None
    #: torch device of the mapper: cuda (default), cuda:N or cpu
    device: str = "cuda"


def parse_args(argv) -> BBSplitConfig:
    a = tokenize(argv)
    c = BBSplitConfig()
    c.in1 = a.get("in", "in1", default="")
    c.in2 = a.get("in2")
    refv = a.get("ref") or ""
    for path in refv.split(","):
        path = path.strip()
        if not path:
            continue
        name = os.path.basename(path)
        for ext in (".gz", ".fa", ".fasta", ".fna"):
            if name.endswith(ext):
                name = name[: -len(ext)]
        c.refs[name] = path
    for k, v in a.pairs:
        if k.startswith("ref_") and v:
            c.refs[k[4:]] = v
    c.out_pattern = a.get("basename", "pattern", "out", default="") or ""
    c.outu = a.get("outu", "outu1")
    c.ambig2 = (a.get("ambiguous2", "ambig2") or "best").lower()
    c.refstats = a.get("refstats")
    c.device = a.get("device", default="cuda")
    if c.out_pattern and "%" not in c.out_pattern:
        raise ValueError("basename= must contain % (replaced by ref name)")
    if not c.refs:
        raise ValueError("bbsplit requires ref=<fasta,fasta,...> or ref_<name>=")
    return c


SEP = b"$"


def build_merged_reference(refs: dict, tmpdir: str) -> str:
    """Write a merged fasta with setname$ prefixes (BBSplitter merge)."""
    from ..io.readwrite import open_input

    merged = os.path.join(tmpdir, "bbsplit_merged_ref.fa")
    with open(merged, "wb") as out:
        for setname, path in refs.items():
            pre = setname.encode() + SEP
            with open_input(path) as fh:
                for line in fh:
                    if line.startswith(b">"):
                        out.write(b">" + pre + line[1:].rstrip(b"\n") + b"\n")
                    else:
                        out.write(line)
    return merged


class BBSplit:
    def __init__(self, cfg: BBSplitConfig, tmpdir: str = "."):
        from ..io.fasta import load_reference
        from .bbmap_index import SeedIndex

        self.cfg = cfg
        merged = build_merged_reference(cfg.refs, tmpdir)
        self.ref = load_reference(merged)
        self.index = SeedIndex.build(self.ref, k=13)
        # scaffold -> set id
        self.set_names = list(cfg.refs)
        set_idx = {n.encode(): i for i, n in enumerate(self.set_names)}
        self.scaf_set = np.array(
            [set_idx[n.split(SEP)[0]] for n in self.ref.names], np.int64
        )
        self.counts = np.zeros(len(self.set_names) + 1, np.int64)  # +unmapped

    def run(self):
        from .bbmap import BBMap, BBMapConfig

        cfg = self.cfg
        mapper = BBMap(
            BBMapConfig(in1=cfg.in1, in2=cfg.in2, out=None,
                        batch_reads=cfg.batch_reads, device=cfg.device),
            index=self.index,
        )
        writers = {}

        def writer_for(si):
            name = self.set_names[si]
            if name not in writers:
                w1 = open_output(cfg.out_pattern.replace("%", name))
                writers[name] = w1
            return writers[name]

        wu = open_output(cfg.outu) if cfg.outu else None
        it1 = read_batches(cfg.in1, batch_reads=cfg.batch_reads)
        it2 = read_batches(cfg.in2, batch_reads=cfg.batch_reads) if cfg.in2 else None
        def sets_of(batch):
            results = mapper.map_batch(batch)
            mapped = np.array([r.mapped for r in results])
            flat = np.array([r.flat_start for r in results], np.int64)
            ambig = np.array([r.ambig for r in results])
            scaf = self.ref.scaffold_of(np.maximum(flat, 0))
            return np.where(mapped, self.scaf_set[scaf], -1), ambig

        for b1 in it1:
            b2 = next(it2) if it2 is not None else None
            set_of, ambig = sets_of(b1)
            if b2 is not None:
                set2, ambig2 = sets_of(b2)
                # pair routing: read1's set wins; fall back to read2
                set_of = np.where(set_of >= 0, set_of, set2)
                ambig = ambig | ambig2
            toss = np.zeros(b1.n, dtype=bool)
            if cfg.ambig2 == "toss":
                toss = ambig & (set_of >= 0)
            for si in range(len(self.set_names)):
                rows = (set_of == si) & ~toss
                if not rows.any():
                    continue
                self.counts[si] += int(rows.sum())
                w1 = writer_for(si)
                w1.write(encode_fastq(b1, rows))
                if b2 is not None:
                    w1.write(encode_fastq(b2, rows))
            un = (set_of < 0) | toss
            self.counts[-1] += int(un.sum())
            if wu is not None and un.any():
                wu.write(encode_fastq(b1, un))
                if b2 is not None:
                    wu.write(encode_fastq(b2, un))
        for w in writers.values():
            w.close()
        if wu is not None:
            wu.close()
        self._print_stats()
        return self

    def _print_stats(self):
        total = int(self.counts.sum())
        lines = []
        for i, n in enumerate(self.set_names):
            c = int(self.counts[i])
            lines.append(f"{n}\t{100.0*c/max(total,1):.5f}\t{c}")
        txt = "#name\t%unambiguousReads\tunambiguousReads\n" + "\n".join(lines)
        if self.cfg.refstats:
            with open(self.cfg.refstats, "w") as fh:
                fh.write(txt + "\n")
        print(txt, file=sys.stderr)
        print(f"Unmapped/tossed:     \t{int(self.counts[-1])}", file=sys.stderr)


def main(argv=None):
    import tempfile

    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    with tempfile.TemporaryDirectory() as td:
        return BBSplit(cfg, tmpdir=td).run()
