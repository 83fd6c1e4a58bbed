"""ConsensusMaker — rebuild a reference from aligned reads.

Reference: consensus/ConsensusMaker.java + BaseGraph.java + BaseNode.java.
Semantics transcribed:
  - accumulation (BaseGraph.add :117-225): per aligned op, weight = q+1
    (useMapq off); 'm'/'S'/'N' add to the ref node at rpos, 'D' adds to
    the del node (weight from the flanking-qual average), 'I' adds to an
    insertion chain hanging off the previous node.
  - traversal (BaseGraph.traverse :635-738): per position, deletion wins
    when dw>rw and del allele fraction >= MAF_del; otherwise the ref
    node's consensus base is emitted (BaseNode.consensus :56-100: ref
    base unless its weight is a minority, then weight-argmax with
    count tie-break, gated by MAF_sub/MAF_noref and minDepth), then
    insertion-chain nodes while their weight is a majority and
    count-fraction >= MAF_ins.
  - defaults (ConsensusObject :34-41): minDepth=2, MAF_sub=0.25,
    MAF_del=0.5, MAF_ins=0.5, MAF_noref=0.4.

The accumulation is one np.add.at scatter per batch (match strings are
decoded to (rpos, plane, base, weight) streams); insertions are a host
dict because they are rare.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.dna import BASE_TO_CODE, CODE_TO_BASE
from ..core.parser import tokenize
from ..io.fasta import load_reference, write_fasta
from ..io.sam_read import cigar_to_match, iter_sam

MIN_DEPTH = 2
MAF_SUB = 0.25
MAF_DEL = 0.5
MAF_INS = 0.5
MAF_NOREF = 0.4
FAKE_QUALITY = 20


@dataclass
class InsNode:
    weight: np.ndarray  # [4]
    count: np.ndarray  # [4]
    weight_sum: int = 0
    count_sum: int = 0
    next: "InsNode | None" = None


class ScaffoldGraph:
    def __init__(self, ref_codes: np.ndarray):
        L = len(ref_codes)
        self.ref_codes = ref_codes
        self.acgt_weight = np.zeros((L, 4), dtype=np.int64)
        self.acgt_count = np.zeros((L, 4), dtype=np.int64)
        self.ref_weight_sum = np.zeros(L, dtype=np.int64)
        self.ref_count_sum = np.zeros(L, dtype=np.int64)
        self.del_weight_sum = np.zeros(L, dtype=np.int64)
        self.del_count_sum = np.zeros(L, dtype=np.int64)
        self.ins: dict[int, InsNode] = {}

    def add_read(self, start0: int, match: bytes, seq_codes, quals):
        rpos = start0
        qpos = 0
        prev_rpos = None
        L = len(self.ref_codes)
        chain = None
        for m in match:
            if rpos >= L:
                break
            if m in (ord("m"), ord("S"), ord("N")):
                if 0 <= rpos < L:
                    q = int(quals[qpos]) if quals is not None else FAKE_QUALITY
                    w = q + 1
                    b = int(seq_codes[qpos])
                    if b < 4:
                        self.acgt_weight[rpos, b] += w
                        self.acgt_count[rpos, b] += 1
                    self.ref_weight_sum[rpos] += w
                    self.ref_count_sum[rpos] += 1
                qpos += 1
                rpos += 1
                chain = None
            elif m == ord("D"):
                if 0 <= rpos < L:
                    if quals is not None:
                        q2 = int(quals[min(qpos + 1, len(quals) - 1)])
                        q = (int(quals[min(qpos, len(quals) - 1)]) + q2) // 2
                    else:
                        q = FAKE_QUALITY
                    self.del_weight_sum[rpos] += q + 1
                    self.del_count_sum[rpos] += 1
                rpos += 1
                chain = None
            elif m == ord("I"):
                anchor = rpos - 1
                if anchor >= 0:
                    if chain is None:
                        chain = self.ins.setdefault(
                            anchor,
                            InsNode(
                                np.zeros(4, np.int64), np.zeros(4, np.int64)
                            ),
                        )
                    q = int(quals[qpos]) if quals is not None else FAKE_QUALITY
                    w = q + 1
                    b = int(seq_codes[qpos])
                    if b < 4:
                        chain.weight[b] += w
                        chain.count[b] += 1
                    chain.weight_sum += w
                    chain.count_sum += 1
                    if chain.next is None:
                        chain.next = InsNode(
                            np.zeros(4, np.int64), np.zeros(4, np.int64)
                        )
                    chain = chain.next
                qpos += 1
            elif m == ord("C"):
                qpos += 1
                chain = None
            else:
                chain = None

    def _node_consensus(self, pos: int, only_ns: bool):
        """BaseNode.consensus for a ref node; returns (code, qual)."""
        refc = int(self.ref_codes[pos])
        ref_n = refc >= 4
        if only_ns and not ref_n:
            return refc, 20
        w = self.acgt_weight[pos]
        c = self.acgt_count[pos]
        wsum = int(self.ref_weight_sum[pos])
        csum = int(self.ref_count_sum[pos])
        max_pos = refc if refc < 4 else 0
        max_w = int(w[max_pos]) if not ref_n else int(w[0])
        max_d = int(c[max_pos]) if not ref_n else int(c[0])
        if ref_n:
            max_pos = 0
        if max_w * 2 < wsum:
            for i in range(4):
                x, y = int(w[i]), int(c[i])
                if x > max_w or (x == max_w and y > max_d):
                    max_w, max_d, max_pos = x, y, i
        af = max_d / csum if csum else 0.0
        maf = MAF_NOREF if ref_n else MAF_SUB
        if af < maf or max_d < MIN_DEPTH:
            return refc, (0 if ref_n else 2)
        q = 10.0 * np.log10(max_w / max(0.01, wsum)) if wsum else 2
        q = min(41, max(2, int(round(q))))
        return max_pos, q

    def traverse(self, no_indels: bool = False, only_ns: bool = False):
        out = []
        quals = []
        L = len(self.ref_codes)
        stats = {"sub": 0, "ref": 0, "del": 0, "ins": 0}
        for i in range(L):
            dw = int(self.del_weight_sum[i])
            rw = int(self.ref_weight_sum[i])
            dc = int(self.del_count_sum[i])
            rc = int(self.ref_count_sum[i])
            depth = dc + rc
            daf = dc / depth if depth else 0.0
            weight_sum = dw + rw
            if rw >= dw or daf < MAF_DEL or no_indels:
                b, q = self._node_consensus(i, only_ns)
                out.append(b)
                denom = max(0.01, weight_sum - rw)
                q2 = 10.0 * np.log10(rw / denom) if rw > 0 else 2
                q2 = min(41, max(2, int(round(q2))))
                quals.append(min(q, q2))
                if b == int(self.ref_codes[i]):
                    stats["ref"] += 1
                else:
                    stats["sub"] += 1
                node = self.ins.get(i)
                af_mult = 1.0 / depth if depth else 0.0
                while (
                    node is not None
                    and not no_indels
                    and node.count_sum > 0
                    and node.weight_sum >= (weight_sum - node.weight_sum)
                    and node.count_sum * af_mult >= MAF_INS
                ):
                    bi = int(np.argmax(node.weight))
                    out.append(bi)
                    quals.append(20)
                    stats["ins"] += 1
                    node = node.next
            else:
                stats["del"] += 1
        return np.array(out, dtype=np.uint8), np.array(quals), stats


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in_sam = a.get("in", "in1")
    ref_path = a.get("ref")
    out = a.get("out", "consensus")
    no_indels = a.get_bool("noindels", default=False)
    only_ns = a.get_bool("onlyconvertns", "nonly", "onlyn", default=False)
    if not in_sam or not ref_path:
        raise ValueError("consensus requires in=<sam/bam> ref=<fasta>")
    ref = load_reference(ref_path)
    graphs = {}
    name_of = {}
    for i, nm in enumerate(ref.names):
        key = nm.split()[0]
        graphs[key] = ScaffoldGraph(ref.scaffold_codes(i))
        name_of[key] = nm
    n_reads = 0
    for rec in iter_sam(in_sam):
        if not rec.mapped or rec.secondary:
            continue
        g = graphs.get(rec.rname)
        if g is None:
            continue
        match = cigar_to_match(rec, g.ref_codes)
        seq_codes = BASE_TO_CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
        quals = (
            np.frombuffer(rec.qual, np.uint8).astype(np.int64) - 33
            if rec.qual != b"*"
            else None
        )
        g.add_read(rec.pos - 1, match, seq_codes, quals)
        n_reads += 1
    records = []
    tot = {"sub": 0, "ref": 0, "del": 0, "ins": 0}
    for key, g in graphs.items():
        codes, quals, st = g.traverse(no_indels=no_indels, only_ns=only_ns)
        for k in tot:
            tot[k] += st[k]
        records.append((name_of[key], CODE_TO_BASE[np.minimum(codes, 4)].tobytes()))
    if out:
        write_fasta(out, records)
    print(f"Reads Used:          \t{n_reads}", file=sys.stderr)
    print(
        f"Substitutions:       \t{tot['sub']}\n"
        f"Deletions:           \t{tot['del']}\n"
        f"Insertions:          \t{tot['ins']}",
        file=sys.stderr,
    )
    return tot
