"""SSU/rRNA tools: splitribo (route rRNAs by type) and mergeribo (one
best SSU per taxID).

References (semantics source, no code reuse):
  - prok/SplitRibo.java (splitribo.sh) — align each sequence to the
    universal consensus of each type (16S/18S/5S/23S/m16S/m18S/p16S,
    bundled `<type>_consensus_sequence.fa`, first record = universal);
    route to the best type when identity >= minid (0.59), refining
    against clade-specific consensus records when the universal identity
    is below refineid (0.70) or the hit is p16S (:509-541). Non-matching
    sequences go to the `junk` stream.
  - prok/MergeRibo.java (mergeribo.sh) — score every SSU as
    lengthMult(len)*identity (lengthMult = min(len,ideal)/max(len,ideal),
    ideal 1600 :762-777; identity vs the 16S/18S universal consensus),
    group by taxID, and keep the best-scoring sequence per taxon
    (pickBestInner :595 fast path; the BaseGraph consensus refinement
    pass is not reproduced).

The PyTorch port of bbtools_tpu/models/ribo.py: every alignment runs
through the batched glocal aligner on the run's device
(ops/idalign.glocal_identity, `device=`, cuda by default) — a batch of
reads against the consensus panel in one call, then the clade
refinement in a second — instead of the reference's per-thread
SingleStateAligner loops. The bundled consensus files are the JAX
package's, read by path (bbtools_tpu/resources/).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.dna import encode
from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.readwrite import open_output

RES_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "bbtools_tpu", "resources")
DEFAULT_TYPES = ("16S", "18S", "5S", "23S", "m16S", "m18S", "p16S")


def load_consensus(types):
    """[(type, [codes...])] — record 0 is the universal consensus."""
    out = []
    for t in types:
        path = os.path.join(RES_DIR, f"{t}_consensus_sequence.fa")
        recs = [encode(r.seq) for r in iter_fasta(path)]
        if recs:
            out.append((t, recs))
    return out


def _batch_identities(queries: list[np.ndarray], refs: list[np.ndarray],
                      device="cuda"):
    """identity[q, r] via the batched glocal aligner on `device`, one
    call."""
    from ..ops.idalign import glocal_identity

    nq, nr = len(queries), len(refs)
    qlen = max(len(q) for q in queries)
    rlen = max(len(r) for r in refs)
    qs = np.zeros((nq * nr, qlen), np.uint8)
    qlens = np.zeros(nq * nr, np.int32)
    rs = np.zeros((nq * nr, rlen), np.uint8)
    rlens = np.zeros(nq * nr, np.int32)
    for i, q in enumerate(queries):
        for j, r in enumerate(refs):
            t = i * nr + j
            qs[t, : len(q)] = q
            qlens[t] = len(q)
            rs[t, : len(r)] = r
            rlens[t] = len(r)
    ident, _, _ = glocal_identity(qs, qlens, rs, rlens, device)
    return ident.cpu().numpy().reshape(nq, nr)


def splitribo(argv=None):
    from ..device import resolve_device

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    ins = (a.get("in", "in1") or "").split(",")
    pattern = a.get("out", "out1", default="out_#.fa")
    if "#" not in pattern and "%" not in pattern:
        raise ValueError("out= must contain # (replaced by the type)")
    sym = "#" if "#" in pattern else "%"
    types = tuple(
        t for t in (a.get("types") or ",".join(DEFAULT_TYPES)).split(",")
        if t
    )
    minid = a.get_float("minid", default=0.59)
    refineid = a.get_float("refineid", default=0.70)
    batch = a.get_int("batch", default=64)

    consensus = load_consensus(types)
    universal = [recs[0] for _, recs in consensus]
    clade_refs = []  # flattened clade-specific, with owning type index
    for ti, (_, recs) in enumerate(consensus):
        for r in recs[1:]:
            clade_refs.append((ti, r))

    writers: dict[str, object] = {}

    def write_to(tname, rec):
        w = writers.get(tname)
        if w is None:
            w = open_output(pattern.replace(sym, tname))
            writers[tname] = w
        w.write(b">" + rec.name + b"\n")
        for i in range(0, len(rec.seq), 70):
            w.write(rec.seq[i : i + 70] + b"\n")

    counts: dict[str, int] = {}
    pending: list = []

    def flush():
        if not pending:
            return
        qs = [encode(r.seq) for r in pending]
        ident = _batch_identities(qs, universal, device)
        best_t = ident.argmax(axis=1)
        best_id = ident.max(axis=1)
        # second stage: refine low-confidence / p16S hits against
        # clade-specific consensus records
        need = [
            i for i in range(len(pending))
            if (best_id[i] < refineid
                or types[best_t[i]] == "p16S")
        ]
        if need and clade_refs:
            ident2 = _batch_identities(
                [qs[i] for i in need], [r for _, r in clade_refs], device
            )
            for row, i in enumerate(need):
                j = int(ident2[row].argmax())
                if ident2[row, j] > best_id[i]:
                    best_id[i] = ident2[row, j]
                    best_t[i] = clade_refs[j][0]
        for i, rec in enumerate(pending):
            tname = types[best_t[i]] if best_id[i] >= minid else "junk"
            write_to(tname, rec)
            counts[tname] = counts.get(tname, 0) + 1
        pending.clear()

    for path in ins:
        for rec in iter_fasta(path):
            pending.append(rec)
            if len(pending) >= batch:
                flush()
    flush()
    for w in writers.values():
        w.close()
    for t, n in sorted(counts.items()):
        print(f"{t}:\t{n}", file=sys.stderr)
    return counts


def _taxid_of(name: bytes) -> int:
    s = name.decode(errors="replace")
    if s.startswith("tid|"):
        try:
            return int(s.split("|")[1])
        except (IndexError, ValueError):
            return -1
    if s.startswith("tid_"):
        try:
            return int(s.split("_")[1])
        except (IndexError, ValueError):
            return -1
    return -1


def mergeribo(argv=None):
    from ..device import resolve_device

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    ins = (a.get("in", "in1") or "").split(",")
    out1 = a.get("out", "out1")
    ideal = a.get_int("ideal", "ideallength", default=1600)
    ssu_types = tuple(
        t for t in (a.get("types") or "16S,18S").split(",") if t
    )

    consensus = [recs[0] for _, recs in load_consensus(ssu_types)]
    groups: dict[int, list] = {}
    order: list[int] = []
    recs_all = []
    for path in ins:
        for rec in iter_fasta(path):
            tid = _taxid_of(rec.name)
            if tid not in groups:
                groups[tid] = []
                order.append(tid)
            groups[tid].append(len(recs_all))
            recs_all.append(rec)
    idents = _batch_identities(
        [encode(r.seq) for r in recs_all], consensus, device
    ).max(axis=1) if recs_all else np.zeros(0)

    def score(idx):
        ln = len(recs_all[idx].seq)
        mult = min(ln, ideal) / max(ln, ideal, 1)
        return mult * float(idents[idx])

    n = 0
    with open_output(out1) as fh:
        for tid in order:
            best = max(groups[tid], key=score)
            rec = recs_all[best]
            fh.write(b">" + rec.name + b"\n")
            for i in range(0, len(rec.seq), 70):
                fh.write(rec.seq[i : i + 70] + b"\n")
            n += 1
    print(
        f"Kept {n} of {len(recs_all)} sequences "
        f"({len(groups)} taxa).", file=sys.stderr,
    )
    return n


if __name__ == "__main__":
    splitribo()
