"""Side-channel micro-mapper: align reads to a tiny reference (phiX) in
parallel with the main BBDuk pipeline, writing hits to a SAM file.

The PyTorch port of bbtools_tpu/models/sidechannel.py, itself a
re-design of aligner/SideChannel4.java (:24-205): the reference maps each
surviving read pair with MicroAligner3 (k1 index, k2 fallback for a
half-mapped pair), flags proper pairs, and streams mapped reads to an
`alignout=` SAM. Here the per-batch candidate search + verification run
as batched torch ops on the device given (ops/microalign.py, cuda by
default); only the rare quick-gate failures fall back to a host glocal
DP. The host code is the JAX package's; the keyword `phix` names the
phiX genome bundled with the JAX package, read by path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dna import encode
from ..device import resolve_device
from ..io.batch import ReadBatch
from ..io.fasta import iter_fasta
from ..io.sam import (
    FFIRST,
    FPAIRED,
    FPROPER,
    FREVERSE,
    FSECOND,
    SamRecord,
    SamWriter,
    match_to_cigar14,
)
from ..ops.microalign import (
    MicroIndex,
    glocal_flat_align,
    identity_flat,
    micro_map_batch,
    quick_align_batch,
    quick_match_string,
)

PAD = 5  # MicroAligner3.map pad for the DP window


def _resolve_side_ref(path: str) -> str:
    """SideChannel4.fixRefPath: keyword `phix` -> the phix2.fa.gz bundled
    with the JAX package (bbtools_tpu/resources/), read by path."""
    import os

    if path and path.lower() == "phix":
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return os.path.join(repo, "bbtools_tpu", "resources", "phix2.fa.gz")
    return path


class SideChannel:
    def __init__(self, ref: str, out: str | None, k1: int = 17,
                 k2: int = 13, minid1: float = 0.66, minid2: float = 0.56,
                 mm1: int = 1, mm2: int = 0, device="cuda"):
        self.device = resolve_device(str(device))
        ref = _resolve_side_ref(ref)
        recs = list(iter_fasta(ref))
        codes = encode(recs[0].seq)
        name = recs[0].name.split()[0] if recs[0].name else b"ref"
        if minid1 > 1:
            minid1 /= 100
        if minid2 > 1:
            minid2 /= 100
        self.idx1 = MicroIndex.build(codes, k1, mm1, minid1, name)
        self.idx2 = (
            MicroIndex.build(codes, k2, mm2, minid2, name) if k2 > 0 else None
        )
        self.ref_codes = codes
        self.name = name
        self.writer = (
            SamWriter(out, [name], [len(codes)], program=b"bbtools_torch-side")
            if out
            else None
        )
        self.reads_out = 0
        self.bases_out = 0
        self.reads_mapped = 0
        self.identity_sum = 0.0  # percent sum, SideChannel4 idsum/100

    def _map_one_side(self, idx: MicroIndex, batch: ReadBatch,
                      active: np.ndarray):
        """Map one read side with one index; returns per-read dicts."""
        cfg = idx.cfg
        kt, it, refdev = idx.device_tables(self.device)
        bases = torch.from_numpy(np.ascontiguousarray(batch.bases)).to(self.device)
        lengths = torch.from_numpy(
            np.ascontiguousarray(batch.lengths, dtype=np.int32)).to(self.device)
        hit, offset, strand = micro_map_batch(cfg, kt, it, bases, lengths)
        qa = quick_align_batch(cfg, refdev, bases, lengths, offset, strand)
        hit = hit.cpu().numpy() & active & (batch.lengths >= cfg.k)
        offset = offset.cpu().numpy()
        strand = strand.cpu().numpy()
        quick_ok = qa["quick_ok"].cpu().numpy()
        ident = qa["identity"].cpu().numpy()
        B = batch.n
        mapped = np.zeros(B, bool)
        out_id = np.zeros(B, np.float32)
        out_start = np.zeros(B, np.int32)
        match_strs: list[bytes | None] = [None] * B
        for i in np.nonzero(hit)[0]:
            L = int(batch.lengths[i])
            codes = batch.bases[i, :L]
            if strand[i] == 1:
                codes = 3 - codes[::-1]
                codes = np.where(codes > 3, 4, codes).astype(np.uint8)
            if quick_ok[i] and ident[i] >= cfg.min_id:
                mapped[i] = True
                out_id[i] = ident[i]
                out_start[i] = offset[i]
                match_strs[i] = quick_match_string(
                    codes, self.ref_codes, int(offset[i])
                )
                continue
            # DP fallback (MicroAligner3.align :105-144)
            m, rstart = glocal_flat_align(
                codes, self.ref_codes, int(offset[i]) - PAD,
                int(offset[i]) + L + PAD
            )
            fid = identity_flat(m)
            if fid >= cfg.min_id:
                mapped[i] = True
                out_id[i] = fid
                out_start[i] = rstart
                match_strs[i] = m
        return mapped, out_id, out_start, strand, match_strs

    def map_batch(self, b1: ReadBatch, b2: ReadBatch | None,
                  active: np.ndarray) -> np.ndarray:
        """Map all `active` (non-discarded) reads; write hits to the SAM.
        Returns the per-pair mapped mask (either side mapped)."""
        m1, id1, st1, sd1, ms1 = self._map_one_side(self.idx1, b1, active)
        if b2 is not None:
            m2, id2, st2, sd2, ms2 = self._map_one_side(self.idx2 or self.idx1, b2, active)
            if self.idx2 is not None:
                # k2 rescue for half-mapped pairs (SideChannel4.map :95-99)
                rescue2 = m1 & ~m2
                if rescue2.any():
                    r2m, r2id, r2st, r2sd, r2ms = self._map_one_side(
                        self.idx2, b2, rescue2
                    )
                    upd = r2m & rescue2
                    m2 |= upd
                    id2 = np.where(upd, r2id, id2)
                    st2 = np.where(upd, r2st, st2)
                    sd2 = np.where(upd, r2sd, sd2)
                    for i in np.nonzero(upd)[0]:
                        ms2[i] = r2ms[i]
                rescue1 = m2 & ~m1
                if rescue1.any():
                    r1m, r1id, r1st, r1sd, r1ms = self._map_one_side(
                        self.idx2, b1, rescue1
                    )
                    upd = r1m & rescue1
                    m1 |= upd
                    id1 = np.where(upd, r1id, id1)
                    st1 = np.where(upd, r1st, st1)
                    sd1 = np.where(upd, r1sd, sd1)
                    for i in np.nonzero(upd)[0]:
                        ms1[i] = r1ms[i]
            proper = (
                m1 & m2 & (sd1 != sd2) & (np.abs(st1 - st2) <= 1000)
            )
        else:
            m2 = np.zeros_like(m1)
            id2 = np.zeros_like(id1)
            proper = np.zeros_like(m1)
        pair_mapped = m1 | m2
        # stats (SideChannel4.writeToMapped :136-168)
        npair = 2 if b2 is not None else 1
        sel = np.nonzero(pair_mapped)[0]
        self.reads_out += int(len(sel)) * npair
        self.bases_out += int(
            b1.lengths[sel].sum()
            + (b2.lengths[sel].sum() if b2 is not None else 0)
        )
        self.reads_mapped += int(m1.sum() + m2.sum())
        self.identity_sum += float(id1[m1].sum() + id2[m2].sum()) * 100.0
        if self.writer is not None and len(sel):
            payload = bytearray()
            for i in sel:
                payload += self._sam_line(b1, i, m1, id1, st1, sd1, ms1,
                                          proper, first=b2 is not None)
                if b2 is not None:
                    payload += self._sam_line(b2, i, m2, id2, st2, sd2, ms2,
                                              proper, second=True)
            self.writer.add_batch(b1.ordinal, bytes(payload))
        elif self.writer is not None:
            self.writer.add_batch(b1.ordinal, b"")
        return pair_mapped

    def _sam_line(self, b: ReadBatch, i: int, m, idv, stv, sdv, msv, proper,
                  first: bool = False, second: bool = False) -> bytes:
        L = int(b.lengths[i])
        from ..core.dna import decode

        seq = decode(b.bases[i, :L])
        qual = (
            bytes((b.quals[i, :L] + 33).astype(np.uint8))
            if b.quals is not None
            else b"*"
        )
        name = b.ids[i].split()[0] if i < len(b.ids) else b"r%d" % i
        flag = 0
        if first or second:
            flag |= FPAIRED | (FSECOND if second else FFIRST)
            if proper[i]:
                flag |= FPROPER
        if not m[i]:
            flag |= 0x4
            return SamRecord(name, flag, b"*", 0, 0, "*", seq=seq,
                             qual=qual).to_bytes()
        if sdv[i] == 1:
            flag |= FREVERSE
            seq = decode(
                np.where(
                    b.bases[i, :L][::-1] < 4, 3 - b.bases[i, :L][::-1], 4
                ).astype(np.uint8)
            )
            qual = qual[::-1] if qual != b"*" else qual
        cigar = match_to_cigar14(msv[i], int(stv[i]), len(self.ref_codes))
        pos = max(0, int(stv[i])) + 1
        tags = [b"YI:f:%.2f" % (idv[i] * 100.0)]
        return SamRecord(name, flag, self.name, pos, 40, cigar, seq=seq,
                         qual=qual, tags=tags).to_bytes()

    def stats_line(self, reads_in: int, bases_in: int) -> str:
        """SideChannel4.stats text."""
        rm = max(self.reads_mapped, 1)
        pct_r = 100.0 * self.reads_out / max(reads_in, 1)
        pct_b = 100.0 * self.bases_out / max(bases_in, 1)
        return (
            f"Aligned reads:          \t{self.reads_out} reads "
            f"({pct_r:.2f}%) \t{self.bases_out} bases ({pct_b:.2f}%) "
            f"\tavgID={self.identity_sum / (100.0 * rm):.4f}"
        )

    def close(self):
        if self.writer is not None:
            self.writer.close()
