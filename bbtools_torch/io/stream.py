"""Format-aware batch streaming — the ConcurrentReadInputStream factory.

The reference's stream factory picks a reader implementation from the
detected format (stream/ConcurrentReadInputStream.java:31-76,
StreamerFactory.java:19). `read_batches(path)` does the same: FASTQ or
FASTA in, ReadBatch stream out.
"""

from __future__ import annotations

from collections.abc import Iterator

from .batch import ReadBatch
from .fasta import iter_fasta
from .fileformat import Format, test_input
from .fastq import DEFAULT_BATCH_READS, FastqReader


class FastaBatchReader:
    """Batches FASTA records as quality-less reads."""

    def __init__(self, path: str, batch_reads: int = DEFAULT_BATCH_READS):
        self.path = path
        self.batch_reads = batch_reads
        self.reads_in = 0
        self.bases_in = 0

    def __iter__(self) -> Iterator[ReadBatch]:
        seqs: list[bytes] = []
        names: list[bytes] = []
        ordinal = 0
        numeric_id = 0
        for rec in iter_fasta(self.path):
            seqs.append(rec.seq)
            names.append(rec.name)
            if len(seqs) >= self.batch_reads:
                b = ReadBatch.from_sequences(seqs, ids=names, ordinal=ordinal)
                b.quals = None
                b.numeric_id0 = numeric_id
                numeric_id += b.n
                ordinal += 1
                self.reads_in += b.n
                self.bases_in += int(b.lengths.sum())
                yield b
                seqs, names = [], []
        if seqs:
            b = ReadBatch.from_sequences(seqs, ids=names, ordinal=ordinal)
            b.quals = None
            b.numeric_id0 = numeric_id
            self.reads_in += b.n
            self.bases_in += int(b.lengths.sum())
            yield b


def read_batches(path: str, batch_reads: int = DEFAULT_BATCH_READS,
                 with_ascii: bool = True, with_quals: bool = True):
    """Return a format-appropriate batch reader (with .reads_in/.bases_in).
    with_ascii=False skips the raw-byte plane for compute-only consumers;
    with_quals=False also skips the quality plane (kmer-spectrum readers
    touch only bases+lengths). FASTQ path only; FASTA batches are built
    from codes anyway."""
    ff = test_input(path)
    if ff.format is Format.FASTA:
        return FastaBatchReader(path, batch_reads)
    return FastqReader(path, batch_reads=batch_reads,
                       with_ascii=with_ascii, with_quals=with_quals)
