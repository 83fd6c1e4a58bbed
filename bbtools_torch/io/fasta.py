"""FASTA codec: multi-line records -> sequences / ReadBatch.

Parity target: stream/FastaReadInputStream.java (record grouping, arbitrary
line wrap) and dna/FastaToChromArrays2 (reference ingestion). Parsing is
host-side numpy; references used for indexing are returned as contiguous
code arrays with scaffold name/offset tables (the TPU analog of
ChromosomeArray, dna/ChromosomeArray.java:15).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.dna import BASE_TO_CODE
from .batch import ReadBatch
from .readwrite import open_input, open_output


@dataclass
class FastaRecord:
    name: bytes  # header without '>'
    seq: bytes


def iter_fasta(path: str):
    """Yield FastaRecord from a (possibly compressed) FASTA file."""
    name = None
    chunks: list[bytes] = []
    with open_input(path) as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield FastaRecord(name, b"".join(chunks))
                name = line[1:]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield FastaRecord(name, b"".join(chunks))


def read_fasta(path: str) -> list[FastaRecord]:
    return list(iter_fasta(path))


def write_fasta(path: str, records, wrap: int = 70):
    """Write FastaRecords (or (name, seq) tuples); wrap=0 disables wrapping."""
    with open_output(path) as fh:
        for rec in records:
            name, seq = (rec.name, rec.seq) if isinstance(rec, FastaRecord) else rec
            if isinstance(name, str):
                name = name.encode()
            if isinstance(seq, str):
                seq = seq.encode()
            fh.write(b">" + name + b"\n")
            if wrap:
                for i in range(0, len(seq), wrap):
                    fh.write(seq[i : i + wrap] + b"\n")
            else:
                fh.write(seq + b"\n")


@dataclass
class Reference:
    """A loaded reference: all scaffolds concatenated as 2-bit codes.

    TPU-native ChromosomeArray analog: one flat uint8 code array plus
    per-scaffold (name, start, length). Scaffolds are separated by a single
    N_CODE sentinel so no k-mer spans two scaffolds.
    """

    codes: np.ndarray  # uint8 [total]
    names: list[bytes]
    starts: np.ndarray  # int64 [nscaf]
    lengths: np.ndarray  # int64 [nscaf]

    @property
    def n_scaffolds(self) -> int:
        return len(self.names)

    def scaffold_codes(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.codes[s : s + int(self.lengths[i])]

    def scaffold_of(self, pos: np.ndarray) -> np.ndarray:
        """Map flat positions to scaffold indices (searchsorted on starts)."""
        return np.searchsorted(self.starts, pos, side="right") - 1


def load_reference(path: str) -> Reference:
    names: list[bytes] = []
    starts: list[int] = []
    lengths: list[int] = []
    parts: list[np.ndarray] = []
    pos = 0
    from ..core.dna import N_CODE

    sep = np.array([N_CODE], dtype=np.uint8)
    for rec in iter_fasta(path):
        names.append(rec.name)
        starts.append(pos)
        codes = BASE_TO_CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
        lengths.append(len(codes))
        parts.append(codes)
        parts.append(sep)
        pos += len(codes) + 1
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return Reference(
        codes=codes,
        names=names,
        starts=np.asarray(starts, dtype=np.int64),
        lengths=np.asarray(lengths, dtype=np.int64),
    )


def fasta_to_batch(path: str, pad_to: int | None = None) -> ReadBatch:
    """Load a FASTA file as a ReadBatch (no qualities)."""
    recs = read_fasta(path)
    return ReadBatch.from_sequences(
        [r.seq for r in recs],
        quals=None,
        ids=[r.name for r in recs],
        pad_to=pad_to,
    )
