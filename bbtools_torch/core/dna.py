"""DNA base codecs: ASCII <-> 2-bit codes, complements, k-mer text utils.

Semantics follow the reference's canonical encoding (A=0, C=1, G=2, T=3;
dna/AminoAcid.java:188-234): `baseToNumber` maps
ACGT (either case, U==T) to 0..3 and everything else to -1. We use a dense
uint8 representation where 0..3 are the defined codes and N_CODE (4) marks
any undefined base — a value chosen so vectorized compares (`code >= 4`)
find invalid positions without a second lookup.
"""

from __future__ import annotations

import numpy as np

N_CODE = np.uint8(4)

#: ASCII byte -> 2-bit code, undefined -> N_CODE. uint8[256].
BASE_TO_CODE = np.full(256, N_CODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_TO_CODE[_b] = _i
    BASE_TO_CODE[_b | 0x20] = _i  # lowercase
BASE_TO_CODE[ord("U")] = 3
BASE_TO_CODE[ord("u")] = 3

#: 2-bit code -> ASCII byte; N_CODE -> 'N'.
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

#: ASCII byte -> complement ASCII byte (identity for non-bases, like the
#: reference's baseToComplementExtended for the common cases).
COMP_BASE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtUu", b"TGCAtgcaAa"):
    COMP_BASE[_a] = _b

#: 2-bit code -> complement code (A<->T, C<->G); N_CODE -> N_CODE.
COMP_CODE = np.array([3, 2, 1, 0, N_CODE], dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, N_CODE for undefined)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return BASE_TO_CODE[arr]


def decode(codes: np.ndarray) -> bytes:
    """uint8 codes -> ASCII bytes ('N' for any undefined code)."""
    return CODE_TO_BASE[np.minimum(codes, N_CODE)].tobytes()


def reverse_complement(seq: bytes | str) -> bytes:
    """Reverse-complement of an ASCII sequence."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    return COMP_BASE[arr][::-1].tobytes()


def rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of a 2-bit code vector (N_CODE preserved)."""
    return COMP_CODE[np.minimum(codes, N_CODE)][::-1]


def kmer_to_text(kmer: int, k: int) -> str:
    """Decode a packed 2-bit k-mer (high bits = first base) to text.

    Matches AbstractKmerTable.toText ordering (first base in the highest
    2 bits), the layout produced by the rolling `kmer=(kmer<<2)|x` loop.
    """
    out = []
    for i in range(k - 1, -1, -1):
        out.append("ACGT"[(kmer >> (2 * i)) & 3])
    return "".join(out)


def text_to_kmer(s: str) -> int:
    """Inverse of kmer_to_text."""
    kmer = 0
    for ch in s:
        kmer = (kmer << 2) | int(BASE_TO_CODE[ord(ch)])
    return kmer
