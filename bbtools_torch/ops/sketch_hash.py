"""Reference-compatible BBSketch hashing (sketch/SketchObject.java).

BBSketch's hash is NOT a mixing function: it XORs per-byte entries of
seeded random code tables (makeCodes :515-527, antialiased to balanced
bit patterns :536-617) into the canonical key, with a dual-k scheme
(hashToValue2 :700-760): the middle k2-mer decides (via max2 % 4999
parity) whether the full-k or the k2 key is hashed, and the chosen class
is recorded in the hash's low bit. Interoperating with reference-written
.sketch files and servers requires this EXACT pipeline, including the
java.util.Random consumption order inside the antialiasing passes — all
transcribed here and verified against reference-format fixtures.

Defaults (SketchObject): k=32, k2=24, hashSeed=12345, HASH_VERSION=2,
bitsPerCycle=8 -> codes[8][256], keyFraction=0.16 ->
minHashValue=(1-0.32)*Long.MAX_VALUE. Sketch keys are stored as
Long.MAX_VALUE - hashcode, ascending (SketchHeap.java:114,244).
"""

from __future__ import annotations

import numpy as np

MASK48 = (1 << 48) - 1
MASK64 = (1 << 64) - 1
LONG_MAX = (1 << 63) - 1

HASH_SEED = 12345
DEFAULT_K = 32
DEFAULT_K2 = 24
KEY_FRACTION = 0.16
MIN_HASH_VALUE = int((1.0 - 2 * KEY_FRACTION) * LONG_MAX)

BITS_PER_CYCLE = 8
CODE_INCREMENT = 1 << BITS_PER_CYCLE  # 256
MAX_CYCLES = (64 + BITS_PER_CYCLE - 1) // BITS_PER_CYCLE  # 8


class JavaRandom:
    """Exact java.util.Random (48-bit LCG) — the code tables are defined
    by its consumption order."""

    def __init__(self, seed: int):
        self.s = (seed ^ 0x5DEECE66D) & MASK48

    def _next(self, bits: int) -> int:
        self.s = (self.s * 0x5DEECE66D + 0xB) & MASK48
        return self.s >> (48 - bits)

    def next_long_u64(self) -> int:
        """nextLong() as a uint64 bit pattern."""
        hi = self._next(32)
        lo = self._next(32)
        hi_s = hi - (1 << 32) if hi >= (1 << 31) else hi
        lo_s = lo - (1 << 32) if lo >= (1 << 31) else lo
        return ((hi_s << 32) + lo_s) & MASK64

    def next_int(self, bound: int) -> int:
        if bound & (bound - 1) == 0:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) <= 0x7FFFFFFF:  # int32 overflow?
                return val


def _antialias_number(number: int, randy: JavaRandom) -> int:
    while bin(number).count("1") < 31:
        number |= 1 << randy.next_int(64)
    while bin(number).count("1") > 33:
        number &= MASK64 ^ (1 << randy.next_int(64))
    return number


def _antialias_bit(array: list[int], randy: JavaRandom, bit: int):
    half = len(array) // 2
    ones = sum((x >> bit) & 1 for x in array)
    or_mask = 1 << bit
    and_mask = MASK64 ^ or_mask
    while ones < half - 1:
        loc = randy.next_int(len(array))
        while array[loc] & or_mask:
            loc = randy.next_int(len(array))
        array[loc] |= or_mask
        ones += 1
    while ones > half + 1:
        loc = randy.next_int(len(array))
        while not (array[loc] & or_mask):
            loc = randy.next_int(len(array))
        array[loc] &= and_mask
        ones -= 1


def make_codes1d(hash_seed: int = HASH_SEED) -> np.ndarray:
    """codes1D uint64 [MAX_CYCLES * 256] (SketchObject.makeCodes +
    makeCodes1D), bit-exact vs the Java construction."""
    randy = JavaRandom(hash_seed)
    rows = [
        [randy.next_long_u64() for _ in range(CODE_INCREMENT)]
        for _ in range(MAX_CYCLES)
    ]
    for _ in range(3):
        for array in rows:
            for _bit in range(64):
                for i in range(len(array)):
                    array[i] = _antialias_number(array[i], randy)
                _antialias_bit(array, randy, _bit)
    flat = [x for row in rows for x in row]
    return np.array(flat, dtype=np.uint64)


_CODES_CACHE: dict[int, np.ndarray] = {}


def codes1d(hash_seed: int = HASH_SEED) -> np.ndarray:
    """Disk+memory cached code tables (construction is seconds of exact
    scalar RNG replay; the table itself is 16 KB)."""
    tab = _CODES_CACHE.get(hash_seed)
    if tab is not None:
        return tab
    import os
    import tempfile

    cache = os.path.join(
        tempfile.gettempdir(), f"bbsketch_codes_{hash_seed}.npy"
    )
    if os.path.exists(cache):
        tab = np.load(cache)
    else:
        tab = make_codes1d(hash_seed)
        try:
            np.save(cache + ".tmp.npy", tab)
            os.replace(cache + ".tmp.npy", cache)
        except OSError:
            pass
    _CODES_CACHE[hash_seed] = tab
    return tab


def hash_v2(kmer: np.ndarray, rkmer: np.ndarray, k: int = DEFAULT_K,
            k2: int = DEFAULT_K2, hash_seed: int = HASH_SEED) -> np.ndarray:
    """hashToValue2 (SketchObject.java:700-760), vectorized; kmer/rkmer
    are uint64 2-bit-packed k-mers (k=32 uses all 64 bits). Returns
    int64 hashcodes (Java long semantics)."""
    tab = codes1d(hash_seed)
    km = kmer.astype(np.uint64)
    rk = rkmer.astype(np.uint64)
    k2shift = np.uint64(k - k2)  # in BITS for the default bitsPerBase=2
    k2mask = np.uint64((1 << (2 * k2)) - 1)
    k2midmask = np.uint64((int(k2mask) << (k - k2)) & MASK64)
    kmer2 = (km & k2midmask) >> k2shift
    rkmer2 = (rk & k2midmask) >> k2shift
    max2 = np.maximum(kmer2, rkmer2)
    use_k1 = ((max2 % np.uint64(4999)) & np.uint64(1)) == 0
    # Tools.max(kmer, rkmer) is SIGNED long comparison
    max1 = np.maximum(km.view(np.int64), rk.view(np.int64)).view(np.uint64)
    key = np.where(use_k1, max1, max2)
    code = key.copy()
    data = key.copy()
    active = np.ones(key.shape, dtype=bool)
    for i in range(MAX_CYCLES):
        x = (data & np.uint64(0xFF)).astype(np.int64)
        code = np.where(
            active, code ^ tab[np.uint64(i * CODE_INCREMENT) + x.astype(np.uint64)], code
        )
        data = data >> np.uint64(BITS_PER_CYCLE)
        active = active & (data != 0)  # do-while continuation test
    bit = np.where(use_k1, np.uint64(0), np.uint64(1))
    out = (code & ~np.uint64(1)) | bit
    return out.view(np.int64)


def rolling_kmers64_np(codes: np.ndarray, k: int = 32):
    """Per-position (fwd, rkm, runlen) uint64 rolling registers for the
    sketch default k=32 (all 64 bits; the generic int64 extractor caps at
    k=31). N resets the run length, as in SketchMakerMini's loop."""
    codes = np.asarray(codes)
    L = len(codes)
    defined = codes < 4
    code0 = np.where(defined, codes, 0).astype(np.uint64)
    comp0 = np.where(defined, 3 - codes, 0).astype(np.uint64)
    idx = np.arange(L, dtype=np.int64)
    marked = np.where(defined, np.int64(-1), idx)
    lastn = np.maximum.accumulate(marked)
    fwd = np.zeros(L, np.uint64)
    rkm = np.zeros(L, np.uint64)
    for j in range(k):
        sf = np.zeros(L, np.uint64)
        sf[j:] = code0[: L - j]
        fwd |= sf << np.uint64(2 * j)
        sr = np.zeros(L, np.uint64)
        sr[j:] = comp0[: L - j]
        live = (idx - j) > lastn
        sr[~live] = 0
        fwd_shift = np.uint64(2 * (k - 1 - j))
        rkm |= sr << fwd_shift
    runlen = (idx - lastn).astype(np.int32)
    return fwd, rkm, runlen


def hashes_for_codes(codes: np.ndarray, k: int = DEFAULT_K,
                     k2: int = DEFAULT_K2) -> np.ndarray:
    """All valid-window hashcodes (int64) of one sequence."""
    if len(codes) < k:
        return np.zeros(0, np.int64)
    fwd, rkm, runlen = rolling_kmers64_np(codes, k)
    valid = runlen >= k
    return hash_v2(fwd[valid], rkm[valid], k, k2)


def sketch_keys_from_hashes(hashes: np.ndarray, size: int) -> np.ndarray:
    """Bottom-k heap semantics: keep the `size` LARGEST hashcodes above
    minHashValue, store as Long.MAX_VALUE - hash, ascending (uint64)."""
    h = hashes[hashes > MIN_HASH_VALUE]
    h = np.unique(h)  # heap-set semantics: distinct keys, ascending
    if len(h) > size:
        h = h[-size:]
    # stored key = MAX - hash; largest hashes -> smallest keys, ascending
    return (np.int64(LONG_MAX) - h)[::-1].copy()
