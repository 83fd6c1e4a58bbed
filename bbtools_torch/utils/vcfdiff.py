"""Compare two CallVariants VCFs that should be equal but for the
rounding of the scoring net (nn=t).

With nn=t the QUAL column and the last INFO field (SCR=) are a float32
net score scaled to 0-40 and printed to two decimals. Two devices, or
two libraries, sum the net's float32 matmuls in different orders, so
where a scaled score lies within a few ulps of a rounding boundary its
last printed digit flips. `qual_flips` allows exactly that and nothing
else; CallVariants without nn=t must give equal bytes.
"""

from __future__ import annotations


def qual_flips(a: bytes, b: bytes) -> int:
    """The number of rows in which VCFs a and b differ, where each such
    row differs in QUAL and SCR= only, both by the same 0.01; raises
    ValueError on any other difference, or when more than one data row
    in fifty (at least one) differs."""
    if a == b:
        return 0
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        raise ValueError(f"vcf: {len(la)} lines against {len(lb)}")
    flips = 0
    for x, y in zip(la, lb):
        if x == y:
            continue
        fx, fy = x.split(b"\t"), y.split(b"\t")
        if len(fx) < 8 or len(fx) != len(fy):
            raise ValueError(f"vcf lines differ: {x[:120]!r} / {y[:120]!r}")
        ix, iy = fx[7].split(b";"), fy[7].split(b";")
        dq = round(float(fx[5]) - float(fy[5]), 2)
        if (fx[:5] != fy[:5] or fx[6] != fy[6] or fx[8:] != fy[8:] or abs(dq) != 0.01
                or ix[:-1] != iy[:-1] or not ix[-1].startswith(b"SCR=")
                or not iy[-1].startswith(b"SCR=")
                or round(float(ix[-1][4:]) - float(iy[-1][4:]), 2) != dq):
            raise ValueError(f"vcf rows differ: {x[:120]!r} / {y[:120]!r}")
        flips += 1
    rows = sum(not x.startswith(b"#") for x in la)
    if flips > max(1, rows // 50):
        raise ValueError(f"vcf: {flips} of {rows} rows with a flipped QUAL digit")
    return flips
