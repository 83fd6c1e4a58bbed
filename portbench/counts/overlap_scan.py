"""What B5's insert scan (csrc/overlap_scan.cu) must move for one call,
frozen from the port's smoke run: the two code planes and two length
vectors read once, and the good, bad and overlap planes (int32, one
column an insert) written once.

Operations are not counted: the kernel compares 32 positions in one word
operation, so a count per position measures one implementation and not
the work; the bytes bound holds for any.
"""

SOURCE = "overlap_scan.cu"


def nbytes(pairs: int, width: int, inserts: int) -> int:
    return 2 * pairs * width + 2 * 4 * pairs + 3 * 4 * pairs * inserts


def least_seconds(calls: list[dict], peaks: dict) -> float:
    """The least time the card could take for these calls."""
    return sum(nbytes(c["pairs"], c["width"], c["inserts"]) / peaks["hbm_bytes_s"] for c in calls)
