"""SortByName — big-file read sorting (sort/SortByName.java, bbsort.sh).

In-memory sort for datasets that fit RAM, with chunked external merge for
larger inputs (the reference's temp-file merge design). Sort orders: name
(default), length (length=t), sequence (sequence=t).
"""

from __future__ import annotations

import heapq
import sys
import tempfile

from ..core.parser import tokenize
from ..io.fastq import FastqReader
from ..io.readwrite import open_output

CHUNK = 200_000


def _record_iter(path):
    for b in FastqReader(path):
        for i in range(b.n):
            yield (b.ids[i], b.sequence(i), b.quality_string(i))


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    by_length = a.get_bool("length", default=False)
    by_seq = a.get_bool("sequence", default=False)
    descending = a.get_bool("descending", "ascending", default=False) if False else a.get_bool("descending", default=False)

    def key(rec):
        if by_length:
            return (len(rec[1]), rec[0])
        if by_seq:
            return (rec[1], rec[0])
        return rec[0]

    chunks = []
    buf = []
    for rec in _record_iter(in1):
        buf.append(rec)
        if len(buf) >= CHUNK:
            buf.sort(key=key, reverse=descending)
            tf = tempfile.TemporaryFile()
            for r in buf:
                tf.write(b"@%s\n%s\n+\n%s\n" % r)
            tf.seek(0)
            chunks.append(tf)
            buf = []
    buf.sort(key=key, reverse=descending)
    n = 0
    with open_output(out1) as fh:
        if not chunks:
            for r in buf:
                fh.write(b"@%s\n%s\n+\n%s\n" % r)
                n += 1
        else:
            # external merge of sorted runs
            def run_iter(tf):
                while True:
                    h = tf.readline()
                    if not h:
                        return
                    s = tf.readline().rstrip(b"\n")
                    tf.readline()
                    q = tf.readline().rstrip(b"\n")
                    yield (h[1:].rstrip(b"\n"), s, q)

            iters = [run_iter(tf) for tf in chunks] + [iter(buf)]
            for rec in heapq.merge(*iters, key=key, reverse=descending):
                fh.write(b"@%s\n%s\n+\n%s\n" % rec)
                n += 1
    print(f"Sorted {n} reads.", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()


def mergesorted(argv=None):
    """mergesorted.sh (sort/MergeSorted.java): merge already-sorted
    files (e.g. SortByName temp files) into one sorted output.
    Usage: mergesorted sort_temp* out=<file> [length=t|sequence=t]."""
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out1 = a.get("out", "out1")
    by_length = a.get_bool("length", default=False)
    by_seq = a.get_bool("sequence", default=False)
    descending = a.get_bool("descending", default=False)

    def key(rec):
        if by_length:
            return (len(rec[1]), rec[0])
        if by_seq:
            return (rec[1], rec[0])
        return rec[0]

    n = 0
    with open_output(out1) as fh:
        for rec in heapq.merge(
            *[_record_iter(p) for p in files], key=key, reverse=descending
        ):
            fh.write(b"@%s\n%s\n+\n%s\n" % rec)
            n += 1
    print(f"Merged {n} reads from {len(files)} files.", file=sys.stderr)
    return n
