"""The port's IO, on which every rqcfilter stage writes and reads
`.fastq.gz`: its FASTQ, gzip and BGZF writers and readers, FASTA, and the
deferred raw-ASCII plane (`LazyAscii`), held against the JAX package's on
tests/test_io.py's cases and on round trips of their own. Both packages
read and write the same bytes."""

import gzip
import importlib
import io

import numpy as np
import pytest

PKGS = ("bbtools_tpu", "bbtools_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _fastq_bytes(records):
    return b"".join(b"@" + n + b"\n" + s + b"\n+\n" + q + b"\n" for n, s, q in records)


RECORDS = {
    # tests/test_io.py's records, then mixed case, IUPAC codes, N and
    # lengths across the batch buckets
    "test_io": [(b"r1 some description", b"ACGTACGTAC", b"IIIIIIIIII"),
                (b"r2", b"GGGG", b"!!!!"), (b"r3", b"A" * 200, b"F" * 200)],
    "ascii": [(b"a 1:N:0:ACGT", b"acgtNNRYKMacgt", b"IIII####IIII55"),
              (b"b", b"N", b"!"), (b"c\tx=1", b"ACGTRYSWKMBDHVN" * 11, b"F" * 165)],
    "many": [(b"r%d" % i, bytes(np.random.default_rng(i).choice(list(b"ACGTN"), 30 + i % 270)
                                .astype(np.uint8)), b"?" * (30 + i % 270)) for i in range(700)],
}


@pytest.mark.parametrize("case", list(RECORDS))
@pytest.mark.parametrize("ext", ["fq", "fq.gz", "fastq.bgz"])
def test_fastq_write_read_roundtrip(tmp_path, case, ext):
    """Each package reads the records back from its writer's file of
    either compression, batch by batch, and both write the same bytes."""
    src = tmp_path / "src.fq"
    src.write_bytes(_fastq_bytes(RECORDS[case]))
    written = {}
    for pkg in PKGS:
        fq = _mod(pkg, "io.fastq")
        out = tmp_path / f"{pkg}.{ext}"
        with fq.FastqWriter(str(out)) as w:
            for b in reversed(list(fq.FastqReader(str(src), batch_reads=128))):
                w.add(b)  # out of order: the writer restores it
        written[pkg] = out.read_bytes()
        with _mod(pkg, "io.readwrite").open_input(str(out)) as fh:
            assert fh.read() == src.read_bytes()
        back = list(fq.FastqReader(str(out), batch_reads=128))
        assert [b.n for b in back] == [min(128, len(RECORDS[case]) - i)
                                       for i in range(0, len(RECORDS[case]), 128)]
        ids = [i for b in back for i in b.ids]
        assert ids == [n for n, _, _ in RECORDS[case]]
    assert written["bbtools_torch"] == written["bbtools_tpu"]
    if ext != "fq":
        assert gzip.decompress(written["bbtools_torch"]) == src.read_bytes()


def test_bgzf_blocks_roundtrip(tmp_path):
    """BGZF across several blocks: the port's blocks equal the JAX
    package's, the stdlib reads them as one gzip stream, and both
    readers read any chunking back."""
    rng = np.random.default_rng(5)
    data = bytes(rng.choice(list(b"ACGT\n"), 3 * 0xFF00 + 1234).astype(np.uint8))
    blobs = {}
    for pkg in PKGS:
        bg = _mod(pkg, "io.bgzf")
        buf = io.BytesIO()
        w = bg.BgzfWriter(buf, level=6, threads=2)
        for off in range(0, len(data), 9_999):
            w.write(data[off: off + 9_999])
        w.flush()
        blobs[pkg] = buf.getvalue()
        w.close()
    assert blobs["bbtools_torch"] == blobs["bbtools_tpu"]
    assert gzip.decompress(blobs["bbtools_torch"]) == data
    for pkg in PKGS:
        r = _mod(pkg, "io.bgzf").BgzfReader(io.BytesIO(blobs["bbtools_torch"]), threads=2)
        got = b""
        while True:
            part = r.read(7_777)
            if not part:
                break
            got += part
        assert got == data


def test_gzip_batching_and_ordinals(tmp_path):
    """tests/test_io.py's gzip batching case through the port: the same
    batch sizes, ordinals and first numeric ids as the JAX package."""
    p = tmp_path / "x.fq.gz"
    with gzip.open(p, "wb") as fh:
        fh.write(_fastq_bytes([(b"r%d" % i, b"ACGT" * 10, b"I" * 40) for i in range(1000)]))
    got = {pkg: [(b.n, b.ordinal, b.numeric_id0, b.ids[-1])
                 for b in _mod(pkg, "io.fastq").FastqReader(str(p), batch_reads=256)]
           for pkg in PKGS}
    assert got["bbtools_torch"] == got["bbtools_tpu"]
    assert [g[0] for g in got["bbtools_torch"]] == [256, 256, 256, 232]


def test_quality_offsets(tmp_path):
    """Offset-64 and offset-33 files decode to the same phred planes in
    both packages."""
    for qual in (bytes([70, 80, 90, 104]), b"!+5I"):
        p = tmp_path / "q.fq"
        p.write_bytes(_fastq_bytes([(b"r", b"ACGT", qual)]))
        planes = [_mod(pkg, "io.fastq").read_fastq(str(p))[0].quals for pkg in PKGS]
        np.testing.assert_array_equal(planes[0], planes[1])


@pytest.mark.parametrize("wrap", [50, 70])
@pytest.mark.parametrize("gz", [False, True])
def test_fasta_roundtrip(tmp_path, wrap, gz):
    """write_fasta, read_fasta, iter_fasta and load_reference, plain and
    gzipped: the same records, bytes and reference in both packages."""
    recs = [(b"chr1 desc", b"ACGT" * 30), (b"chr2", b"TTTT"), (b"chr3", b"acgtNNRY" * 40)]
    out = {}
    for pkg in PKGS:
        fa = _mod(pkg, "io.fasta")
        p = tmp_path / f"{pkg}.fa{'.gz' if gz else ''}"
        fa.write_fasta(str(p), recs, wrap=wrap)
        with _mod(pkg, "io.readwrite").open_input(str(p)) as fh:
            text = fh.read()
        got = [(r.name, r.seq) for r in fa.read_fasta(str(p))]
        assert got == [(r.name, r.seq) for r in fa.iter_fasta(str(p))]
        ref = fa.load_reference(str(p))
        out[pkg] = (text, got, ref.n_scaffolds, ref.scaffold_of(np.array([0, 120, 124])).tolist(),
                    bytes(_mod(pkg, "core.dna").decode(ref.scaffold_codes(1))))
    assert out["bbtools_torch"] == out["bbtools_tpu"]
    assert out["bbtools_torch"][1][0] == (b"chr1 desc", b"ACGT" * 30)
    assert max(len(ln) for ln in out["bbtools_torch"][0].splitlines()) == wrap


def test_format_detection(tmp_path):
    fq = tmp_path / "a.fq"
    fq.write_bytes(_fastq_bytes([(b"r", b"ACGT", b"IIII")]))
    anon = tmp_path / "anon"
    anon.write_bytes(fq.read_bytes())
    fa = tmp_path / "b.fa.gz"
    with gzip.open(fa, "wb") as fh:
        fh.write(b">x\nACGT\n")
    for path in (fq, anon, fa):
        got = [_mod(pkg, "io.fileformat").test_input(str(path)) for pkg in PKGS]
        assert (got[0].format.name, got[0].compression.name) == \
            (got[1].format.name, got[1].compression.name)


def test_lazy_ascii_plane(tmp_path):
    """The deferred raw-ASCII plane: untouched until read, then the
    file's bases with case and IUPAC codes kept, padded with N; slices,
    rows and a widened plane as the JAX package's."""
    p = tmp_path / "a.fq"
    p.write_bytes(_fastq_bytes(RECORDS["ascii"] + RECORDS["test_io"]))
    planes = {}
    for pkg in PKGS:
        b = next(iter(_mod(pkg, "io.fastq").FastqReader(str(p))))
        lazy = b.__dict__.get("_lazy_ascii")
        assert lazy is not None and "ascii_bases" not in b.__dict__
        assert lazy.rows() == b.n == 6
        rows = [lazy.row(i) for i in range(b.n)]
        assert rows == [s for _, s, _ in RECORDS["ascii"] + RECORDS["test_io"]]
        part = lazy.slice(1, 3).widened(b.padded_len + 8).materialize()
        planes[pkg] = (b.ascii_bases.copy(), part, rows)
        assert bytes(b.ascii_bases[0, :14]) == b"acgtNNRYKMacgt"
        assert (b.ascii_bases[1, 1:] == ord("N")).all()
    for x, y in zip(planes["bbtools_torch"], planes["bbtools_tpu"]):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_interleaved_roundtrip(tmp_path):
    """tests/test_io.py's interleaved case through the port: detection,
    paired_reader, interleave and deinterleave as the JAX package's."""
    fin = tmp_path / "inter.fq"
    fin.write_bytes(b"".join(b"@r%d/1\nACGTACGTAA\n+\nFFFFFFFFFF\n@r%d/2\nTTGCATGCAT\n+\n"
                             b"FFFFFFFFFF\n" % (i, i) for i in range(10)))
    out = {}
    for pkg in PKGS:
        fq = _mod(pkg, "io.fastq")
        assert fq.detect_interleaved(str(fin))
        b1, b2 = next(iter(fq.paired_reader(str(fin))))
        bi = fq.interleave(b1, b2)
        h1, h2 = fq.deinterleave(bi)
        out[pkg] = (bi.ids, bi.bases.tolist(), h1.ids, h2.lengths.tolist(),
                    fq.encode_fastq(bi))
    assert out["bbtools_torch"] == out["bbtools_tpu"]
    assert out["bbtools_torch"][4] == fin.read_bytes()
