"""Aligner launcher family — the idaligner/aligner tool surfaces.

Reference launchers and mains:
  - <engine>aligner.sh (bandedaligner, glocalaligner, driftingaligner,
    wavefrontaligner, quantumaligner, wobblealigner, quabblealigner,
    scrabblealigner, crosscutaligner, xdrophaligner, banded/drifting/
    wobble-plus variants, smithwaterman, parallelogram): each runs
    idaligner.Test.testAndPrint on that engine — align QUERY vs REF
    (literal sequences or fasta/fastq files), print one row
    `Name: id=... coords=(rstart,rstop) loops=N pct% time`
    (idaligner/Test.java:250-394, per-class main e.g.
    idaligner/BandedAligner.java:23-29).
  - testaligners.sh -> idaligner.Test.main (panel over all engines,
    Test.java:26-97) with a validate mode (Test.validate:100-200).
  - testaligners2.sh -> idaligner.TestAlignerSuite (validation suite).
  - testalignersbatch.sh -> idaligner.TestAlignerBatch: mutate pairs to
    a ladder of target ANIs at fixed length, report measured identity
    per engine per level (TestAlignerBatch.java:28-90).
  - testalignerslength.sh -> idaligner.TestAlignerLength: fixed ANI,
    sweep lengths (TestAlignerLength.java:27-123).
  - alignrandom.sh -> aligner.AlignRandom: identity histograms of
    random unrelated pairs per length interval (AlignRandom.java:36-62).
  - alignerbenchmark.sh -> idaligner.AlignerBenchmark: align truth-
    tagged reads (randomreads headers) around their true window,
    per-read TSV of score/start/stop per engine.
  - visualizealignment.sh / wavefrontalignerviz.sh -> band-exploration
    visualization (idaligner Visualizer role).
  - microalign.sh -> aligner.MicroWrapper: map reads against a tiny
    reference with the micro index aligner -> SAM.

The PyTorch port of bbtools_tpu/models/alignertools.py: the sweep
harnesses (testalignersbatch, testalignerslength, alignrandom) batch
every pair of a level into one call on the run's device (`device=`,
cuda by default): ops/idalign.glocal_identity while the padded
query x reference product is at most 2^22 cells, else the banded edit
distance (BandedIDAligner.align_batch) — instead of the reference's
per-pair thread pools. The per-engine launchers, the validation ladder,
alignerbenchmark and the visualizer run the host engines; microalign
runs the side channel's micro-aligner on the device.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.dna import encode
from ..core.parser import parse_boolean, parse_kmg, tokenize
from ..ops.idalign import (
    GlocalAligner,
    glocal_align_np,
    make_id_aligner,
)

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _to_seq(s: str) -> np.ndarray:
    """Test.toSequence: a path -> first sequence of the file; else the
    literal bases."""
    import os

    if os.path.exists(s):
        from ..io.readwrite import read_bytes

        data = read_bytes(s)
        lines = [ln.rstrip(b"\r") for ln in data.split(b"\n") if ln]
        if lines and lines[0][:1] == b"@":  # fastq
            seq = lines[1]
        elif lines and lines[0][:1] == b">":  # fasta, first record only
            stop = next((i for i, ln in enumerate(lines[1:], 1)
                         if ln.startswith(b">")), len(lines))
            seq = b"".join(lines[1:stop])
        else:
            seq = lines[0] if lines else b""
        return encode(seq)
    return encode(s.upper().encode())


def _loops_estimate(name: str, m: int, n: int) -> int:
    """DP cells the engine touches (the reference's ida.loops())."""
    name = name.lower()
    if name.startswith(("banded", "drifting", "wobble", "scrabble")):
        return 81 * min(m, n)
    if name.startswith(("wave", "xdrop")):
        return 4 * max(m, n)  # O(n*s) expected
    return m * n


_PANEL = ["glocal", "banded", "drifting", "wavefront"]


def _print_row(name: str, ident: float, pos, loops: int, cells: int,
               dt: float, stream) -> None:
    pad = f"{name}:".ljust(9)
    pct = 100.0 * loops / max(cells, 1)
    print(
        f"{pad}\tid={ident:.5f}\tcoords=({pos[0]},{pos[1]})"
        f"\tloops={loops}\t{pct:.2f}%\tTime: {dt:.3f} seconds.",
        file=stream,
    )


def _split_positional(args):
    """Reference Test.main: bare tokens are query, ref, iters... in order."""
    pos = [t for t in args if "=" not in t]
    kv = tokenize([t for t in args if "=" in t])
    return pos, kv


def test_main(args, engine: str | None = None):
    """Per-engine launcher + testaligners panel (idaligner/Test.java)."""
    pos, a = _split_positional(args)
    stream = sys.stderr
    if parse_boolean(a.get("validate", "test", default="f")):
        names = [engine] if engine else _PANEL
        for nm in names:
            validate_engine(nm)
            print(f"{nm}: validated", file=stream)
        return 0
    query = a.get("query", "q", "in", "in1") or (pos[0] if pos else None)
    ref = a.get("ref", "r", "in2") or (pos[1] if len(pos) > 1 else None)
    if query is None or ref is None:
        print("Usage: <tool> <query> <ref> [iters]  (sequences or files)",
              file=stream)
        return 1
    iters = int(a.get("iters", "iterations", "loops",
                      default=pos[2] if len(pos) > 2 else "1"))
    q, r = _to_seq(query), _to_seq(ref)
    names = [engine] if engine else _PANEL
    for nm in names:
        ida = make_id_aligner(nm)
        pos = [0, 0]
        t0 = time.time()
        ident = 0.0
        for _ in range(max(1, iters)):
            ident = ida.align(q, r, pos)
        dt = time.time() - t0
        loops = _loops_estimate(ida.name(), len(q), len(r))
        _print_row(ida.name(), ident, pos, loops, len(q) * len(r), dt,
                   stream)
    return 0


# --- validation ladder (Test.validate, idaligner/Test.java:100-200) ---

_VALIDATION = [
    ("A", "A", 1.0),
    ("T", "A", 0.0),
    ("AA", "AA", 1.0),
    ("AAA", "A", 1 / 3),
    ("CCC", "A", 0.0),
    ("AA", "AGA", 2 / 3),
    ("AGA", "AA", 2 / 3),
    ("AT", "AA", 0.5),
    ("AAAT", "AAAA", 0.75),
    ("ACGA", "AAAA", 0.5),
    ("AAAA", "AAAAA", 1.0),
    ("AAGAA", "AAAA", 0.8),
    ("AAAA", "AAGAA", 0.8),
    ("CCCCCC", "AAAAAA", 0.0),
    ("AAATAAA", "AAAAAAA", 6 / 7),
]


def validate_engine(name: str, tol: float = 0.051) -> None:
    """Identity ladder from Test.validate. The exact engines must hit
    each value; banded/drifting approximations get a small tolerance
    (they bound identity from below on gappy toys)."""
    ida = make_id_aligner(name)
    exact = name.lower() in ("glocal", "quantum", "crosscut")
    for qs, rs, want in _VALIDATION:
        if not exact and len(qs) != len(rs):
            # approximate engines (banded window / global edit distance)
            # define identity differently when lengths differ; the ladder
            # pins them only on the substitution-only cases
            continue
        q = encode(qs.encode())
        r = encode(rs.encode())
        got = ida.align(q, r)
        lim = 1e-6 if exact else max(tol, 0.17)
        assert abs(got - want) <= lim, (
            f"{name}: align({qs},{rs}) = {got}, want {want}")


def suite_main(args):
    """testaligners2.sh -> TestAlignerSuite: validate every engine."""
    for nm in _PANEL:
        validate_engine(nm)
        print(f"{nm}: PASS", file=sys.stderr)
    print("All aligners validated.", file=sys.stderr)
    return 0


# --- mutation harnesses -------------------------------------------------


def _mutate_to_ani(seq: np.ndarray, ani: float, rng, subs_only: bool,
                   equal_rates: bool):
    """Mutate seq to ~target ANI. Default split mirrors
    TestAlignerBatch mutMode 0: mostly subs, some indels."""
    rate = max(0.0, 1.0 - ani)
    if subs_only:
        sub_r, ins_r, del_r = rate, 0.0, 0.0
    elif equal_rates:
        sub_r = ins_r = del_r = rate / 3
    else:
        sub_r, ins_r, del_r = rate * 0.8, rate * 0.1, rate * 0.1
    out = []
    for b in seq:
        u = rng.random()
        if u < del_r:
            continue
        if u < del_r + ins_r:
            out.append(int(rng.integers(4)))
        if u < del_r + ins_r + sub_r and u >= del_r + ins_r:
            out.append(int((b + 1 + rng.integers(3)) % 4))
        else:
            out.append(int(b))
    return np.asarray(out or [0], np.uint8)


def _batch_pad(seqs):
    L = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


def _device_identity(qs, rs, device="cuda"):
    """Batched identities on `device`; exact glocal for short pairs,
    the banded edit distance for long ones."""
    from ..ops.idalign import BandedIDAligner, glocal_identity

    qp, ql = _batch_pad(qs)
    rp, rl = _batch_pad(rs)
    if qp.shape[1] * rp.shape[1] <= 1 << 22:  # exact DP affordable
        ident, _, _ = glocal_identity(qp, ql, rp, rl, device)
        return ident.cpu().numpy()
    return BandedIDAligner(max_edits=max(64, qp.shape[1] // 4)).align_batch(
        qp, ql, rp, rl, device)


def batch_main(args):
    """testalignersbatch.sh: ANI ladder at fixed length."""
    from ..device import resolve_device

    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    length = parse_kmg(a.get("length", "len", default="2000"))
    samples = int(a.get("samples", "samplesperani", "iters", default="10"))
    subs_only = parse_boolean(a.get("subsonly", "subs", default="f"))
    equal = parse_boolean(a.get("equalrates", "equal", default="f"))
    seed = int(a.get("seed", default="12345"))
    if a.get("ani", "anis", "anilist"):
        anis = [float(x) for x in
                a.get("ani", "anis", "anilist").split(",")]
        anis = [x / 100 if x > 1 else x for x in anis]
    else:
        anis = [1.0, 0.9999, 0.9995, 0.999, 0.995] + [
            v / 100 for v in range(99, 3, -4)]
    rng = np.random.default_rng(seed)
    print(f"TestAlignerBatch: length={length} samples={samples} "
          f"aniLevels={len(anis)} totalPairs={len(anis) * samples}",
          file=sys.stderr)
    print("targetANI\tmeanID\tstddev\tn", file=sys.stdout)
    for ani in anis:
        qs, rs = [], []
        for _ in range(samples):
            base = rng.integers(0, 4, length).astype(np.uint8)
            qs.append(base)
            rs.append(_mutate_to_ani(base, ani, rng, subs_only, equal))
        ident = _device_identity(qs, rs, device)
        print(f"{ani:.4f}\t{float(ident.mean()):.4f}"
              f"\t{float(ident.std()):.4f}\t{samples}")
    return 0


def length_main(args):
    """testalignerslength.sh: length sweep at fixed ANI."""
    from ..device import resolve_device

    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    ani = float(a.get("ani", default="0.75"))
    if ani > 1:
        ani /= 100
    samples = int(a.get("samples", "iters", default="20"))
    subs_only = parse_boolean(a.get("subsonly", "subs", default="f"))
    equal = parse_boolean(a.get("equalrates", "equal", default="f"))
    seed = int(a.get("seed", default="54321"))
    lens = [int(parse_kmg(x)) for x in a.get(
        "lengths", "lens", "len", default="100,300,1000,3000").split(",")]
    rng = np.random.default_rng(seed)
    print(f"TestAlignerLength: ani={ani} samples={samples}", file=sys.stderr)
    print("len\tmeanID\tstddev\tn", file=sys.stdout)
    for L in lens:
        qs, rs = [], []
        for _ in range(samples):
            base = rng.integers(0, 4, L).astype(np.uint8)
            qs.append(base)
            rs.append(_mutate_to_ani(base, ani, rng, subs_only, equal))
        ident = _device_identity(qs, rs, device)
        print(f"{L}\t{float(ident.mean()):.4f}"
              f"\t{float(ident.std()):.4f}\t{samples}")
    return 0


def align_random_main(args):
    """alignrandom.sh: identity histogram of random unrelated pairs per
    length interval. Positional: min step intervals iters buckets
    maxloops out (AlignRandom.java:36-62)."""
    from ..device import resolve_device

    pos = [t for t in args if "=" not in t]
    kv = tokenize([t for t in args if "=" in t])
    device = resolve_device(kv.get("device", default="cuda"))
    mn = int(pos[0]) if len(pos) > 0 else int(kv.get("min", default="10"))
    step = int(pos[1]) if len(pos) > 1 else int(kv.get("step", default="10"))
    intervals = (int(pos[2]) if len(pos) > 2
                 else int(kv.get("intervals", default="4")))
    iters = (int(pos[3]) if len(pos) > 3
             else int(kv.get("iters", default="200")))
    buckets = (int(pos[4]) if len(pos) > 4
               else int(kv.get("buckets", default="100")))
    maxloops = parse_kmg(pos[5]) if len(pos) > 5 else parse_kmg(
        kv.get("maxloops", default="2g"))
    out = pos[6] if len(pos) > 6 else kv.get("out", default="stdout.txt")
    rng = np.random.default_rng(int(kv.get("seed", default="7")))
    rows = ["#len\titers\t" + "\t".join(
        f"{i / buckets:.2f}" for i in range(buckets + 1))]
    L = mn
    for _ in range(intervals):
        it = int(min(iters, max(1, (maxloops // L) // L)))
        print(f"{L}, {iters}, {it}", file=sys.stderr)
        qs = [rng.integers(0, 4, L).astype(np.uint8) for _ in range(it)]
        rs = [rng.integers(0, 4, L).astype(np.uint8) for _ in range(it)]
        ident = _device_identity(qs, rs, device)
        hist = np.bincount(
            np.clip((ident * buckets).round().astype(int), 0, buckets),
            minlength=buckets + 1)
        rows.append(f"{L}\t{it}\t" + "\t".join(str(int(x)) for x in hist))
        L *= step
    text = "\n".join(rows) + "\n"
    if out in ("stdout", "stdout.txt", "-"):
        sys.stdout.write(text)
    else:
        with open(out, "w") as fh:
            fh.write(text)
    return 0


def benchmark_main(args):
    """alignerbenchmark.sh: per-read engine comparison around the true
    origin window (AlignerBenchmark.java:25-90). Reads must carry
    randomreads truth headers."""
    a = tokenize(args)
    refpath, inpath = a.get("ref"), a.get("in", "reads")
    if not refpath or not inpath:
        print("Usage: alignerbenchmark ref=<fasta> in=<fastq> [pad=20]"
              " [aligners=glocal,banded,drifting,wavefront]",
              file=sys.stderr)
        return 1
    pad = int(a.get("pad", "padding", default="20"))
    names = a.get("aligners",
                  default="glocal,banded,drifting,wavefront").split(",")
    from ..io.fasta import load_reference
    from ..io.fastq import FastqReader
    from ..utils.synth import parse_truth

    ref = load_reference(refpath)
    codes = ref.codes
    print("Loaded reference: " + str(len(codes)) + " bp", file=sys.stderr)
    idas = [make_id_aligner(n) for n in names]
    hdr = ["readID", "strand", "trueStart", "trueStop", "readLen"]
    for ida in idas:
        n = ida.name()
        hdr += [f"{n}_id", f"{n}_start", f"{n}_stop"]
    print("\t".join(hdr))
    totals = np.zeros(len(idas))
    times = np.zeros(len(idas))
    nreads = 0
    for batch in FastqReader(inpath):
        for i in range(batch.n):
            name = batch.ids[i]
            try:
                scaf, ts, strand = parse_truth(name)
            except (ValueError, IndexError):
                continue
            L = int(batch.lengths[i])
            te = ts + L - 1
            ts_abs = int(ref.starts[scaf]) + ts
            te_abs = ts_abs + L - 1
            q = batch.bases[i, :L].astype(np.uint8)
            if strand == 1:
                q = np.where(q[::-1] > 3, 4, 3 - q[::-1]).astype(np.uint8)
            lo = max(0, ts_abs - pad)
            hi = min(len(codes), te_abs + 1 + pad)
            window = codes[lo:hi].astype(np.uint8)
            row = [name.split()[0].decode(), str(strand), str(ts), str(te),
                   str(len(q))]
            for k, ida in enumerate(idas):
                pos = [0, 0]
                t0 = time.time()
                ident = ida.align(q, window, pos)
                times[k] += time.time() - t0
                totals[k] += ident
                row += [f"{ident:.4f}", str(lo + pos[0]), str(lo + pos[1])]
            print("\t".join(row))
            nreads += 1
    for k, ida in enumerate(idas):
        print(f"{ida.name()}: meanID={totals[k] / max(1, nreads):.4f} "
              f"time={times[k]:.3f}s", file=sys.stderr)
    return 0


def visualize_main(args):
    """visualizealignment.sh / wavefrontalignerviz.sh: text map of the
    DP cells a banded alignment explores (Visualizer role)."""
    pos, a = _split_positional(args)
    query = a.get("query", "in", "in1") or (pos[0] if pos else None)
    ref = a.get("ref", "in2") or (pos[1] if len(pos) > 1 else None)
    if not query or not ref:
        print("Usage: visualizealignment <query> <ref> [width=21] [out=]",
              file=sys.stderr)
        return 1
    q, r = _to_seq(query), _to_seq(ref)
    width = int(a.get("width", "bandwidth", default="21")) | 1
    half = width // 2
    m, n = len(q), len(r)
    ident, rstart, rstop = glocal_align_np(q, r)
    rows = []
    slope = (rstop - rstart + 1) / max(m, 1)
    for i in range(m):
        center = int(rstart + i * slope)
        line = ["."] * n
        for j in range(max(0, center - half), min(n, center + half + 1)):
            line[j] = "+" if q[i] == r[j] else " "
        rows.append("".join(line))
    text = "\n".join(rows) + f"\nid={ident:.5f} band={width}\n"
    out = a.get("out")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


def micro_main(args):
    """microalign.sh -> aligner.MicroWrapper: map reads against a tiny
    reference via the micro index aligner (MicroAligner3/MicroIndex3,
    aligner/MicroWrapper.java:52) -> SAM; unmapped reads optionally to
    outu. Reuses the BBDuk phiX side-channel engine (ops/microalign)."""
    a = tokenize(args)
    refpath = a.get("ref", default="phix")
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: microalign in=<reads> [in2=] ref=<small fasta>"
              " out=<sam> [minid=0.66] [k=17] [k2=13]", file=sys.stderr)
        return 1
    from ..io.fastq import FastqReader, FastqWriter
    from .sidechannel import SideChannel

    sc = SideChannel(
        refpath,
        a.get("out", "outm"),
        k1=int(a.get("k", "k1", default="17")),
        k2=int(a.get("k2", default="13")),
        minid1=float(a.get("minid", "minid1", default="0.66")),
        minid2=float(a.get("minid2", default="0.56")),
        device=a.get("device", default="cuda"),
    )
    outu = a.get("outu")
    wu = FastqWriter(outu) if outu else None
    in2 = a.get("in2")
    n_total = 0
    r2 = iter(FastqReader(in2)) if in2 else None
    for b1 in FastqReader(inpath):
        b2 = next(r2) if r2 is not None else None
        active = np.ones(b1.n, bool)
        mapped = sc.map_batch(b1, b2, active)
        n_total += b1.n
        if wu is not None:
            wu.add(b1, keep=~mapped)
    sc.close()
    if wu is not None:
        wu.close()
    pct = 100.0 * sc.reads_mapped / max(1, n_total)
    avgid = sc.identity_sum / max(1, sc.reads_mapped)  # already pct*100
    print(f"Mapped: {sc.reads_mapped}/{n_total} ({pct:.2f}%) "
          f"avgID={avgid:.2f}%", file=sys.stderr)
    return 0
