"""Research-harness launchers (cardinality/ddl/ml/bin/driver long tail).

The PyTorch port of bbtools_tpu/models/research.py. Four launchers reach
the device and take `device=` (cuda by default, no fallback to the CPU):
  - the cardinality harness (fll2simulate, ttllsimulate, dlctieraccuracy,
    trainlchist, lowcomplexcalibrate, mantissacompare): every trial's keys
    go through the port's LogLog (`loglog_update`) on the device;
  - calibrate (ml.Calibrate) fits p = K*sigmoid(a*logit(x)+b)^c to
    (score, label) rows by plain gradient descent, torch autograd on the
    device (`calibrate_fit`). The JAX package runs with x64 on: its
    logits and labels are float64 and its four parameters float32, so
    the model and the loss compute in float64 while the gradients and
    the update stay float32; torch's promotion of a 0-dim float32 tensor
    against a float64 one gives the same. `calibrate_fit.device_calls`
    counts fits on CUDA;
  - postfilter (assemble.Postfilter) maps with BBMap on the device, then
    pileup and FilterByCoverage on the host;
  - reassemble (assemble.Reassemble) runs Tadpole on the device once a
    tid_-labelled input.
The rest (the ddl sketch pipeline over the exact bottom-k MinHash
engine, regressiontrainer, rankingvectorizer, covmaker,
makequickbinvector, matrixtocolumns, bloomfilterparser, processfrag) is
the JAX package's host code, copied.
"""

from __future__ import annotations

import os
import sys

import numpy as np

import torch

from ..core.parser import parse_boolean, tokenize
from ..device import resolve_device


# ----------------------------------------------------------------------
# cardinality harness
# ----------------------------------------------------------------------


def cardinality_sim_main(args, mode: str = "fll2"):
    """Accuracy-vs-cardinality sweep of the production HLL estimator,
    each trial's keys hashed on the run's device (`device=`, cuda by
    default)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    buckets = int(a.get("buckets", default="2048"))
    trials = int(a.get("trials", "samples", default="9"))
    tiers = [int(float(x)) for x in a.get(
        "tiers", "cardinalities",
        default="1000,10000,100000,1000000").split(",")]
    seed = int(a.get("seed", default="42"))
    from .loglog import LogLog

    rng = np.random.default_rng(seed)
    print(f"#{mode}: estimator accuracy, buckets={buckets},"
          f" trials={trials}", file=sys.stderr)
    print("#cardinality\tmeanEst\tmeanRelErr\tstdRelErr")
    for n in tiers:
        errs = []
        ests = []
        for _ in range(trials):
            ll = LogLog(buckets=buckets, device=device)
            keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
            ll.hash_kmers(keys)
            est = ll.cardinality()
            ests.append(est)
            errs.append(abs(est - n) / n)
        print(f"{n}\t{np.mean(ests):.0f}\t{np.mean(errs):.4f}"
              f"\t{np.std(errs):.4f}")
    return 0


# ----------------------------------------------------------------------
# ddl family over the exact sketch engine
# ----------------------------------------------------------------------


def _write_sketch_tsv(fh, name: str, hashes: np.ndarray, k: int):
    fh.write(f"#name\t{name}\tk\t{k}\tsize\t{len(hashes)}\n".encode())
    fh.write(("\t".join(str(int(h)) for h in hashes) + "\n").encode())


def _read_sketch_tsv(path):
    from ..io.readwrite import read_bytes

    out = []
    name, k = None, 31
    for ln in read_bytes(path).split(b"\n"):
        if not ln.strip():
            continue
        if ln.startswith(b"#name"):
            f = ln.split(b"\t")
            name, k = f[1].decode(), int(f[3])
        else:
            out.append((name, k, np.array(
                [int(x) for x in ln.split(b"\t")], np.int64)))
    return out


def ddlwriter_main(args):
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    out = a.get("out")
    if not ins or not out:
        print("Usage: ddlwriter in=<fa,...> out=<sketches.tsv[.gz]>"
              " [k=31] [size=2048] [mode=perfile|persequence|pertid]",
              file=sys.stderr)
        return 1
    k = int(a.get("k", default="31"))
    size = int(a.get("size", "buckets", default="2048"))
    mode = a.get("mode", default="perfile").lower()
    from ..core.dna import encode
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output
    from .sketch import sketch_file, sketch_sequences
    from .ssutools import _tid_of

    with open_output(out) as fh:
        if mode == "perfile":
            for p in ins:
                _write_sketch_tsv(fh, os.path.basename(p),
                                  sketch_file(p, k, size), k)
        elif mode in ("persequence", "perseq"):
            for p in ins:
                for rec in iter_fasta(p):
                    sk = sketch_sequences([encode(rec.seq)], k, size)
                    _write_sketch_tsv(
                        fh, rec.name.split()[0].decode(), sk, k)
        else:  # pertid: merge sequences sharing a taxID across all files
            groups: dict[int, list] = {}
            for p in ins:
                for rec in iter_fasta(p):
                    tid = _tid_of(rec.name)
                    groups.setdefault(tid, []).append(encode(rec.seq))
            for tid in sorted(groups):
                sk = sketch_sequences(groups[tid], k, size)
                _write_sketch_tsv(fh, f"tid|{tid}", sk, k)
    print(f"Wrote sketches to {out}", file=sys.stderr)
    return 0


def ddlmerger_main(args):
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    out = a.get("out")
    if not ins or not out:
        print("Usage: ddlmerger in=<a.tsv,b.tsv> out=<merged.tsv>"
              " [size=2048]", file=sys.stderr)
        return 1
    size = int(a.get("size", default="2048"))
    merged: dict[str, tuple[int, np.ndarray]] = {}
    for p in ins:
        for name, k, h in _read_sketch_tsv(p):
            if name in merged:
                _, old = merged[name]
                h = np.unique(np.concatenate([old, h]))[:size]
            merged[name] = (k, h)
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        for name in sorted(merged):
            k, h = merged[name]
            _write_sketch_tsv(fh, name, h, k)
    print(f"Merged {len(ins)} files -> {len(merged)} sketches.",
          file=sys.stderr)
    return 0


def ddlcompare_main(args):
    a = tokenize(args)
    inpath = a.get("in", "in1")
    ref = a.get("ref")
    if not inpath:
        print("Usage: ddlcompare in=<sketches.tsv> [ref=<sketches.tsv>]"
              " [out=] (all-to-all if no ref)", file=sys.stderr)
        return 1
    from .sketch import compare_sketches

    qs = _read_sketch_tsv(inpath)
    rs = _read_sketch_tsv(ref) if ref else qs
    lines = ["#query\tref\twkid\tani"]
    for qi, (qn, qk, qh) in enumerate(qs):
        for ri, (rn, rk, rh) in enumerate(rs):
            if ref is None and ri <= qi:
                continue
            wkid, ani, _, _ = compare_sketches(qh, rh, k=qk)
            lines.append(f"{qn}\t{rn}\t{wkid:.6f}\t{ani:.6f}")
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    return 0


def ddlblacklist_main(args):
    """Hashes appearing in >= minfraction of sketches -> blacklist."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out")
    if not inpath or not out:
        print("Usage: ddlblacklist in=<sketches.tsv> out=<list>"
              " [minfraction=0.3]", file=sys.stderr)
        return 1
    frac = float(a.get("minfraction", "fraction", default="0.3"))
    sketches = _read_sketch_tsv(inpath)
    counts: dict[int, int] = {}
    for _, _, h in sketches:
        for v in h.tolist():
            counts[v] = counts.get(v, 0) + 1
    cut = max(2, int(frac * len(sketches)))
    bad = sorted(v for v, c in counts.items() if c >= cut)
    with open(out, "w") as fh:
        fh.write("\n".join(str(v) for v in bad) + ("\n" if bad else ""))
    print(f"{len(bad)} blacklisted hashes (in >= {cut} of"
          f" {len(sketches)} sketches).", file=sys.stderr)
    return 0


def ddlcalibrate_main(args):
    """Fit measured-ANI vs true-ANI curve on synthetic mutated pairs."""
    a = tokenize(args)
    k = int(a.get("k", default="31"))
    size = int(a.get("size", default="2048"))
    length = int(a.get("length", "len", default="100000"))
    rng = np.random.default_rng(int(a.get("seed", default="5")))
    from .sketch import compare_sketches, sketch_sequences

    print("#trueANI\tmeasuredANI\twkid")
    for ani_pct in (100, 99.5, 99, 98, 96, 92, 88, 84, 80):
        base = rng.integers(0, 4, length).astype(np.uint8)
        mut = base.copy()
        nmut = int(length * (1 - ani_pct / 100))
        pos = rng.choice(length, nmut, replace=False) if nmut else []
        for p in pos:
            mut[p] = (mut[p] + 1 + rng.integers(3)) % 4
        s1 = sketch_sequences([base], k, size)
        s2 = sketch_sequences([mut], k, size)
        wkid, ani, _, _ = compare_sketches(s1, s2, k=k)
        print(f"{ani_pct / 100:.4f}\t{ani:.4f}\t{wkid:.6f}")
    return 0


# ----------------------------------------------------------------------
# ml calibrate / regression trainer / ranking vectorizer
# ----------------------------------------------------------------------


def calibrate_fit(x: np.ndarray, y: np.ndarray, epochs: int, lr: float, device):
    """`epochs` gradient steps on mean((K*sigmoid(a*logit(x)+b)^exp(logc)
    - y)^2) from a=1, b=0, K=1, logc=0; returns ({name: float32
    parameter}, the float64 loss after the last step)."""
    dev = resolve_device(str(device))
    if dev.type == "cuda":
        calibrate_fit.device_calls += 1
    xl = torch.log(torch.as_tensor(x / (1 - x), dtype=torch.float64, device=dev))
    yt = torch.as_tensor(y, dtype=torch.float64, device=dev)

    def loss(p):
        s = torch.sigmoid(p["a"] * xl + p["b"])
        return torch.mean((p["K"] * s ** torch.exp(p["logc"]) - yt) ** 2)

    p = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in (("a", 1.0), ("b", 0.0), ("K", 1.0), ("logc", 0.0))}
    for _ in range(epochs):
        for v in p.values():
            v.requires_grad_(True)
        grads = torch.autograd.grad(loss(p), list(p.values()))
        with torch.no_grad():
            p = {k_: v - lr * g for (k_, v), g in zip(p.items(), grads)}
    with torch.no_grad():
        mse = float(loss(p))
    return {k_: v.cpu().numpy() for k_, v in p.items()}, mse


#: fits on CUDA since the count was last set to 0
calibrate_fit.device_calls = 0


def calibrate_main(args):
    """ml.Calibrate: fit p = K*sigmoid(a*logit(x)+b)^c on (score,label)
    rows by gradient descent (torch, on the device)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: calibrate in=<tsv: score label> [out=constants]"
              " [epochs=2000]", file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    xs, ys = [], []
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(b"\t")
        xs.append(float(f[0]))
        ys.append(float(f[1]))
    x = np.clip(np.array(xs), 1e-6, 1 - 1e-6)
    y = np.array(ys)
    lr = float(a.get("lr", default="0.05"))
    epochs = int(a.get("epochs", default="2000"))
    p, mse = calibrate_fit(x, y, epochs, lr, device)
    c = float(np.exp(float(p["logc"])))
    line = (f"a={float(p['a']):.5f}\tb={float(p['b']):.5f}"
            f"\tK={float(p['K']):.5f}\tc={c:.5f}\tmse={mse:.6f}")
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


def regressiontrainer_main(args):
    """ml.RegressionTrainer: continuous-output net, MSE+Adam (the
    shared jax trainer already is Adam; linear output head)."""
    from .mltools import train_main

    return train_main(args)


def rankingvectorizer_main(args):
    """clade.RankingVectorizer: QuickClade hit TSV -> #dims training
    vectors; label = 1 for the true-taxon hit, else scaled rank score."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out")
    if not inpath or not out:
        print("Usage: rankingvectorizer in=<quickclade hits tsv>"
              " out=<vectors.tsv>", file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    rows = []
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(b"\t")
        feats = []
        for tok in f:
            tok = tok.split(b"=")[-1]
            try:
                feats.append(float(tok))
            except ValueError:
                continue
        if feats:
            rows.append(feats)
    if not rows:
        print("No numeric hit rows found.", file=sys.stderr)
        return 1
    width = max(len(r) for r in rows)
    lines = [f"#dims\t{width - 1}\t1"]
    for r in rows:
        r = r + [0.0] * (width - len(r))
        lines.append("\t".join(f"{v:.6g}" for v in r))
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"{len(rows)} vectors of {width - 1} dims.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# bin/ coverage utilities
# ----------------------------------------------------------------------


def covmaker_main(args):
    """bin.CovMaker: condense a contig x sample coverage matrix — merge
    sample columns with correlation >= mergethresh, sort rows by
    coverage-vector entropy."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out")
    if not inpath or not out:
        print("Usage: covmaker in=<cov.tsv> out=<cov.tsv>"
              " [mergethresh=0.98]", file=sys.stderr)
        return 1
    thresh = float(a.get("mergethresh", "thresh", default="0.98"))
    from ..io.readwrite import read_bytes

    names = []
    rows = []
    header = None
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip():
            continue
        if ln.startswith(b"#"):
            header = ln[1:].split(b"\t")
            continue
        f = ln.split(b"\t")
        names.append(f[0])
        rows.append([float(x) for x in f[1:]])
    mat = np.array(rows)
    ns = mat.shape[1]
    # merge near-duplicate sample columns
    keep = []
    merged_into: list[list[int]] = []
    for c in range(ns):
        placed = False
        for gi, g in enumerate(merged_into):
            ref = mat[:, keep[gi]]
            x = mat[:, c]
            denom = np.linalg.norm(ref) * np.linalg.norm(x)
            corr = float(ref @ x / denom) if denom > 0 else 0.0
            if corr >= thresh:
                g.append(c)
                placed = True
                break
        if not placed:
            keep.append(c)
            merged_into.append([c])
    cond = np.stack([mat[:, g].mean(axis=1) for g in merged_into], axis=1)
    # entropy sort rows (high-information first)
    p = cond / np.maximum(cond.sum(axis=1, keepdims=True), 1e-12)
    ent = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
    order = np.argsort(-ent)
    with open(out, "w") as fh:
        cols = [f"s{i}" for i in range(cond.shape[1])]
        fh.write("#contig\t" + "\t".join(cols) + "\n")
        for i in order:
            fh.write(names[i].decode() + "\t" + "\t".join(
                f"{v:.4f}" for v in cond[i]) + "\n")
    print(f"{ns} samples -> {cond.shape[1]} merged columns;"
          f" {len(names)} contigs.", file=sys.stderr)
    return 0


def makequickbinvector_main(args):
    """bin.AllToAllVectorMaker: contig-pair training vectors."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out")
    if not inpath or not out:
        print("Usage: makequickbinvector in=<contigs.fa (tid_ headers)>"
              " out=<vectors.tsv> [cov=<cov.tsv>] [pairs=10000]",
              file=sys.stderr)
        return 1
    from ..core.dna import encode
    from ..io.fasta import iter_fasta
    from .quickbin import tetramer_profile
    from .ssutools import _tid_of

    depths = {}
    if a.get("cov"):
        from .quickbin import load_depths

        depths = load_depths(a.get("cov"))
    recs = []
    for rec in iter_fasta(inpath):
        codes = encode(rec.seq)
        gc = float(((codes == 1) | (codes == 2)).mean())
        name = rec.name.split()[0]
        tid = _tid_of(rec.name)
        if tid <= 0 and b"tid_" in rec.name:
            tid = int(rec.name.split(b"tid_")[1].split(b"_")[0].split()[0])
        recs.append((name, tid, tetramer_profile(codes), gc,
                     float(depths.get(name, 1.0))))
    rng = np.random.default_rng(int(a.get("seed", default="3")))
    npairs = int(a.get("pairs", default="10000"))
    lines = ["#dims\t4\t1"]
    n = len(recs)
    made = 0
    while made < npairs and n >= 2:
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        a_, b_ = recs[i], recs[j]
        tet = float(np.abs(a_[2] - b_[2]).sum())
        gcd = abs(a_[3] - b_[3])
        dr = min(a_[4], b_[4]) / max(a_[4], b_[4], 1e-9)
        covd = abs(a_[4] - b_[4]) / max(a_[4] + b_[4], 1e-9)
        label = 1 if (a_[1] > 0 and a_[1] == b_[1]) else 0
        lines.append(f"{tet:.5f}\t{gcd:.5f}\t{dr:.5f}\t{covd:.5f}\t{label}")
        made += 1
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"{made} pair vectors from {n} contigs.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# small drivers
# ----------------------------------------------------------------------


def matrixtocolumns_main(args):
    """driver.CorrelateIdentity: two matrices -> paired columns."""
    pos = [t for t in args if "=" not in t]
    a = tokenize(args)
    in1 = a.get("in1", "in") or (pos[0] if pos else None)
    in2 = a.get("in2") or (pos[1] if len(pos) > 1 else None)
    out = a.get("out") or (pos[2] if len(pos) > 2 else None)
    if not in1 or not in2:
        print("Usage: matrixtocolumns <m1.tsv> <m2.tsv> [out]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    def load(p):
        rows = []
        for ln in read_bytes(p).split(b"\n"):
            if not ln.strip() or ln.startswith(b"#"):
                continue
            vals = []
            for x in ln.split(b"\t"):
                try:
                    vals.append(float(x))
                except ValueError:
                    continue
            if vals:
                rows.append(vals)
        return rows

    m1, m2 = load(in1), load(in2)
    lines = ["#v1\tv2"]
    for r1, r2 in zip(m1, m2):
        for v1, v2 in zip(r1, r2):
            lines.append(f"{v1:.6g}\t{v2:.6g}")
    text = "\n".join(lines) + "\n"
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


def bloomfilterparser_main(args):
    """bloom.ParseBloomFilter: split a bloomfilter run log into valid
    metric lines (key=value stats rows) and rejects."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out")
    outb = a.get("outb", "outbad", "outinvalid")
    if not inpath:
        print("Usage: bloomfilterparser in=<log> out=<valid> [outb=<bad>]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    keys = (b"threads", b"keys", b"increments", b"creation", b"bits",
            b"hashes", b"cells", b"used", b"Time", b"reads/s")
    good, bad = [], []
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip():
            continue
        (good if any(k in ln for k in keys) else bad).append(ln)
    if out:
        with open(out, "wb") as fh:
            fh.write(b"\n".join(good) + (b"\n" if good else b""))
    if outb:
        with open(outb, "wb") as fh:
            fh.write(b"\n".join(bad) + (b"\n" if bad else b""))
    print(f"{len(good)} valid, {len(bad)} invalid lines.", file=sys.stderr)
    return 0


def processfrag_main(args):
    """driver.ProcessFragMerging: collate BBMerge stderr logs -> TSV."""
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    if not ins:
        print("Usage: processfrag in=<bbmerge logs,comma> [out=]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    lines = ["#file\tpairs\tjoined\tjoinedPct\tambiguous\tnoSolution"]
    for p in ins:
        stats = {"Pairs:": "0", "Joined:": "0", "Ambiguous:": "0",
                 "No Solution:": "0"}
        pct = "0"
        for ln in read_bytes(p).decode(errors="replace").split("\n"):
            for key in stats:
                if ln.strip().startswith(key):
                    toks = ln.split()
                    stats[key] = toks[1] if len(toks) > 1 else "0"
                    if key == "Joined:" and "%" in ln:
                        pct = ln.split()[-1].rstrip("%")
        lines.append(f"{os.path.basename(p)}\t{stats['Pairs:']}"
                     f"\t{stats['Joined:']}\t{pct}\t{stats['Ambiguous:']}"
                     f"\t{stats['No Solution:']}")
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


# ----------------------------------------------------------------------
# pipelines: postfilter / reassemble
# ----------------------------------------------------------------------


def postfilter_main(args):
    """assemble.Postfilter: map reads to the assembly, then filter
    contigs by coverage (two-phase; Postfilter.java:1-12). BBMap maps
    on the run's device (`device=`, cuda by default)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    reads, asm, out = a.get("in", "in1"), a.get("ref", "contigs"), a.get(
        "out", "outfiltered")
    if not reads or not asm or not out:
        print("Usage: postfilter in=<reads> ref=<assembly.fa>"
              " out=<filtered.fa> [mincov=2] [minlen=200] [minreads=6]",
              file=sys.stderr)
        return 1
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        sam = os.path.join(td, "mapped.sam")
        cov = os.path.join(td, "covstats.txt")
        from .bbmap import main as bbmap_main

        bbmap_main([f"in={reads}", f"ref={asm}", f"out={sam}",
                    "maxindel=0", "minid=0.9", f"device={device}"])
        from .pileup import main as pileup_main

        pileup_main([f"in={sam}", f"out={cov}", f"ref={asm}"])
        from .seqtools import filterbycoverage

        return filterbycoverage([
            f"in={asm}", f"cov={cov}", f"out={out}",
            f"mincov={a.get('mincov', default='2')}",
            f"minlen={a.get('minlen', default='200')}",
            f"minreads={a.get('minreads', default='6')}",
        ])


def reassemble_main(args):
    """assemble.Reassemble: run Tadpole per tid_-labeled input file and
    concatenate, preserving labels (Reassemble.java:1-10). Tadpole counts
    on the run's device (`device=`, cuda by default)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    out = a.get("out")
    if not ins or not out:
        print("Usage: reassemble in=<tid_1_x.fq,tid_2_y.fq,...>"
              " out=<contigs.fa> [k=31]", file=sys.stderr)
        return 1
    import re
    import tempfile

    from ..io.readwrite import open_output, read_bytes

    k = a.get("k", default="31")
    with open_output(out) as fh, tempfile.TemporaryDirectory() as td:
        for p in ins:
            m = re.search(r"tid_(\d+)", os.path.basename(p))
            tid = m.group(1) if m else "0"
            sub = os.path.join(td, f"asm_{tid}.fa")
            from .tadpole import main as tadpole_main

            tadpole_main([f"in={p}", f"out={sub}", f"k={k}", f"device={device}"])
            if not os.path.exists(sub):
                continue
            for ln in read_bytes(sub).split(b"\n"):
                if ln.startswith(b">"):
                    ln = b">tid_" + tid.encode() + b"_" + ln[1:]
                if ln:
                    fh.write(ln + b"\n")
    print(f"Reassembled {len(ins)} inputs.", file=sys.stderr)
    return 0
