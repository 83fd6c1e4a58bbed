"""ML tool family over the CellNet runtime (ml/ package launchers).

The PyTorch port of bbtools_tpu/models/mltools.py: train, scoresequence
and netfilter run the net on the run's device (`device=`, cuda by
default): training by `CellNet.fit` (ml/cellnet.py, Adam in optax's
order), scoring by its forward pass. The vectorizer and the vector TSV
tools are the JAX package's host code and run anywhere.

Reference mains:
  - seqtovec.sh -> ml.SequenceToVector: reads -> training vectors. Raw
    mode (k=0): 4 meta features (len/(width+5), gc, entropy,
    poly/(poly+5)) + one-hot bases up to `width` -> dims = width*4+4
    (SequenceToVector.java:197-237). Spectrum mode (k>=1): 4 meta +
    canonical k-mer frequency spectrum scaled to mean 0.25
    (fillSpectrum, :291-312). Header line `#dims <in> 1`; last column
    is the training target (result= or parsed from `result=` in the
    header when parse=t).
  - train.sh -> ml.Trainer: train a .bbnet on such vectors (here: the
    torch trainer in ml/cellnet.py — batched forward/backprop on device).
  - scoresequence.sh -> ml.ScoreSequence: score reads with a net;
    annotate/filter/histogram (ScoreSequence.java:62-160).
  - netfilter.sh -> ml.NetFilter: filter reads by net score with pair
    logic (lowpass/highpass cutoff, paired or-mode).
  - netconvert.sh -> ml.NetConvert: .bbnet format round-trip.
  - reducecolumns.sh -> ml.ReduceColumns: keep listed columns of a
    vector TSV (positional: in out cols... with N-M and N+ ranges).
  - vectorutils.sh -> ml.VectorUtils: shuffle/sample/balance/dedupe
    vector files.
  - balancevectors.sh -> var2.BalanceVectors: equalize positive and
    negative rows (last column) by subsampling the majority class.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import parse_boolean, tokenize
from ..device import resolve_device
from ..ml.cellnet import CellNet, parse_bbnet, save_bbnet
from ..ops.entropy import EntropyModel

# ---------------------------------------------------------------------
# vectorization (SequenceToVector.fillVector semantics)
# ---------------------------------------------------------------------

_entropy_model = None


def _entropy(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    global _entropy_model
    if _entropy_model is None:
        _entropy_model = EntropyModel(k=5, window=50)
    return _entropy_model.average_entropy_batch(codes, lengths)


def _longest_homopolymer(codes: np.ndarray, lengths: np.ndarray):
    """Vectorized longest same-base run per read (Read.longestHomopolymer)."""
    B, L = codes.shape
    if L == 0:
        return np.zeros(B, np.int32)
    valid = np.arange(L)[None, :] < lengths[:, None]
    same = np.zeros((B, L), bool)
    same[:, 1:] = (codes[:, 1:] == codes[:, :-1]) & valid[:, 1:]
    # run length at i = 1 + (same streak ending at i)
    best = np.zeros(B, np.int32)
    run = np.ones(B, np.int32)
    for i in range(L):
        run = np.where(same[:, i], run + 1, 1)
        alive = valid[:, i]
        best = np.where(alive & (run > best), run, best)
    return best


def _canonical_map(k: int):
    """kmer -> canonical slot index (SequenceToVector.kmapArray)."""
    space = 1 << (2 * k)
    kmers = np.arange(space, dtype=np.int64)
    # reverse complement of each kmer
    rc = np.zeros(space, np.int64)
    t = kmers.copy()
    for _ in range(k):
        rc = (rc << 2) | (3 - (t & 3))
        t >>= 2
    canon = np.minimum(kmers, rc)
    slots, inv = np.unique(canon, return_inverse=True)
    return inv.astype(np.int32), len(slots)


def vectorize_batch(codes: np.ndarray, lengths: np.ndarray, width: int = 55,
                    k: int = 0) -> np.ndarray:
    """ReadBatch codes/lengths -> [B, dims] float32 feature matrix."""
    B, L = codes.shape
    gc_mask = (codes == 1) | (codes == 2)
    valid = np.arange(L)[None, :] < lengths[:, None]
    defined = valid & (codes < 4)
    nvalid = np.maximum(defined.sum(axis=1), 1)
    gc = (gc_mask & defined).sum(axis=1) / nvalid
    ent = _entropy(codes, lengths)
    poly = _longest_homopolymer(codes, lengths).astype(np.float32)
    poly = poly / (poly + 5)
    if k < 1:
        dims = width * 4 + 4
        vec = np.zeros((B, dims), np.float32)
        vec[:, 0] = lengths / (width + 5)
        vec[:, 1] = gc
        vec[:, 2] = ent
        vec[:, 3] = poly
        w = min(width, L)
        cols = np.arange(w)
        onehot_idx = 4 + cols[None, :] * 4 + np.where(
            codes[:, :w] < 4, codes[:, :w], 0)
        mask = valid[:, :w] & (codes[:, :w] < 4)
        rows = np.repeat(np.arange(B), w)
        flat_idx = onehot_idx.ravel()
        flat_mask = mask.ravel()
        np.add.at(vec, (rows[flat_mask], flat_idx[flat_mask]), 1.0)
        return vec
    kmap, kspace = _canonical_map(k)
    from ..ops.kmers import rolling_kmers_np

    fwd, _, runlen = rolling_kmers_np(codes, k)
    ok = (runlen >= k) & valid
    vec = np.zeros((B, 4 + kspace), np.float32)
    counts = np.zeros(B, np.int64)
    for b in range(B):
        km = fwd[b][ok[b]]
        if len(km):
            np.add.at(vec[b], 4 + kmap[km], 1.0)
            counts[b] = len(km)
    mult = (kspace * 0.25) / np.maximum(counts, 1)
    vec[:, 4:] *= mult[:, None]
    vec[:, 0] = (counts * 0.25) / kspace
    vec[:, 1] = gc
    vec[:, 2] = ent
    vec[:, 3] = poly
    return vec


def _rc_batch(codes: np.ndarray, lengths: np.ndarray):
    B, L = codes.shape
    out = np.full_like(codes, 4)
    for b in range(B):
        n = int(lengths[b])
        c = codes[b, :n][::-1]
        out[b, :n] = np.where(c < 4, 3 - c, 4)
    return out


def score_batch(net: CellNet, codes, lengths, width, k, rcomp=True):
    """SequenceToVector.score: max of forward and rcomp scores."""
    v = vectorize_batch(codes, lengths, width, k)
    s = net.apply(v)[:, 0]
    if rcomp:
        v2 = vectorize_batch(_rc_batch(codes, lengths), lengths, width, k)
        s = np.maximum(s, net.apply(v2)[:, 0])
    return s


# ---------------------------------------------------------------------
# seqtovec
# ---------------------------------------------------------------------


def seqtovec_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: seqtovec in=<reads> out=<vectors.tsv> [width=55]"
              " [k=0] [result=0|parse=t] [rcomp=f]", file=sys.stderr)
        return 1
    width = int(a.get("width", default="55"))
    k = int(a.get("k", default="0"))
    rcomp = parse_boolean(a.get("rcomp", default="f"))
    parse_hdr = parse_boolean(a.get("parse", "parseheader", default="f"))
    result0 = float(a.get("result", default="0"))
    from ..io.fastq import FastqReader

    if k < 1:
        dims = width * 4 + 4
    else:
        _, kspace = _canonical_map(k)
        dims = 4 + kspace
    lines = [f"#dims\t{dims}\t1"]
    for batch in FastqReader(inpath):
        vec = vectorize_batch(batch.bases, batch.lengths, width, k)
        if rcomp:
            rc = vectorize_batch(
                _rc_batch(batch.bases, batch.lengths), batch.lengths,
                width, k)
        for i in range(batch.n):
            res = result0
            if parse_hdr:
                name = batch.ids[i]
                tag = b"result="
                p = name.find(tag)
                if p >= 0:
                    end = name.find(b"\t", p)
                    res = float(name[p + len(tag): end if end > 0 else None])
            row = "\t".join(f"{x:.4f}".rstrip("0").rstrip(".") or "0"
                            for x in vec[i])
            tgt = str(int(res)) if res == int(res) else f"{res:.4f}"
            lines.append(row + "\t" + tgt)
            if rcomp:
                row = "\t".join(f"{x:.4f}".rstrip("0").rstrip(".") or "0"
                                for x in rc[i])
                lines.append(row + "\t" + tgt)
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        fh.write(("\n".join(lines) + "\n").encode())
    print(f"Wrote {len(lines) - 1} vectors of {dims} dims.", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------
# train / netconvert
# ---------------------------------------------------------------------


def load_vectors(path: str):
    """Read a #dims vector TSV -> (x [N, in], y [N, out])."""
    from ..io.readwrite import read_bytes

    nin = nout = None
    xs, ys = [], []
    for line in read_bytes(path).split(b"\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b"#"):
            if line.startswith(b"#dims"):
                parts = line.split(b"\t")
                nin, nout = int(parts[1]), int(parts[2])
            continue
        vals = np.array([float(v) for v in line.split(b"\t")], np.float32)
        if nin is None:
            nin, nout = len(vals) - 1, 1
        xs.append(vals[:nin])
        ys.append(vals[nin: nin + nout])
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def train_main(args):
    """train.sh -> ml.Trainer (torch gradient training on the device)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    data = a.get("data", "train", "training", "in")
    out = a.get("out", "netout", "net")
    if not data or not out:
        print("Usage: train data=<vectors.tsv> out=<net.bbnet>"
              " [dims=in,h1,...,out] [epochs=2000] [lr=0.05] [seed=0]"
              " [evaluate=<test.tsv>]", file=sys.stderr)
        return 1
    x, y = load_vectors(data)
    nin, nout = x.shape[1], y.shape[1]
    if a.get("dims", "dimensions"):
        dims = [int(v) for v in a.get("dims", "dimensions").split(",")]
        assert dims[0] == nin and dims[-1] == nout, (
            f"dims {dims} vs data {nin}->{nout}")
    else:
        h = max(4, min(64, nin // 2))
        dims = [nin, h, nout]
    epochs = int(a.get("epochs", "cycles", default="2000"))
    lr = float(a.get("lr", "rate", default="0.05"))
    seed = int(a.get("seed", default="0"))
    net = CellNet.create(dims, seed=seed)
    net.device = str(device)
    net.fit(x, y, epochs=epochs, lr=lr, seed=seed)
    pred = net.apply(x)[:, 0]
    err = float(np.mean((pred - y[:, 0]) ** 2))
    cls = (pred >= 0.5) == (y[:, 0] >= 0.5)
    print(f"Trained {dims} on {len(x)} samples: mse={err:.5f} "
          f"acc={cls.mean():.4f}", file=sys.stderr)
    ev = a.get("evaluate", "test")
    if ev:
        xt, yt = load_vectors(ev)
        pt = net.apply(xt)[:, 0]
        et = float(np.mean((pt - yt[:, 0]) ** 2))
        ct = (pt >= 0.5) == (yt[:, 0] >= 0.5)
        print(f"Eval: mse={et:.5f} acc={ct.mean():.4f}", file=sys.stderr)
    save_bbnet(net, out)
    return 0


def netconvert_main(args):
    """netconvert.sh: .bbnet format round-trip (NetConvert.java:25-56)."""
    a = tokenize(args)
    inp = a.get("in", "net", "netin")
    out = a.get("out", "netout")
    if not inp or not out:
        raise ValueError("Usage: netconvert in=<old.bbnet> out=<new.bbnet>")
    net = parse_bbnet(inp)
    save_bbnet(net, out)
    print(f"Converted {inp} -> {out} "
          f"({'x'.join(str(d) for d in net.dims)})", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------
# scoresequence / netfilter
# ---------------------------------------------------------------------


def _net_width(net: CellNet, a) -> tuple[int, int]:
    k = int(a.get("k", default="0"))
    w = a.get("width")
    if w is not None:
        return int(w), k
    if k < 1:
        return (net.dims[0] - 4) // 4, k
    return 55, k


def scoresequence_main(args):
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    netpath = a.get("net", "nn")
    inpath = a.get("in", "in1")
    if not netpath or not inpath:
        print("Usage: scoresequence in=<reads> net=<net.bbnet> [out=]"
              " [hist=] [cutoff=] [highpass=t] [filter=f] [annotate=t]",
              file=sys.stderr)
        return 1
    net = parse_bbnet(netpath)
    net.device = str(device)
    width, k = _net_width(net, a)
    rcomp = parse_boolean(a.get("rcomp", default="t"))
    cutoff = float(a.get("cutoff", default="0.5"))
    highpass = parse_boolean(a.get("highpass", default="t"))
    do_filter = parse_boolean(a.get("filter", default="f"))
    annotate = parse_boolean(a.get("annotate", "rename", default="t"))
    histpath = a.get("hist")
    from ..io.fastq import FastqReader, FastqWriter

    out = a.get("out", "out1")
    w = FastqWriter(out) if out else None
    hist = np.zeros(101, np.int64)
    n_in = n_out = 0
    for batch in FastqReader(inpath):
        s = score_batch(net, batch.bases, batch.lengths, width, k, rcomp)
        hist += np.bincount(
            np.clip((s * 100).astype(int), 0, 100), minlength=101)
        n_in += batch.n
        keep = np.ones(batch.n, bool)
        if do_filter:
            keep = (s >= cutoff) if highpass else (s <= cutoff)
        if annotate:
            batch.ids = [
                batch.ids[i] + b"\tscore=" + (b"%.4f" % s[i])
                for i in range(batch.n)
            ]
        n_out += int(keep.sum())
        if w is not None:
            w.add(batch, keep=keep if do_filter else None)
    if w is not None:
        w.close()
    if histpath:
        with open(histpath, "w") as fh:
            fh.write("#score\tcount\n")
            for i, c in enumerate(hist):
                fh.write(f"{i / 100:.2f}\t{int(c)}\n")
    print(f"Scored {n_in} reads; kept {n_out if do_filter else n_in}.",
          file=sys.stderr)
    return 0


def netfilter_main(args):
    """netfilter.sh: keep reads whose net score passes the cutoff; pairs
    pass if either mate passes (or both with pairmode=and)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    netpath = a.get("net", "nn")
    inpath = a.get("in", "in1")
    if not netpath or not inpath:
        print("Usage: netfilter in=<reads> [in2=] net=<net.bbnet> out=<pass>"
              " [outu=<fail>] [cutoff=0.5] [highpass=t] [pairmode=or]",
              file=sys.stderr)
        return 1
    net = parse_bbnet(netpath)
    net.device = str(device)
    width, k = _net_width(net, a)
    rcomp = parse_boolean(a.get("rcomp", default="t"))
    cutoff = float(a.get("cutoff", default="0.5"))
    highpass = parse_boolean(a.get("highpass", default="t"))
    pairmode = a.get("pairmode", "mode", default="or").lower()
    from ..io.fastq import FastqReader, FastqWriter

    out, outu = a.get("out", "out1"), a.get("outu")
    w = FastqWriter(out) if out else None
    wu = FastqWriter(outu) if outu else None
    in2 = a.get("in2")
    r2 = iter(FastqReader(in2)) if in2 else None
    w2 = FastqWriter(a.get("out2")) if a.get("out2") else None
    n_in = n_kept = 0
    for b1 in FastqReader(inpath):
        s1 = score_batch(net, b1.bases, b1.lengths, width, k, rcomp)
        pass1 = (s1 >= cutoff) if highpass else (s1 <= cutoff)
        keep = pass1
        b2 = None
        if r2 is not None:
            b2 = next(r2)
            s2 = score_batch(net, b2.bases, b2.lengths, width, k, rcomp)
            pass2 = (s2 >= cutoff) if highpass else (s2 <= cutoff)
            keep = (pass1 & pass2) if pairmode == "and" else (pass1 | pass2)
        n_in += b1.n
        n_kept += int(keep.sum())
        if w is not None:
            w.add(b1, keep=keep)
        if w2 is not None and b2 is not None:
            w2.add(b2, keep=keep)
        elif w is not None and b2 is not None:
            w.add(b2, keep=keep)
        if wu is not None:
            wu.add(b1, keep=~keep)
            if b2 is not None:
                wu.add(b2, keep=~keep)
    for x in (w, w2, wu):
        if x is not None:
            x.close()
    print(f"Kept {n_kept}/{n_in} reads.", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------
# vector TSV utilities
# ---------------------------------------------------------------------


def _read_lines(path):
    from ..io.readwrite import read_bytes

    header, rows = [], []
    for line in read_bytes(path).split(b"\n"):
        if not line.strip():
            continue
        (header if line.startswith(b"#") else rows).append(line)
    return header, rows


def _write_lines(path, header, rows):
    from ..io.readwrite import open_output

    with open_output(path) as fh:
        for ln in header:
            fh.write(ln + b"\n")
        for ln in rows:
            fh.write(ln + b"\n")


def reducecolumns_main(args):
    """reducecolumns.sh <in> <out> cols... (N, N-M, N+ specs; 0-based).
    Output header #dims = ncols-1 inputs, 1 output."""
    pos = [t for t in args if "=" not in t]
    if len(pos) < 3:
        print("Usage: reducecolumns <in> <out> <col|a-b|a+> ...",
              file=sys.stderr)
        return 1
    inp, out, specs = pos[0], pos[1], pos[2:]
    header, rows = _read_lines(inp)
    ncols = len(rows[0].split(b"\t")) if rows else 0
    cols: list[int] = []
    for s in specs:
        if s.endswith("+"):
            cols.extend(range(int(s[:-1]), ncols))
        elif "-" in s:
            frm, to = s.split("-")
            cols.extend(range(int(frm), int(to) + 1))
        else:
            cols.append(int(s))
    out_rows = []
    for ln in rows:
        f = ln.split(b"\t")
        out_rows.append(b"\t".join(f[c] for c in cols))
    hdr = [b"#dims\t%d\t1" % (len(cols) - 1)]
    _write_lines(out, hdr, out_rows)
    print(f"Kept {len(cols)}/{ncols} columns, {len(out_rows)} rows.",
          file=sys.stderr)
    return 0


def _balance(rows, rng):
    pos = [r for r in rows if float(r.split(b"\t")[-1]) >= 0.5]
    neg = [r for r in rows if float(r.split(b"\t")[-1]) < 0.5]
    n = min(len(pos), len(neg))
    if len(pos) > n:
        pos = [pos[i] for i in rng.choice(len(pos), n, replace=False)]
    if len(neg) > n:
        neg = [neg[i] for i in rng.choice(len(neg), n, replace=False)]
    return pos + neg


def vectorutils_main(args):
    """vectorutils.sh: shuffle/sample/balance/dedupe a vector TSV."""
    a = tokenize(args)
    inp, out = a.get("in", "input"), a.get("out", "output")
    if not inp or not out:
        print("Usage: vectorutils in=<tsv> out=<tsv> [shuffle=t]"
              " [samplerate=1.0] [balance=f] [dedupe=f] [seed=7]",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(int(a.get("seed", default="7")))
    header, rows = _read_lines(inp)
    n0 = len(rows)
    if parse_boolean(a.get("deduplicate", "dedupe", default="f")):
        rows = list(dict.fromkeys(rows))
    if parse_boolean(a.get("balance", default="f")):
        rows = _balance(rows, rng)
    rate = float(a.get("samplerate", "sample", "subsample", default="1"))
    if rate < 1:
        idx = rng.random(len(rows)) < rate
        rows = [r for r, k in zip(rows, idx) if k]
    if parse_boolean(a.get("shuffle", default="t")):
        order = rng.permutation(len(rows))
        rows = [rows[i] for i in order]
    _write_lines(out, header, rows)
    print(f"{n0} -> {len(rows)} rows.", file=sys.stderr)
    return 0


def balancevectors_main(args):
    """balancevectors.sh -> var2.BalanceVectors: equalize class counts."""
    a = tokenize(args)
    inp, out = a.get("in", "input"), a.get("out", "output")
    if not inp or not out:
        print("Usage: balancevectors in=<tsv> out=<tsv> [seed=7]",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(int(a.get("seed", default="7")))
    header, rows = _read_lines(inp)
    rows = _balance(rows, rng)
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    _write_lines(out, header, rows)
    print(f"Balanced to {len(rows)} rows.", file=sys.stderr)
    return 0
