"""File/stream utility launchers (the jgi/fun/driver/stream long tail).

Reference mains:
  - unzip.sh -> jgi.Unzip: transparent-decompress a file (in=, out=;
    any compression the ReadWrite layer understands).
  - filescan.sh -> stream.FileScanMT: scan a file, report lines/bytes
    and throughput.
  - printtime.sh -> align2.PrintTime: positional timestamp file; prints
    elapsed seconds since the stamp it last wrote, then rewrites it
    (PrintTime.java:27-56).
  - stream.sh -> stream.StreamerWrapper / samstreamer.sh ->
    stream.SamStreamerWrapper: drive the read-streaming layer over an
    input and report reads/bases/sec (I/O benchmark surface).
  - diskbench.sh -> fun.DiskBench: sequential write+read disk bench.
  - testfilesystem.sh -> jgi.TestFilesystem: latency/ops probe of a
    directory (create/stat/delete round-trips).
  - a_sample_mt.sh -> template.A_SampleMT: the documented tool template
    (copies reads in->out; the canonical skeleton every tool follows).
  - copyfile.sh: byte copy. cat.sh: concatenate files to stdout/out.
  - textfile.sh -> fileIO.TextFile: print a (compressed) text file,
    optionally a line range.

javasetup reports torch and its CUDA devices where the JAX package
reports JAX's; every other function is the JAX package's.
"""

from __future__ import annotations

import os
import sys
import time

from ..core.parser import tokenize


def unzip_main(args):
    a = tokenize(args)
    pos = [t for t in args if "=" not in t]
    inp = a.get("in", "in1") or (pos[0] if pos else None)
    out = a.get("out", "out1") or (pos[1] if len(pos) > 1 else None)
    if not inp:
        print("Usage: unzip <in> [out]  (out default: strip .gz/.bz2)",
              file=sys.stderr)
        return 1
    if not out:
        out = inp
        for ext in (".gz", ".bz2", ".zst", ".xz"):
            if out.endswith(ext):
                out = out[: -len(ext)]
                break
        if out == inp:
            out = inp + ".raw"
    from ..io.readwrite import open_input

    n = 0
    with open_input(inp) as src, open(out, "wb") as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)
            n += len(chunk)
    print(f"Wrote {n} bytes to {out}", file=sys.stderr)
    return 0


def cat_main(args):
    a = tokenize(args)
    pos = [t for t in args if "=" not in t]
    ins = (a.get("in", "in1") or ",".join(pos)).split(",")
    out = a.get("out", "out1")
    from ..io.readwrite import open_input, open_output

    dst = open_output(out) if out else sys.stdout.buffer
    n = 0
    for p in ins:
        if not p:
            continue
        with open_input(p) as src:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)
                n += len(chunk)
    if out:
        dst.close()
    print(f"Concatenated {n} bytes from {len(ins)} files.", file=sys.stderr)
    return 0


def copyfile_main(args):
    pos = [t for t in args if "=" not in t]
    a = tokenize(args)
    src = a.get("in") or (pos[0] if pos else None)
    dst = a.get("out") or (pos[1] if len(pos) > 1 else None)
    if not src or not dst:
        print("Usage: copyfile <src> <dst>", file=sys.stderr)
        return 1
    import shutil

    shutil.copyfile(src, dst)
    print(f"Copied {os.path.getsize(dst)} bytes.", file=sys.stderr)
    return 0


def textfile_main(args):
    """textfile.sh <file> [firstLine] [lastLine] (0-based, inclusive)."""
    pos = [t for t in args if "=" not in t]
    if not pos:
        print("Usage: textfile <file> [first] [last]", file=sys.stderr)
        return 1
    first = int(pos[1]) if len(pos) > 1 else 0
    last = int(pos[2]) if len(pos) > 2 else (1 << 62)
    from ..io.readwrite import read_bytes

    for i, line in enumerate(read_bytes(pos[0]).split(b"\n")):
        if i > last:
            break
        if i >= first:
            sys.stdout.buffer.write(line + b"\n")
    return 0


def filescan_main(args):
    a = tokenize(args)
    pos = [t for t in args if "=" not in t]
    inp = a.get("in", "in1") or (pos[0] if pos else None)
    if not inp:
        print("Usage: filescan in=<file>", file=sys.stderr)
        return 1
    from ..io.readwrite import open_input

    t0 = time.time()
    lines = bytes_ = 0
    with open_input(inp) as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            bytes_ += len(chunk)
            lines += chunk.count(b"\n")
    dt = max(time.time() - t0, 1e-9)
    print(f"Lines: {lines}\tBytes: {bytes_}\t"
          f"{bytes_ / dt / 1e6:.1f} MB/s", file=sys.stderr)
    return 0


def printtime_main(args):
    """printtime.sh <stampfile> [print=t] (PrintTime.java:27-56)."""
    pos = [t for t in args if "=" not in t]
    millis = int(time.time() * 1000)
    if not pos:
        print(f"Time:\t{millis}", file=sys.stderr)
        return 0
    path = pos[0]
    if os.path.exists(path):
        old = int(open(path).read().strip())
        elapsed = (millis - old) / 1000.0
        show = len(pos) < 2 or pos[1].lower() in ("t", "true", "1")
        if show:
            print(f"Elapsed:\t{elapsed:.2f}")
            print(f"Elapsed:\t{elapsed:.2f}", file=sys.stderr)
    with open(path, "w") as fh:
        fh.write(str(millis))
    return 0


def streamer_main(args, sam: bool = False):
    """stream.sh / samstreamer.sh: benchmark the streaming layer."""
    a = tokenize(args)
    inp = a.get("in", "in1")
    if not inp:
        print("Usage: stream in=<reads file>", file=sys.stderr)
        return 1
    t0 = time.time()
    reads = bases = 0
    if sam or inp.endswith((".sam", ".bam", ".sam.gz")):
        from ..io.sam_read import iter_sam

        for rec in iter_sam(inp):
            reads += 1
            bases += len(rec.seq) if rec.seq != b"*" else 0
    else:
        from ..io.fastq import FastqReader

        for batch in FastqReader(inp):
            reads += batch.n
            bases += int(batch.lengths.sum())
    dt = max(time.time() - t0, 1e-9)
    print(f"Reads: {reads}\tBases: {bases}\t"
          f"{reads / dt:.0f} reads/s\t{bases / dt / 1e6:.1f} Mbases/s",
          file=sys.stderr)
    return 0


def samstreamer_main(args):
    return streamer_main(args, sam=True)


def diskbench_main(args):
    """diskbench.sh -> fun.DiskBench: sequential write + read timing."""
    a = tokenize(args)
    path = a.get("path", default=".")
    size = int(float(a.get("data", "size", default="64000000")))
    block = 1 << 20
    buf = os.urandom(block)
    tmp = os.path.join(path, f".diskbench_{os.getpid()}.tmp")
    t0 = time.time()
    with open(tmp, "wb") as fh:
        n = 0
        while n < size:
            fh.write(buf)
            n += block
        fh.flush()
        os.fsync(fh.fileno())
    wt = time.time() - t0
    t0 = time.time()
    with open(tmp, "rb") as fh:
        while fh.read(block):
            pass
    rt = time.time() - t0
    os.unlink(tmp)
    print(f"Write: {n / wt / 1e6:.1f} MB/s\tRead: {n / rt / 1e6:.1f} MB/s",
          file=sys.stderr)
    return 0


def testfilesystem_main(args):
    """testfilesystem.sh: create/stat/delete latency probe."""
    a = tokenize(args)
    path = a.get("path", default=".")
    rounds = int(a.get("rounds", "iters", default="100"))
    t_create = t_stat = t_delete = 0.0
    for i in range(rounds):
        p = os.path.join(path, f".fstest_{os.getpid()}_{i}")
        t0 = time.time()
        with open(p, "w") as fh:
            fh.write("x")
        t_create += time.time() - t0
        t0 = time.time()
        os.stat(p)
        t_stat += time.time() - t0
        t0 = time.time()
        os.unlink(p)
        t_delete += time.time() - t0
    print(f"create: {t_create / rounds * 1e6:.1f}us\t"
          f"stat: {t_stat / rounds * 1e6:.1f}us\t"
          f"delete: {t_delete / rounds * 1e6:.1f}us", file=sys.stderr)
    return 0


def sample_mt_main(args):
    """a_sample_mt.sh -> template.A_SampleMT: the documented tool
    skeleton — stream reads in, apply a (no-op) per-read function,
    write them out in order. Kept runnable as the template reference
    (template/A_SampleMT.java:31)."""
    a = tokenize(args)
    inp, out = a.get("in", "in1"), a.get("out", "out1")
    if not inp or not out:
        print("Usage: a_sample_mt in=<reads> out=<reads>", file=sys.stderr)
        return 1
    from ..io.fastq import FastqReader, FastqWriter

    w = FastqWriter(out)
    reads = 0
    for batch in FastqReader(inp):
        # per-read processing hook goes here (template processReadPair)
        w.add(batch)
        reads += batch.n
    w.close()
    print(f"Processed {reads} reads.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# launcher-infra + log-processing rows
# ----------------------------------------------------------------------


def calcmem_main(args):
    """calcmem.sh/memdetect.sh: detect available RAM and print the
    suggested heap budget (the shell launchers' RAM autodetection,
    calcmem.sh:68-150; here: /proc/meminfo + 85% guidance)."""
    a = tokenize(args)
    frac = float(a.get("fraction", default="0.85"))
    info = {}
    try:
        for ln in open("/proc/meminfo"):
            k, v = ln.split(":", 1)
            info[k.strip()] = int(v.strip().split()[0])  # kB
    except OSError:
        print("No /proc/meminfo on this platform.", file=sys.stderr)
        return 1
    total = info.get("MemTotal", 0) * 1024
    avail = info.get("MemAvailable", info.get("MemFree", 0)) * 1024
    budget = int(avail * frac)
    print(f"Total: {total // (1 << 20)} MB\tAvailable:"
          f" {avail // (1 << 20)} MB\tSuggested budget ({frac:.0%}):"
          f" {budget // (1 << 20)} MB")
    return 0


def javasetup_main(args):
    """javasetup.sh analog: print the resolved runtime environment
    (python/numpy/torch versions and the CUDA devices torch sees)."""
    import platform

    import numpy as _np
    import torch

    print(f"python\t{platform.python_version()}")
    print(f"numpy\t{_np.__version__}")
    print(f"torch\t{torch.__version__}")
    n = torch.cuda.device_count()
    print(f"devices\t{n}" if n else "devices\tnone (no CUDA device)")
    for i in range(n):
        print(f"cuda:{i}\t{torch.cuda.get_device_name(i)}")
    return 0


def profile_main(args):
    """profile.sh: run any tool under a profiler and write the report
    (the reference wraps Java Flight Recorder; here cProfile).
    Usage: profile <tool> [tool args...] profile=<out.prof>"""
    prof_out = "profile.prof"
    inner = []
    for t in args:
        if t.lower().startswith("profile="):
            prof_out = t.split("=", 1)[1]
        else:
            inner.append(t)
    if not inner:
        print("Usage: profile <tool> <tool args...> profile=<out.prof>",
              file=sys.stderr)
        return 1
    import cProfile
    import pstats

    from ..cli import main as cli_main

    pr = cProfile.Profile()
    pr.enable()
    try:
        cli_main(inner)
    finally:
        pr.disable()
        pr.dump_stats(prof_out)
        stats = pstats.Stats(pr, stream=sys.stderr)
        stats.sort_stats("cumulative").print_stats(15)
        print(f"Profile written to {prof_out}", file=sys.stderr)
    return 0


def fix_script_paths_main(args):
    """fix_script_paths.sh: rewrite SCRIPT="$0" to an absolute-path
    resolution in launcher scripts under path= (default .)."""
    a = tokenize(args)
    root = a.get("path", "dir", default=".")
    import glob as _glob

    fixed = 0
    old = 'SCRIPT="$0"'
    new = ('SCRIPT="$(cd "$(dirname "$0")" && pwd)/$(basename "$0")"')
    for p in _glob.glob(os.path.join(root, "*.sh")):
        text = open(p).read()
        if old in text:
            open(p, "w").write(text.replace(old, new))
            print(f"Fixed: {os.path.basename(p)}", file=sys.stderr)
            fixed += 1
    print(f"Fixed {fixed} shell scripts", file=sys.stderr)
    return 0


def addx_main(args):
    """addx.sh: mark launcher scripts executable (git update-index
    --chmod=+x analog: chmod +x on *.sh under path=)."""
    a = tokenize(args)
    root = a.get("path", "dir", default=".")
    import glob as _glob
    import stat

    n = 0
    for p in _glob.glob(os.path.join(root, "*.sh")):
        st = os.stat(p)
        os.chmod(p, st.st_mode | stat.S_IXUSR | stat.S_IXGRP
                 | stat.S_IXOTH)
        n += 1
    print(f"Marked {n} scripts executable.", file=sys.stderr)
    return 0


def zz_rename_package_main(args):
    print("zz_rename_package.sh is an internal repo-maintenance script"
          " (bulk-renames *aligner*.sh launchers in the reference's"
          " release tree); nothing to do here.", file=sys.stderr)
    return 0


def processspeed_main(args):
    """processspeed.sh -> driver.ProcessSpeed2: convert `time` output
    (real/user/sys lines like 1m23.456s) into decimal seconds TSV."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: processspeed in=<timing log> [out=]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    def to_seconds(tok: str) -> float:
        tok = tok.strip()
        secs = 0.0
        if "h" in tok:
            h, tok = tok.split("h", 1)
            secs += 3600 * float(h)
        if "m" in tok:
            m, tok = tok.split("m", 1)
            secs += 60 * float(m)
        if tok.endswith("s"):
            tok = tok[:-1]
        if tok:
            secs += float(tok)
        return secs

    rows = ["#label\tseconds"]
    for ln in read_bytes(inpath).decode(errors="replace").split("\n"):
        toks = ln.split()
        if len(toks) == 2 and toks[0] in ("real", "user", "sys"):
            try:
                rows.append(f"{toks[0]}\t{to_seconds(toks[1]):.3f}")
            except ValueError:
                continue
    text = "\n".join(rows) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


def webcheck_main(args):
    """webcheck.sh -> driver.ProcessWebcheck: aggregate a webcheck log
    (rows with URL, response code, latency-ms) into per-URL stats;
    failures split to outbad=."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: webcheck in=<log> [out=] [outbad=]", file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    stats: dict[str, list] = {}
    bad = []
    for ln in read_bytes(inpath).decode(errors="replace").split("\n"):
        toks = ln.replace("\t", " ").split()
        url = next((t for t in toks if t.startswith("http")), None)
        code = next((int(t) for t in toks if t.isdigit()
                     and 100 <= int(t) <= 599), None)
        lat = None
        for t in toks:
            try:
                v = float(t)
                if v > 599 or "." in t:
                    lat = v
                    break
            except ValueError:
                continue
        if url is None or code is None:
            if ln.strip():
                bad.append(ln)
            continue
        row = stats.setdefault(url, [0, 0, 0.0])
        row[0] += 1
        row[1] += (200 <= code < 400)
        if lat is not None:
            row[2] += lat
    lines = ["#url\trequests\tok\tokPct\tmeanLatency"]
    for url in sorted(stats):
        n, ok, lat = stats[url]
        lines.append(f"{url}\t{n}\t{ok}\t{100.0 * ok / n:.1f}"
                     f"\t{lat / max(n, 1):.1f}")
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    if a.get("outbad") and bad:
        with open(a.get("outbad"), "w") as fh:
            fh.write("\n".join(bad) + "\n")
    return 0


def summarizecontam_main(args):
    """summarizecontam.sh -> driver.SummarizeContamReport: aggregate
    CONTAM SUMMARY report tables (`|Taxonomy|SeqUnits|Reads` rows up to
    |TOTAL) across files; filter by minreads=/minunits=
    (SummarizeContamReport.java:71-191)."""
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    ins += [t for t in args if "=" not in t]
    if not ins:
        print("Usage: summarizecontam <reports...> [out=] [minreads=0]"
              " [minunits=0]", file=sys.stderr)
        return 1
    min_reads = int(a.get("minreads", default="0"))
    min_units = int(a.get("minsequnits", "minunits", "minseqs",
                          default="0"))
    from ..io.readwrite import read_bytes

    agg: dict[bytes, list] = {}
    for p in ins:
        in_table = False
        for ln in read_bytes(p).split(b"\n"):
            if ln.startswith(b"|Taxonomy"):
                in_table = True
                continue
            if not in_table or not ln.startswith(b"|"):
                in_table = in_table and ln.startswith(b"|")
                continue
            if ln.startswith(b"|TOTAL"):
                in_table = False
                continue
            f = [x.strip() for x in ln.split(b"|") if x.strip()]
            if len(f) < 3:
                continue
            try:
                units, reads = int(f[1]), int(f[2])
            except ValueError:
                continue
            row = agg.setdefault(f[0], [0, 0])
            row[0] += units
            row[1] += reads
    lines = ["#Name\tSeqUnits\tReads"]
    for name, (units, reads) in sorted(
            agg.items(), key=lambda t: -t[1][1]):
        if units >= min_units and reads >= min_reads:
            lines.append(f"{name.decode()}\t{units}\t{reads}")
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


def analyzesketchresults_main(args):
    """analyzesketchresults.sh -> sketch.AnalyzeSketchResults: per-query
    summary of comparesketch/sendsketch result tables (best hit, margin
    to second, hit counts)."""
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    ins += [t for t in args if "=" not in t]
    if not ins:
        print("Usage: analyzesketchresults <results...> [out=]",
              file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    per_query: dict[str, list] = {}
    for p in ins:
        for ln in read_bytes(p).decode(errors="replace").split("\n"):
            f = ln.split("\t")
            if len(f) < 4 or f[0].startswith(("#", "Query", "A")):
                continue
            try:
                wkid = float(f[2].rstrip("%"))
                ani = float(f[3].rstrip("%"))
            except ValueError:
                continue
            per_query.setdefault(f[0], []).append((wkid, ani, f[1]))
    lines = ["#query\thits\tbestRef\tbestANI\tsecondANI\tmargin"]
    for q in sorted(per_query):
        hits = sorted(per_query[q], reverse=True)
        best = hits[0]
        second = hits[1][1] if len(hits) > 1 else 0.0
        lines.append(f"{q}\t{len(hits)}\t{best[2]}\t{best[1]:.3f}"
                     f"\t{second:.3f}\t{best[1] - second:.3f}")
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0
