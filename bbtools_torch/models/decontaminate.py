"""DecontaminateByNormalization (decontaminate.sh / crossblock.sh) —
cross-contamination removal for multiplexed assemblies.

Reference: jgi/DecontaminateByNormalization.java. The pipeline
(process() :265-291): (0) optionally map each library's RAW reads to its
own assembly for baseline coverage, (1) rename every read to
`<libcore>_<ordinal>` and mux all libraries into one stream
(renameAndMux :328), (2) optionally Tadpole-error-correct, (3) jointly
normalize the muxed stream (KmerNormalize :534 — the cross-library
step: a contaminant's k-mers are deep in its SOURCE library, so joint
normalization discards most of the few contaminating copies in other
libraries), (4) demux back per library by name prefix (DemuxByName
:583), (5) map normalized reads per library (BBMap + covstats :637),
(6) FilterByCoverage with cov0/cov1 + minratio (:690): contigs whose
coverage collapsed under normalization are contaminants.

The port maps (BBMap, ambig=random), normalizes (bbnorm's sketch) and
corrects (Tadpole, ecct=t) on the pipeline's `device=` (cuda by default,
no CPU fallback); pileup, the rename/mux, demux and FilterByCoverage are
host code.
"""

from __future__ import annotations

import os
import sys

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output


def _core(path: str) -> str:
    """Filename minus directories and compression/format extensions
    (shared/ReadWrite.stripToCore)."""
    b = os.path.basename(path)
    for _ in range(3):
        root, ext = os.path.splitext(b)
        if ext.lower() in (
            ".gz", ".bz2", ".fq", ".fastq", ".fa", ".fasta", ".fna", ".sam",
        ):
            b = root
        else:
            break
    return b


def _parse_list(a, key, filekey):
    vals = []
    inline = a.get(key)
    if inline:
        vals += [v for v in inline.split(",") if v]
    nf = a.get(filekey)
    if nf:
        with open(nf) as fh:
            vals += [ln.strip() for ln in fh if ln.strip()]
    return vals


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    on_dev = f"device={device}"
    reads = _parse_list(a, "reads", "readnamefile")
    refs = _parse_list(a, "ref", "refnamefile")
    if len(reads) != len(refs) or not reads:
        raise ValueError(
            "decontaminate needs matching reads=/ref= lists "
            f"(got {len(reads)} read files, {len(refs)} assemblies)"
        )
    outdir = a.get("out", "outdir", default=".") or "."
    tmpdir = a.get("tmpdir", default=outdir) or outdir
    os.makedirs(outdir, exist_ok=True)
    os.makedirs(tmpdir, exist_ok=True)
    # mapping params (DecontaminateByNormalization.java :786-791)
    ambig = a.get("ambig", default="random")
    mapraw = a.get_bool("mapraw", default=True)
    # filtering params (:794-822)
    minc = a.get_float("minc", default=3.5)
    minp = a.get_float("minp", default=20.0)
    minr = a.get_int("minr", default=18)
    minl = a.get_int("minl", default=500)
    minratio = a.get_float("ratio", "minratio", default=1.2)
    basesundermin = a.get_int("basesundermin", default=-1)
    window = a.get_int("window", default=500)
    windowcov = a.get_float("windowcov", default=5.0)
    results = a.get("results", default="results.txt")
    # tadpole params (:806-816)
    ecct = a.get_bool("ecct", default=False)
    tadpole_k = a.get_int("kt", "ktadpole", default=42)
    # normalization params (:826-834)
    mindepth = a.get_int("mindepth", default=2)
    target = a.get_int("target", default=20)
    norm_k = a.get_int("k", default=31)
    norm_passes = a.get_int("passes", default=1)
    keep_temp = a.get_bool("keeptemp", default=False)

    cores = [_core(p) for p in reads]
    if len(set(cores)) != len(cores):
        raise ValueError(f"duplicate library core names: {cores}")

    def tpath(name):
        return os.path.join(tmpdir, name)

    def opath(name):
        return os.path.join(outdir, name)

    temp_files = []

    def map_and_covstats(read_path, ref_path, core, pass_no):
        """BBMap + pileup covstats for one library
        (DecontaminateByNormalization.map :637)."""
        from . import bbmap, pileup

        sam = tpath(f"{core}_pass{pass_no}.sam")
        temp_files.append(sam)
        bbmap.main([
            f"in={read_path}", f"ref={ref_path}", f"out={sam}",
            f"ambig={ambig}", "ow=t", on_dev,
        ])
        pileup_args = [
            f"in={sam}", f"ref={ref_path}",
            f"out={opath(f'{core}_covstats{pass_no}.txt')}",
        ]
        if basesundermin > 0:
            pileup_args += [f"covwindow={window}", f"covwindowavg={windowcov}"]
        pileup.main(pileup_args)

    # pass 0: raw-read coverage (needed for the ratio filter)
    if mapraw:
        print("\nMapping Phase Start (raw reads)", file=sys.stderr)
        for rp, fp, core in zip(reads, refs, cores):
            map_and_covstats(rp, fp, core, 0)

    # rename + mux (renameAndMux :328: id -> core_<ordinal>)
    print("\nRename/Merge Phase Start", file=sys.stderr)
    merged = tpath("_merged.fq")
    temp_files.append(merged)
    with open_output(merged) as out:
        for rp, core in zip(reads, cores):
            prefix = core.encode() + b"_"
            n = 0
            for batch in FastqReader(rp):
                batch.ids = [prefix + b"%d" % (n + i) for i in range(batch.n)]
                n += batch.n
                out.write(encode_fastq(batch))

    # optional tadpole error correction (eccTadpole :473)
    if ecct:
        print("\nError Correction Phase Start", file=sys.stderr)
        from . import tadpole

        corrected = tpath("_corrected.fq")
        temp_files.append(corrected)
        tadpole.main([
            "mode=correct", f"in={merged}", f"out={corrected}",
            f"k={tadpole_k}", on_dev,
        ])
        merged = corrected

    # joint normalization (normalize :534)
    print("\nNormalization Phase Start", file=sys.stderr)
    from . import bbnorm

    normalized = tpath("_normalized.fq")
    temp_files.append(normalized)
    bbnorm.main([
        f"in={merged}", f"out={normalized}", f"k={norm_k}",
        f"mindepth={mindepth}", f"target={target}", f"passes={norm_passes}",
        on_dev,
    ])

    # demux back per library (demux :583 — DemuxByName prefix match)
    print("\nDemux Phase Start", file=sys.stderr)
    from . import demux as demux_mod

    demux_mod.main([
        f"in={normalized}", f"out={tpath('%_demuxed.fq')}",
        "names=" + ",".join(cores), "prefixmode=t",
    ])
    temp_files += [tpath(f"{c}_demuxed.fq") for c in cores]

    # pass 1: normalized-read coverage
    print("\nMapping Phase Start (normalized reads)", file=sys.stderr)
    for fp, core in zip(refs, cores):
        demuxed = tpath(f"{core}_demuxed.fq")
        if not os.path.exists(demuxed):  # library fully normalized away
            open(demuxed, "wb").close()
        map_and_covstats(demuxed, fp, core, 1)

    # filter (filter :690 — FilterByCoverage per library)
    print("\nFiltering Phase Start", file=sys.stderr)
    from .seqtools import filterbycoverage

    kept = {}
    for i, (fp, core) in enumerate(zip(refs, cores)):
        args = [
            f"in={fp}", f"cov1={opath(f'{core}_covstats1.txt')}",
            f"out={opath(f'{core}_clean.fasta')}",
            f"outd={opath(f'{core}_dirty.fasta')}",
            f"minc={minc}", f"minp={minp}", f"minr={minr}", f"minl={minl}",
            f"basesundermin={basesundermin}",
            f"log={opath(results)}", f"appendlog={'t' if i else 'f'}",
            f"logheader={'f' if i else 't'}",
        ]
        if mapraw:
            args += [
                f"cov0={opath(f'{core}_covstats0.txt')}",
                f"minratio={minratio}",
            ]
        clean, dirty = filterbycoverage(args)
        kept[core] = (len(clean), len(dirty))

    if not keep_temp:
        for f in temp_files:
            if os.path.exists(f):
                os.remove(f)
    for core, (nc, nd) in kept.items():
        print(f"{core}: kept {nc} contigs, removed {nd}", file=sys.stderr)
    return kept


def summarizecrossblock(argv=None):
    """SummarizeCrossblock (summarizecrossblock.sh) — summarize one or
    more crossblock results.txt files. Mirrors
    driver/SummarizeCrossblock.java: in= is a comma list of results
    files OR a file-of-filenames; output rows are
    `fname copies contigs contigsDiscarded bases basesDiscarded` where
    copies is the 1-based ordinal and the counts come from the contam
    column + length of each row (driver/ParseCrossblockResults.java).
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    if "," in in1:
        paths = [p for p in in1.split(",") if p]
    else:
        with open(in1) as fh:
            paths = [ln.strip() for ln in fh if ln.strip()]
    rows = [b"#fname\tcopies\tcontigs\tcontigsDiscarded\tbases\tbasesDiscarded"]
    for i, path in enumerate(paths, 1):
        try:
            ck = cd = bk = bd = 0
            with open(path, "rb") as fh:
                for line in fh.read().splitlines():
                    if not line or line.startswith(b"#"):
                        continue
                    f = line.split(b"\t")
                    contam, length = f[2] == b"1", int(f[3])
                    if contam:
                        cd += 1
                        bd += length
                    else:
                        ck += 1
                        bk += length
            rows.append(
                b"%s\t%d\t%d\t%d\t%d\t%d"
                % (path.encode(), i, ck + cd, cd, bk + bd, bd)
            )
        except Exception as e:
            print(e, file=sys.stderr)
            rows.append(b"%s\tERROR" % path.encode())
    blob = b"\n".join(rows) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return rows


if __name__ == "__main__":
    main()
