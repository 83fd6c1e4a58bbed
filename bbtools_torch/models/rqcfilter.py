"""RQCFilter2 — the JGI production filtering pipeline (jgi/RQCFilter2.java,
rqcfilter2.sh), as a staged driver over this framework's tools.

Stage chain (RQCFilter2.java step ladder, same order):

  clumpify dedupe -> filterbytile -> chastity -> adapter ktrim ->
  quality trim (qtrim/maxns/maq) -> artifact+phix filter -> spikein ->
  entropy (dust) -> polyfilter -> ribo removal -> host/organelle
  mapping removal (removeref=, comma list: the human/cat/dog/mouse/
  microbe/chloroplast role) -> final khist / bbmerge ihist.

Paired input (in2=) threads twin files through every stage — pairs are
removed together, matching the reference — and the final survivors are
also written interleaved as <stem>.<suffix>.fastq.gz like RQCFilter2's
single-file convention. Outputs in `path=`: the final fastq(s),
file-list.txt, filterstats.txt (per-stage read/base survivorship), and
reproduce.sh (writeReproduceFile analog: the standalone tool command
for each stage).

The port runs every stage's tool on the pipeline's `device=` (cuda by
default, no CPU fallback): BBDuk, clumpify, reformat, BBMap, BBMerge
and kmercountexact each get it; filterbytile is host code. reproduce.sh
keeps the JAX package's lines, without `device=`. The bundled resources
(truseq RNA adapters, pJET, lambda, the rRNA consensus) are the JAX
package's, read by path.
"""

from __future__ import annotations

import os
import sys

from ..core.parser import tokenize
from ..device import resolve_device

#: the JAX package's directory, whose bundled resources are read by path
JAX_PKG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bbtools_tpu",
)


def _count_fq(*paths) -> tuple[int, int]:
    from ..io.fastq import FastqReader

    r, b = 0, 0
    for path in paths:
        if not path:
            continue
        for batch in FastqReader(path):
            r += batch.n
            b += int(batch.lengths.sum())
    return r, b


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    on_dev = [f"device={device}"]
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    outdir = a.get("path", default=".") or "."
    trimq = a.get_float("trimq", default=10.0)
    minlen = a.get_int("minlength", "ml", default=45)
    maxns = a.get_int("maxns", default=3)
    maq = a.get_float("maq", default=5.0)
    do_phix = a.get_bool("phix", default=True)
    do_adapters = a.get_bool("ktrim", "adapters", default=True)
    do_artifacts = a.get_bool("filterk", "artifacts", default=True)
    remove_ref = a.get("removeref")  # host-removal refs (comma list)
    keep_int = a.get_bool("keepintermediates", "ki", default=False)
    # optional reference stages (RQCFilter2.java flag surface)
    do_dedupe = a.get_bool("clumpify", "dedupe", "opticaldupes",
                           default=False)
    entropy = a.get_float("entropy", default=-1.0)
    do_chastity = a.get_bool("chastityfilter", "ch", default=False)
    do_ribo = a.get_bool("removeribo", "ribo", default=False)
    ribodb = a.get("ribodb")  # default: bundled rRNA consensus seqs
    do_poly = a.get_int("polyfilter", "polytrim", default=0)
    do_khist = a.get_bool("khist", "dokhist", default=False)
    do_fbt = a.get_bool("filterbytile", "fbt", default=False)
    do_merge = a.get_bool("merge", "domerge", default=False)
    spikein = a.get("spikein", "spikeinref")
    # RQCFilter2.java round-4 surface: homopolymer trims fold into the
    # trim stage (:2411-2416, trimPolyGLeft=6 default), pJET vector
    # filtered by default (:2429, pjetFlag=true :3973), lambda optional,
    # library=rna adds the truseq RNA adapter set, custom adapter refs
    def _poly(name, dflt):
        v = a.get(name)
        if v is None:
            return dflt
        if v and v[0].isdigit():
            return int(v)
        return 2 if v.lower() in ("t", "true", "1") else 0

    polyg_l = _poly("trimpolygleft", _poly("trimpolyg", 6))
    polyg_r = _poly("trimpolygright", _poly("trimpolyg", 0))
    trimpolya = _poly("trimpolya", 0)
    filterpolyg = _poly("filterpolyg", 0)
    do_pjet = a.get_bool("pjet", default=True)
    do_lambda = a.get_bool("removelambda", "lambda", default=False)
    library = (a.get("library") or "frag").lower()
    fragadapter = a.get("fragadapter", "fragadapters")
    rnaadapter = a.get("rnaadapter", "rnaadapters")
    os.makedirs(outdir, exist_ok=True)
    stem = os.path.basename(in1)
    for ext in (".gz", ".fastq", ".fq", ".fasta", ".fa"):
        if stem.endswith(ext):
            stem = stem[: -len(ext)]

    from .bbduk import main as bbduk_main

    stats_rows = []
    reproduce = []  # (tool, args) per stage — writeReproduceFile analog
    files = [in1] + ([in2] if in2 else [])
    cur = in1
    cur2 = in2
    r0, b0 = _count_fq(in1, in2)
    stats_rows.append(("input", r0, b0))

    def pairnames(outname):
        if not cur2:
            return outname, None
        base = outname.replace(".fastq.gz", "")
        return base + ".R1.fastq.gz", base + ".R2.fastq.gz"

    def advance(tag, outp, outp2):
        nonlocal cur, cur2
        r, b = _count_fq(outp, outp2)
        stats_rows.append((tag, r, b))
        if cur != in1 and not keep_int:
            os.remove(cur)
            if cur2:
                os.remove(cur2)
        cur, cur2 = outp, outp2
        files.append(outp)
        if outp2:
            files.append(outp2)

    def stage(tag: str, args: list[str], outname: str):
        outp, outp2 = pairnames(outname)
        outp = os.path.join(outdir, outp)
        full = [f"in={cur}", f"out={outp}", "overwrite=t"]
        if cur2:
            outp2 = os.path.join(outdir, outp2)
            full += [f"in2={cur2}", f"out2={outp2}"]
        bbduk_main(full + args + on_dev)
        reproduce.append(("bbduk", full + args))
        advance(tag, outp, outp2)

    suffix = ""
    if do_dedupe:
        # optical/exact duplicate removal (RQCFilter2 clumpify stage —
        # runs FIRST so later stages see the deduplicated stream)
        from .clumpify import main as clumpify_main

        outp, outp2 = pairnames(f"{stem}.dd.fastq.gz")
        outp = os.path.join(outdir, outp)
        args = [f"in={cur}", f"out={outp}", "dedupe=t", "overwrite=t"]
        if cur2:
            outp2 = os.path.join(outdir, outp2)
            args += [f"in2={cur2}", f"out2={outp2}"]
        clumpify_main(args + on_dev)
        reproduce.append(("clumpify", args))
        advance("dedupe", outp, outp2)
    if do_fbt:
        # positional quality filtering (RQCFilter2 filterbytile stage)
        from .filterbytile import main as fbt_main

        outp, outp2 = pairnames(f"{stem}.fbt.fastq.gz")
        outp = os.path.join(outdir, outp)
        args = [f"in={cur}", f"out={outp}", "overwrite=t"]
        if cur2:
            outp2 = os.path.join(outdir, outp2)
            args += [f"in2={cur2}", f"out2={outp2}"]
        fbt_main(args)
        reproduce.append(("filterbytile", args))
        advance("filterbytile", outp, outp2)
    if do_chastity:
        # Illumina chastity fail removal (RQCFilter2 chastityfilter)
        from .reformat import main as reformat_main

        outp, outp2 = pairnames(f"{stem}.ch.fastq.gz")
        outp = os.path.join(outdir, outp)
        args = [f"in={cur}", f"out={outp}", "ch=t", "overwrite=t"]
        if cur2:
            outp2 = os.path.join(outdir, outp2)
            args += [f"in2={cur2}", f"out2={outp2}"]
        reformat_main(args + on_dev)
        reproduce.append(("reformat", args))
        advance("chastity", outp, outp2)
    if do_adapters:
        suffix += "a"
        ref = "adapters"
        if fragadapter:
            ref = fragadapter
        if library == "rna":
            ref = rnaadapter or os.path.join(
                JAX_PKG_DIR, "resources",
                "truseq_rna.fa.gz",
            )
        args = [f"ref={ref}", "ktrim=r", "k=23", "mink=11", "hdist=1",
                f"minlen={minlen}"]
        # homopolymer handling folds into the same bbduk pass
        # (RQCFilter2.java:2411-2416, maxnonpoly=2)
        if polyg_l:
            args.append(f"trimpolygleft={polyg_l}")
        if polyg_r:
            args.append(f"trimpolygright={polyg_r}")
        if trimpolya:
            args.append(f"trimpolya={trimpolya}")
        if filterpolyg:
            args.append(f"filterpolyg={filterpolyg}")
        args.append("maxnonpoly=2")
        if cur2:
            args += ["tbo=t", "tpe=t"]  # pair-aware trims, like the sh
        stage("ktrim", args, f"{stem}.{suffix}.fastq.gz")
    # n-removal + quality trim + maq in one pass (the reference's
    # qtrim/maxns/maq stage)
    suffix += "nq"
    stage(
        "qtrim",
        [f"qtrim=rl", f"trimq={trimq}", f"maxns={maxns}", f"maq={maq}",
         f"minlen={minlen}"],
        f"{stem}.{suffix}.fastq.gz",
    )
    if do_artifacts or do_phix or do_pjet or do_lambda:
        res_dir = os.path.join(JAX_PKG_DIR, "resources")
        refs = []
        if do_artifacts:
            refs.append("artifacts")
        if do_phix:
            refs.append("phix")
        if do_pjet:
            # pJET1.2 cloning-vector contamination (RQCFilter2 pjetRef)
            refs.append(os.path.join(res_dir, "pJET1.2.fa"))
        if do_lambda:
            refs.append(os.path.join(res_dir, "lambda.fa.gz"))
        suffix += "p" if do_phix else ""
        suffix += "t" if do_artifacts else ""
        if not (do_phix or do_artifacts):
            suffix += "v"  # vector-only filter pass (pjet/lambda)
        stage(
            "filter",
            [f"ref={','.join(refs)}", "k=31", "hdist=1",
             f"minlen={minlen}"],
            f"{stem}.{suffix}.fastq.gz",
        )
    if spikein:
        # spike-in removal + counting (RQCFilter2 doSpikein -> Seal
        # role: matched reads counted per reference then removed)
        suffix += "s"
        stage(
            "spikein",
            [f"ref={spikein}", "k=31", "hdist=0", f"minlen={minlen}"],
            f"{stem}.{suffix}.fastq.gz",
        )
    if entropy >= 0:
        # low-complexity removal (RQCFilter2 entropy= -> BBDuk)
        suffix += "d"  # "dusted" in the reference's suffix chain
        stage(
            "entropy",
            [f"entropy={entropy}", f"minlen={minlen}"],
            f"{stem}.{suffix}.fastq.gz",
        )
    if do_poly > 0:
        # poly-G/poly-C tail trimming (RQCFilter2 polyfilter role):
        # ktrim against literal homopolymer 31-mers
        suffix += "g"
        stage(
            "polyfilter",
            ["literal=" + ",".join(["G" * 31, "C" * 31]),
             "k=31", "ktrim=r", "mink=29", f"minlen={minlen}"],
            f"{stem}.{suffix}.fastq.gz",
        )
    if do_ribo:
        # rRNA removal vs ribo kmers (RQCFilter2 removeribo -> riboKmers;
        # default db = the bundled SSU/LSU consensus sequences)
        if not ribodb:
            res = os.path.join(
                JAX_PKG_DIR, "resources"
            )
            ribodb = ",".join(
                os.path.join(res, f)
                for f in (
                    "16S_consensus_sequence.fa",
                    "18S_consensus_sequence.fa",
                    "23S_consensus_sequence.fa",
                    "5S_consensus_sequence.fa",
                )
                if os.path.exists(os.path.join(res, f))
            )
        suffix += "r"
        stage(
            "ribo",
            [f"ref={ribodb}", "k=31", "hdist=1", f"minlen={minlen}"],
            f"{stem}.{suffix}.fastq.gz",
        )
    if remove_ref:
        # mapping-based removal, one pass per reference (the reference's
        # human/cat/dog/mouse then microbe then chloroplast ladder; pairs
        # survive only when NEITHER mate maps)
        from ..io.fastq import FastqReader, FastqWriter
        from ..io.readwrite import open_input
        from .bbmap import BBMap, BBMapConfig

        import numpy as np

        for ri, ref in enumerate(remove_ref.split(",")):
            ref = ref.strip()
            tag = os.path.basename(ref).split(".")[0] or f"ref{ri}"
            suffix += "h" if ri == 0 else ""
            outp, outp2 = pairnames(f"{stem}.{suffix}{ri}.fastq.gz")
            outp = os.path.join(outdir, outp)
            if outp2:
                outp2 = os.path.join(outdir, outp2)
            sam = os.path.join(outdir, f"{stem}.{tag}.sam")
            cfgkw = dict(ref=ref, in1=cur, out=sam)
            if cur2:
                cfgkw["in2"] = cur2
            cfgkw["device"] = str(device)
            tool = BBMap(BBMapConfig(**cfgkw))
            tool.run()
            reproduce.append(
                ("bbmap", [f"ref={ref}", f"in={cur}", f"out={sam}"]))
            mapped = set()
            with open_input(sam) as fh:
                for line in fh.read().splitlines():
                    if line.startswith(b"@"):
                        continue
                    f = line.split(b"\t")
                    if not int(f[1]) & 0x4:
                        mapped.add(f[0])
            w2 = FastqWriter(outp2) if outp2 else None
            it2 = iter(FastqReader(cur2)) if cur2 else None
            with FastqWriter(outp) as w:
                for batch in FastqReader(cur):
                    keep = np.array(
                        [i.split()[0] not in mapped for i in batch.ids]
                    )
                    if it2 is not None:
                        b2 = next(it2)
                        keep &= np.array(
                            [i.split()[0] not in mapped for i in b2.ids]
                        )
                        w2.add(b2, keep)
                    w.add(batch, keep)
            if w2 is not None:
                w2.close()
            os.remove(sam)
            advance(f"removal_{tag}", outp, outp2)

    final1, final2 = cur, cur2
    if cur2:
        # single interleaved final file, the reference's paired-output
        # convention (<stem>.<chain>.fastq.gz)
        from .reformat import main as reformat_main

        inter = os.path.join(outdir, f"{stem}.{suffix}.fastq.gz")
        reformat_main([f"in={cur}", f"in2={cur2}", f"out={inter}",
                       "overwrite=t", *on_dev])
        files.append(inter)
        final1 = inter

    if do_merge and cur2:
        # insert-size QC (RQCFilter2 doMerge -> BBMerge ihist)
        from .bbmerge import main as bbmerge_main

        ih = os.path.join(outdir, f"{stem}.ihist_merge.txt")
        bbmerge_main([f"in={cur}", f"in2={cur2}", f"ihist={ih}", *on_dev])
        reproduce.append(
            ("bbmerge", [f"in={cur}", f"in2={cur2}", f"ihist={ih}"]))
        files.append(ih)

    if do_khist:
        # k-mer depth histogram of the surviving reads (RQCFilter2
        # khist= stage -> KmerCountExact)
        from .kmercountexact import run as kce_run

        kh = os.path.join(outdir, f"{stem}.khist.txt")
        kce_run([f"in={final1}", f"khist={kh}", "k=31", *on_dev])
        reproduce.append(("kmercountexact",
                          [f"in={final1}", f"khist={kh}", "k=31"]))
        files.append(kh)

    # final artifacts: file list + survivorship stats + reproduce script
    with open(os.path.join(outdir, "file-list.txt"), "w") as fh:
        fh.write(f"filtered_fastq={os.path.basename(final1)}\n")
        if cur2:
            fh.write(f"filtered_fastq_r1={os.path.basename(cur)}\n")
            fh.write(f"filtered_fastq_r2={os.path.basename(cur2)}\n")
    with open(os.path.join(outdir, "filterstats.txt"), "w") as fh:
        fh.write("#stage\treads\tbases\treads_pct\tbases_pct\n")
        for tag, r, b in stats_rows:
            fh.write(
                f"{tag}\t{r}\t{b}\t{100*r/max(r0,1):.2f}\t"
                f"{100*b/max(b0,1):.2f}\n"
            )
    with open(os.path.join(outdir, "reproduce.sh"), "w") as fh:
        fh.write("#!/bin/bash\n#Commands to reproduce each stage "
                 "(RQCFilter2 writeReproduceFile analog)\n")
        for tool, args in reproduce:
            fh.write(f"{tool}.sh {' '.join(args)}\n")
    print(f"Final output:        \t{final1}", file=sys.stderr)
    print(
        f"Reads surviving:     \t{stats_rows[-1][1]} "
        f"({100*stats_rows[-1][1]/max(r0,1):.2f}%)",
        file=sys.stderr,
    )
    return stats_rows, final1
