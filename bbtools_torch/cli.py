"""Unified CLI of the port — the `tool.sh key=value` surface:
python -m bbtools_torch <tool> key=value ...

Every tool of bbtools_tpu is registered in TOOLS under its name, each
running on the card unless given device=cpu (the host-only ones, stats,
pileup, calctruequality, gradesam, reformatpb, the host aligner
launchers, the vector tools, the read-handling tools around rqcfilter
and most of the long tail, run anywhere). A name not in TOOLS raises
(unknown tool). Before any tool runs, `guard_output_files`
refuses duplicate outputs, an output that is also an input, and an
existing output under ow=f. Where torchrun's variables describe a group
of processes, `main` joins it first (parallel/distributed.py).
"""

from __future__ import annotations

import os
import sys


def _bbduk(args):
    from .models.bbduk import main

    return main(args)


def _bbmerge(args):
    from .models.bbmerge import main

    return main(args)


def _bbmap(args):
    from .models.bbmap import main

    return main(args)


def _remove_preset(args, what: str):
    """removehuman.sh / removemicrobes.sh / removecatdogmousehuman.sh:
    BBMap decontamination presets (minratio=0.9 maxindel=3 maxsites=1
    k=14 bloomfilter; mapped reads -> outm, clean reads -> outu). The
    reference hardcodes JGI-filesystem masked references; here ref= (or
    path= with a prebuilt index) must point at the local masked genome.
    """
    from .models.bbmap import main

    keys = {t.split("=")[0].lower() for t in args if "=" in t}
    if not ({"ref", "path", "indexpath"} & keys):
        raise ValueError(
            f"{what} requires ref= (masked {what} genome) or path= "
            "(prebuilt index); the reference's hardcoded JGI paths "
            "are not portable"
        )
    preset = [
        "minratio=0.9", "maxindel=3", "maxsites=1", "k=14",
        "bloomfilter=t",
    ]
    return main(preset + list(args))


def _bbwrap(args):
    """bbwrap.sh: map MULTIPLE in=/out= comma-lists against one reference
    without rebuilding the index (BBWrap.java role)."""
    from .core.parser import tokenize
    from .models.bbmap import BBMap, parse_args

    a = tokenize(args)
    ins = (a.get("in", "in1") or "").split(",")
    in2s = (a.get("in2") or "").split(",") if a.get("in2") else [None] * len(ins)
    outs = (a.get("out", "outm") or "").split(",") if a.get("out", "outm") else [None] * len(ins)
    base = [t for t in args if not t.split("=")[0] in ("in", "in1", "in2", "out", "outm")]
    tool = None
    for i, inp in enumerate(ins):
        sub = base + [f"in={inp}"]
        if i < len(in2s) and in2s[i]:
            sub.append(f"in2={in2s[i]}")
        if i < len(outs) and outs[i]:
            sub.append(f"out={outs[i]}")
        cfg = parse_args(sub)
        if tool is None:
            tool = BBMap(cfg)
        else:
            tool = BBMap(cfg, index=tool.index)  # reuse the index
        tool.run()
        tool.print_stats()
    return tool


def _mappacbio(args):
    from .models.bbmap import main

    return main(args, preset="pacbio")


def _bbmapskimmer(args):
    from .models.bbmap import main

    return main(args, preset="skimmer")


def _pileup(args):
    from .models.pileup import main

    return main(args)


def _calctruequality(args):
    from .models.calctruequality import main

    return main(args)


def _gradesam(args):
    from .models.gradesam import main

    return main(args)


def _bbsplit(args):
    from .models.bbsplit import main

    return main(args)


def _kmercountexact(args):
    from .models.kmercountexact import main

    return main(args)


def _tadpole(args):
    from .models.tadpole import main

    return main(args)


def _callvariants(args):
    from .models.callvariants import main

    return main(args)


def _tadpipe(args):
    from .models.tadpipe import tadpipe

    return tadpipe(args)


def _tadpolewrapper(args):
    from .models.tadpipe import tadpolewrapper

    return tadpolewrapper(args)


def _assemblystats(args):
    from .models.assemblystats import main

    return main(args)


def _bbcms(args):
    from .models.bbcms import main

    return main(args)


def _bbrealign(args):
    from .models.bbrealign import main

    return main(args)


def _seal(args):
    from .models.seal import main

    return main(args)


def _loglog(args):
    from .models.loglog import main

    return main(args)


def _bbnorm(args):
    from .models.bbnorm import main

    return main(args)


def _ecc(args):
    # ecc.sh = KmerNormalize with ecc=t keepall=t passes=1
    from .models.bbnorm import main

    return main(args, ecc_tool=True)


def _dedupe(args):
    from .models.dedupe import main

    return main(args)


def _clumpify(args):
    from .models.clumpify import main

    return main(args)


def _sketch(args):
    from .models.sketch import main

    return main(args)


def _quickclade(args):
    from .models.clade import main

    return main(args)


def _gradevcf(args):
    from .utils.graders2 import grade_vcf_main

    return grade_vcf_main(args)


def _grademerged(args):
    from .utils.graders2 import grade_merged_main

    return grade_merged_main(args)


def _server(args):
    from .models.server import main

    return main(args)


def _taxonomy(args):
    from .models.taxonomy import main

    return main(args)


def _filterbytaxa(args):
    from .models.taxonomy import filter_by_taxa

    return filter_by_taxa(args)


def _randomreads(args):
    from .models.randomreads import main

    return main(args)


def _consensus(args):
    from .models.consensus import main

    return main(args)


def _lilypad(args):
    from .models.lilypad import main

    return main(args)


def _quickbin(args):
    from .models.quickbin import main

    return main(args)


def _callgenes(args):
    from .models.callgenes import main

    return main(args)


def _crosscontaminate(args):
    from .models.contam import cross_contaminate

    return cross_contaminate(args)


def _makecontaminated(args):
    from .models.contam import make_contaminated

    return make_contaminated(args)


def _splitsam_n(args, way: int):
    from .models.samutils import splitsam

    return splitsam(args, way=way)


def _lazy(module: str, fn: str, args, *extra):
    import importlib

    m = importlib.import_module(f".models.{module}", __package__)
    return getattr(m, fn)(args, *extra)


TOOLS = {
    "bbduk": _bbduk,
    # same-main-class launcher aliases (bbduk.BBDukS)
    "bbduks": _bbduk,
    "bbmerge": _bbmerge,
    "bbmerge-auto": _bbmerge,
    "bbmap": _bbmap,
    # align2.BBMap5 / BBMapAcc: generations of the same pipeline
    "bbmap5": _bbmap,
    "bbmapacc": _bbmap,
    # mapPacBio.sh / bbmapskimmer.sh: the long-read presets
    "mappacbio": _mappacbio,
    "bbmapskimmer": _bbmapskimmer,
    "mappacbioskimmer": _bbmapskimmer,
    # BBWrap: many inputs against one index
    "bbwrap": _bbwrap,
    # BBMap decontamination presets; ref= or path= required
    "removehuman": lambda a: _remove_preset(a, "human"),
    "removehuman2": lambda a: _remove_preset(a, "human"),
    "removemicrobes": lambda a: _remove_preset(a, "microbe"),
    "removecatdogmousehuman": lambda a: _remove_preset(a, "catdogmousehuman"),
    "bbsplit": _bbsplit,
    # host only: coverage from SAM, quality matrices from SAM, grading
    "pileup": _pileup,
    "coveragepileup": _pileup,
    "pileup2": _pileup,
    "calctruequality": _calctruequality,
    "gradesam": _gradesam,
    "kmercountexact": _kmercountexact,
    "kmercount": _kmercountexact,
    "khist": _kmercountexact,
    "tadpole": _tadpole,
    "callvariants": _callvariants,
    "callvariants2": _callvariants,
    "tadpipe": _tadpipe,
    "tadwrapper": _tadpolewrapper,
    "tadpolewrapper": _tadpolewrapper,
    # host only: N50/L50 and the summary block of a FASTA
    "stats": _assemblystats,
    "assemblystats": _assemblystats,
    "bbcms": _bbcms,
    "bbrealign": _bbrealign,
    "seal": _seal,
    "loglog": _loglog,
    "bbnorm": _bbnorm,
    "ecc": _ecc,
    "dedupe": _dedupe,
    # Dedupe2: a rewrite of the same tool surface
    "dedupe2": _dedupe,
    "clumpify": _clumpify,
    "reformat": lambda a: _lazy("reformat", "main", a),
    # ReformatReads2/3: rewrites of the same tool surface
    "reformat2": lambda a: _lazy("reformat", "main", a),
    "reformat3": lambda a: _lazy("reformat", "main", a),
    "alltoall": lambda a: _lazy("alltoall", "main", a),
    "idmatrix": lambda a: _lazy("alltoall", "main", a),
    "splitribo": lambda a: _lazy("ribo", "splitribo", a),
    "mergeribo": lambda a: _lazy("ribo", "mergeribo", a),
    "keepbestcopy": lambda a: _lazy("ribo", "mergeribo", a),
    "icecream": lambda a: _lazy("icecream", "main", a),
    "icecreamfinder": lambda a: _lazy("icecream", "main", a),
    # host only: ZMW-aware filtering of PacBio subreads
    "reformatpb": lambda a: _lazy("icecream", "reformatpb", a),
    # the idaligner/aligner launchers (idaligner/Test.java testAndPrint;
    # <engine>aligner.sh): the per-engine launchers, the validation
    # ladder, alignerbenchmark and the visualizers run the host engines
    "glocalaligner": lambda a: _lazy("alignertools", "test_main", a, "glocal"),
    "bandedaligner": lambda a: _lazy("alignertools", "test_main", a, "banded"),
    "bandedplusaligner": lambda a: _lazy("alignertools", "test_main", a, "bandedplus"),
    "driftingaligner": lambda a: _lazy("alignertools", "test_main", a, "drifting"),
    "driftingplusaligner": lambda a: _lazy("alignertools", "test_main", a, "driftingplus"),
    "wavefrontaligner": lambda a: _lazy("alignertools", "test_main", a, "wavefront"),
    "quantumaligner": lambda a: _lazy("alignertools", "test_main", a, "quantum"),
    "quabblealigner": lambda a: _lazy("alignertools", "test_main", a, "quabble"),
    "scrabblealigner": lambda a: _lazy("alignertools", "test_main", a, "scrabble"),
    "wobblealigner": lambda a: _lazy("alignertools", "test_main", a, "wobble"),
    "wobbleplusaligner": lambda a: _lazy("alignertools", "test_main", a, "wobbleplus"),
    "crosscutaligner": lambda a: _lazy("alignertools", "test_main", a, "crosscut"),
    "xdrophaligner": lambda a: _lazy("alignertools", "test_main", a, "xdroph"),
    "parallelogram": lambda a: _lazy("alignertools", "test_main", a, "parallelogram"),
    "smithwaterman": lambda a: _lazy("alignertools", "test_main", a, "glocal"),
    "testaligners": lambda a: _lazy("alignertools", "test_main", a),
    "testaligners2": lambda a: _lazy("alignertools", "suite_main", a),
    "alignerbenchmark": lambda a: _lazy("alignertools", "benchmark_main", a),
    "visualizealignment": lambda a: _lazy("alignertools", "visualize_main", a),
    "wavefrontalignerviz": lambda a: _lazy("alignertools", "visualize_main", a),
    # on the device: the sweep harnesses (glocal, or banded past 2^22
    # cells) and the micro-aligner
    "testalignersbatch": lambda a: _lazy("alignertools", "batch_main", a),
    "testalignerslength": lambda a: _lazy("alignertools", "length_main", a),
    "alignrandom": lambda a: _lazy("alignertools", "align_random_main", a),
    "microalign": lambda a: _lazy("alignertools", "micro_main", a),
    # the last device-using tools: substitution-only search (primer
    # sites, panels against a genome), the count-min sketch tools, and
    # the CellNet family (training, scoring, filtering; the vectorizer
    # and the vector TSV tools are host only) and calibration
    "findprimers": lambda a: _lazy("findprimers", "main", a),
    "msa": lambda a: _lazy("findprimers", "main", a),
    "indelfree": lambda a: _lazy("indelfree", "main", a),
    "indelfreealigner": lambda a: _lazy("indelfree", "main", a),
    "kmercoverage": lambda a: _lazy("misctools", "kmercoverage", a),
    "bloomfilter": lambda a: _lazy("texttools", "bloomfilter", a),
    "polyfilter": lambda a: _lazy("polyfilter", "main", a),
    "seqtovec": lambda a: _lazy("mltools", "seqtovec_main", a),
    "train": lambda a: _lazy("mltools", "train_main", a),
    "netconvert": lambda a: _lazy("mltools", "netconvert_main", a),
    "scoresequence": lambda a: _lazy("mltools", "scoresequence_main", a),
    "netfilter": lambda a: _lazy("mltools", "netfilter_main", a),
    "reducecolumns": lambda a: _lazy("mltools", "reducecolumns_main", a),
    "vectorutils": lambda a: _lazy("mltools", "vectorutils_main", a),
    "balancevectors": lambda a: _lazy("mltools", "balancevectors_main", a),
    "calibrate": lambda a: _lazy("research", "calibrate_main", a),
    "regressiontrainer": lambda a: _lazy("research", "regressiontrainer_main", a),
    # A8b's read-QC slice: RQCFilter2 (every stage's tool on device=) and
    # DecontaminateByNormalization (BBMap, bbnorm, Tadpole on device=)
    "rqcfilter": lambda a: _lazy("rqcfilter", "main", a),
    "rqcfilter2": lambda a: _lazy("rqcfilter", "main", a),
    "rqcfilter3": lambda a: _lazy("rqcfilter", "main", a),
    "decontaminate": lambda a: _lazy("decontaminate", "main", a),
    "crossblock": lambda a: _lazy("decontaminate", "main", a),
    # host only: the read-handling tools of the same family
    "summarizecrossblock": lambda a: _lazy("decontaminate", "summarizecrossblock", a),
    "filterbytile": lambda a: _lazy("filterbytile", "main", a),
    "analyzeflowcell": lambda a: _lazy("filterbytile", "main", a),
    "demux": lambda a: _lazy("demux", "main", a),
    "demuxbyname": lambda a: _lazy("demux", "main", a),
    "filterbycoverage": lambda a: _lazy("seqtools", "filterbycoverage", a),
    "trimcontigs": lambda a: _lazy("seqtools", "trimcontigs", a),
    "shuffle": lambda a: _lazy("seqtools", "shuffle", a),
    "shuffle2": lambda a: _lazy("seqtools", "shuffle", a),
    "getreads": lambda a: _lazy("seqtools", "getreads", a),
    "replaceheaders": lambda a: _lazy("seqtools", "replaceheaders", a),
    "randomgenome": lambda a: _lazy("seqtools", "randomgenome", a),
    "makepolymers": lambda a: _lazy("seqtools", "makepolymers", a),
    "tetramerfreq": lambda a: _lazy("seqtools", "tetramerfreq", a),
    "callpeaks": lambda a: _lazy("seqtools", "callpeaks", a),
    "novademux": lambda a: _lazy("novademux", "main", a),
    "filterbyname": lambda a: _lazy("filtertools", "filterbyname", a),
    "filterbysequence": lambda a: _lazy("filtertools", "filterbysequence", a),
    "filtersam": lambda a: _lazy("filtertools", "filtersam", a),
    "countbarcodes": lambda a: _lazy("filtertools", "countbarcodes", a),
    "countbarcodes2": lambda a: _lazy("filtertools", "countbarcodes", a),
    "cutprimers": lambda a: _lazy("filtertools", "cutprimers", a),
    "repair": lambda a: _lazy("splitpairs", "main", list(a) + ["repair=t"]),
    "splitpairs": lambda a: _lazy("splitpairs", "main", a),
    "bbsplitpairs": lambda a: _lazy("splitpairs", "main", a),
    "sortbyname": lambda a: _lazy("sortbyname", "main", a),
    "bbsort": lambda a: _lazy("sortbyname", "main", a),
    "mergesorted": lambda a: _lazy("sortbyname", "mergesorted", a),
    "bbmask": lambda a: _lazy("bbmask", "main", a),
    "shred": lambda a: _lazy("smalltools", "shred", a),
    "fuse": lambda a: _lazy("smalltools", "fuse", a),
    "fusesequence": lambda a: _lazy("smalltools", "fuse", a),
    "partition": lambda a: _lazy("smalltools", "partition", a),
    "partitionreads": lambda a: _lazy("smalltools", "partition", a),
    "bbcountunique": lambda a: _lazy("smalltools", "count_uniqueness", a),
    "calcuniqueness": lambda a: _lazy("smalltools", "count_uniqueness", a),
    "comparelabels": lambda a: _lazy("barcodetools", "comparelabels", a),
    "muxbyname": lambda a: _lazy("barcodetools", "muxbyname", a),
    "removebadbarcodes": lambda a: _lazy("barcodetools", "removebadbarcodes", a),
    "filterbarcodes": lambda a: _lazy("barcodetools", "filterbarcodes", a),
    "tiledump": lambda a: _lazy("hiseqtools", "tiledump_main", a),
    "plotflowcell": lambda a: _lazy("hiseqtools", "plotflowcell_main", a),
    "plothist": lambda a: _lazy("hiseqtools", "plothist_main", a),
    "plotreadposition": lambda a: _lazy("hiseqtools", "plotreadposition_main", a),
    "cg2illumina": lambda a: _lazy("hiseqtools", "cg2illumina_main", a),
    "kapastats": lambda a: _lazy("hiseqtools", "kapastats_main", a),
    "cbcl2text": lambda a: _lazy("illuminatools", "cbcl2text_main", a),
    "splitnextera": lambda a: _lazy("splitnextera", "main", a),
    "splitnexteralmp": lambda a: _lazy("splitnextera", "main", a),
    # A8b's host tools: aliases of ported modules (BBDukF's older launcher,
    # the stats launchers) and the version line
    "bbdukold": _bbduk,
    "bbstats": _assemblystats,
    "stats3": _assemblystats,
    "bbversion": lambda a: print("bbtools_torch 2.0 (BBTools 39.x surface)"),
    # the VCF and merged-read graders
    "gradevcf": _gradevcf,
    "comparevcf": _gradevcf,
    "grademerge": _grademerged,
    "grademerged": _grademerged,
    "grademergedreads": _grademerged,
    # MinHash sketches, the taxonomy tree, QuickClade and the HTTP server
    # (bound to 127.0.0.1)
    "sketch": _sketch,
    "bbsketch": _sketch,
    "comparesketch": _sketch,
    "sendsketch": _sketch,
    "mergesketch": lambda a: _lazy("sketch", "mergesketch", a),
    "subsketch": lambda a: _lazy("sketch", "subsketch", a),
    "summarizesketch": lambda a: _lazy("sketch", "summarizesketch", a),
    "taxonomy": _taxonomy,
    "taxtree": _taxonomy,
    "filterbytaxa": _filterbytaxa,
    "splitbytaxa": lambda a: _lazy("taxonomy", "split_by_taxa", a),
    "fusebytaxa": lambda a: _lazy("taxonomy", "fuse_by_taxa", a),
    "gi2taxid": lambda a: _lazy("taxonomy", "gi2taxid", a),
    "gi2ancestors": lambda a: _lazy("taxonomy", "gi2ancestors", a),
    "gitable": lambda a: _lazy("taxonomy", "gitable", a),
    "taxsize": lambda a: _lazy("taxonomy", "taxsize", a),
    "explodetree": lambda a: _lazy("taxonomy", "explodetree", a),
    "analyzeaccession": lambda a: _lazy("taxonomy", "analyzeaccession", a),
    "shrinkaccession": lambda a: _lazy("taxonomy", "shrinkaccession", a),
    "filterassemblysummary": lambda a: _lazy(
        "taxonomy", "filterassemblysummary", a
    ),
    "fetchproks": lambda a: _lazy("taxonomy", "fetchproks", a),
    "quickclade": _quickclade,
    "clade": _quickclade,
    "sendclade": _quickclade,
    "cladeloader": lambda a: _lazy("clade", "cladeloader_main", a),
    "server": _server,
    "taxserver": _server,
    "sketchserver": _server,
    "cladeserver": _server,
    "ssuserver": _server,
    "demuxserver": _server,
    # the SSU tools; comparessu and findssu align on the run's device (L5)
    "findssu": lambda a: _lazy("ssutools", "findssu_main", a),
    "comparessu": lambda a: _lazy("ssutools", "comparessu_main", a),
    "filtersilva": lambda a: _lazy("ssutools", "filtersilva_main", a),
    "reducesilva": lambda a: _lazy("ssutools", "reducesilva_main", a),
    "addssu": lambda a: _lazy("ssutools", "addssu_main", a),
    "idtree": lambda a: _lazy("ssutools", "idtree_main", a),
    "trnaconsensus": lambda a: _lazy("ssutools", "trnaconsensus_main", a),
    "runhmm": lambda a: _lazy("ssutools", "runhmm_main", a),
    # synthesis and k-mer tools; kmerlimit tracks its cardinality on the
    # run's device (models/loglog.py)
    "mutate": lambda a: _lazy("synthtools", "mutate", a),
    "mutategenome": lambda a: _lazy("synthtools", "mutate", a),
    "bbfakereads": lambda a: _lazy("synthtools", "fakereads", a),
    "fakereads": lambda a: _lazy("synthtools", "fakereads", a),
    "kcompress": lambda a: _lazy("synthtools", "kcompress", a),
    "kmerlimit": lambda a: _lazy("synthtools", "kmerlimit", a),
    "kmerlimit2": lambda a: _lazy("synthtools", "kmerlimit", a),
    "findrepeats": lambda a: _lazy("synthtools", "findrepeats", a),
    "addadapters": lambda a: _lazy("synthtools", "addadapters", a),
    "makechimeras": lambda a: _lazy("synthtools", "makechimeras", a),
    "checkstrand": lambda a: _lazy("synthtools", "checkstrand", a),
    "kmutate": lambda a: _lazy("synthtools", "kmutate", a),
    "randomreadsmg": lambda a: _lazy("synthtools", "randomreadsmg", a),
    "kmerfilterset": lambda a: _lazy("synthtools", "kmerfilterset", a),
    "icecreammaker": lambda a: _lazy("synthtools", "icecreammaker", a),
    "icecreamgrader": lambda a: _lazy("synthtools", "icecreamgrader", a),
    # sequence, SAM and interval odds and ends
    "adjusthomopolymers": lambda a: _lazy(
        "seqmisc", "adjusthomopolymers_main", a),
    "restorebases": lambda a: _lazy("seqmisc", "restorebases_main", a),
    "representative": lambda a: _lazy("seqmisc", "representative_main", a),
    "bedset": lambda a: _lazy("seqmisc", "bedset_main", a),
    "tagandmerge": lambda a: _lazy("seqmisc", "tagandmerge_main", a),
    "processhi-c": lambda a: _lazy("seqmisc", "hic_junctions_main", a),
    "synthmda": lambda a: _lazy("seqmisc", "synthmda_main", a),
    "kmercountshort": lambda a: _lazy("seqmisc", "kmercountshort_main", a),
    "kmerhashdump": lambda a: _lazy("seqmisc", "kmerhashdump_main", a),
    "estherfilter": lambda a: _lazy("seqmisc", "estherfilter_main", a),
    "renameref": lambda a: _lazy("seqmisc", "renameref_main", a),
    "renamebymapping": lambda a: _lazy("seqmisc", "renamebymapping_main", a),
    "renamecami": lambda a: _lazy("seqmisc", "renamecami_main", a),
    "renameimg": lambda a: _lazy("seqmisc", "renameimg_main", a),
    "renamebysketch": lambda a: _lazy("seqmisc", "renamebysketch_main", a),
    # file and launcher utilities
    "unzip": lambda a: _lazy("fileutils", "unzip_main", a),
    "cat": lambda a: _lazy("fileutils", "cat_main", a),
    "copyfile": lambda a: _lazy("fileutils", "copyfile_main", a),
    "textfile": lambda a: _lazy("fileutils", "textfile_main", a),
    "filescan": lambda a: _lazy("fileutils", "filescan_main", a),
    "printtime": lambda a: _lazy("fileutils", "printtime_main", a),
    "stream": lambda a: _lazy("fileutils", "streamer_main", a),
    "samstreamer": lambda a: _lazy("fileutils", "samstreamer_main", a),
    "diskbench": lambda a: _lazy("fileutils", "diskbench_main", a),
    "testfilesystem": lambda a: _lazy("fileutils", "testfilesystem_main", a),
    "a_sample_mt": lambda a: _lazy("fileutils", "sample_mt_main", a),
    "calcmem": lambda a: _lazy("fileutils", "calcmem_main", a),
    "memdetect": lambda a: _lazy("fileutils", "calcmem_main", a),
    "javasetup": lambda a: _lazy("fileutils", "javasetup_main", a),
    "profile": lambda a: _lazy("fileutils", "profile_main", a),
    "fix_script_paths": lambda a: _lazy(
        "fileutils", "fix_script_paths_main", a),
    "addx": lambda a: _lazy("fileutils", "addx_main", a),
    "zz_rename_package": lambda a: _lazy(
        "fileutils", "zz_rename_package_main", a),
    "processspeed": lambda a: _lazy("fileutils", "processspeed_main", a),
    "webcheck": lambda a: _lazy("fileutils", "webcheck_main", a),
    "summarizecontam": lambda a: _lazy(
        "fileutils", "summarizecontam_main", a),
    "analyzesketchresults": lambda a: _lazy(
        "fileutils", "analyzesketchresults_main", a),
    # the text and report tools beside bloomfilter; kmercountmulti tracks
    # its cardinalities on the run's device
    "readlength": lambda a: _lazy("texttools", "readlength", a),
    "countgc": lambda a: _lazy("texttools", "countgc", a),
    "testformat": lambda a: _lazy("texttools", "testformat", a),
    "testformat2": lambda a: _lazy("texttools", "testformat", a),
    "translate6frames": lambda a: _lazy("texttools", "translate6frames", a),
    "statswrapper": lambda a: _lazy("texttools", "statswrapper", a),
    "sketchblacklist": lambda a: _lazy("texttools", "sketchblacklist", a),
    "sketchblacklist2": lambda a: _lazy("texttools", "sketchblacklist", a),
    "rename": lambda a: _lazy("texttools", "rename", a),
    "bbrename": lambda a: _lazy("texttools", "rename", a),
    "kmercountmulti": lambda a: _lazy("texttools", "kmercountmulti", a),
    "filterlines": lambda a: _lazy("texttools", "filterlines", a),
    "countsharedlines": lambda a: _lazy("texttools", "countsharedlines", a),
    "unicode2ascii": lambda a: _lazy("texttools", "unicode2ascii", a),
    "phylip2fasta": lambda a: _lazy("texttools", "phylip2fasta", a),
    "summarizeseal": lambda a: _lazy("texttools", "summarizeseal", a),
    "picksubset": lambda a: _lazy("texttools", "picksubset", a),
    "summarizecoverage": lambda a: _lazy("texttools", "summarizecoverage", a),
    "summarizescafstats": lambda a: _lazy("texttools", "summarizescafstats", a),
    "fastqscan": lambda a: _lazy("texttools", "fastqscan", a),
    "loadreads": lambda a: _lazy("texttools", "fastqscan", a),
    "plotgc": lambda a: _lazy("texttools", "plotgc", a),
    "summarizemerge": lambda a: _lazy("texttools", "summarizemerge", a),
    "summarizequast": lambda a: _lazy("texttools", "summarizequast", a),
    "invertkey": lambda a: _lazy("texttools", "invertkey", a),
    "bam2sam": lambda a: _lazy("texttools", "bam2sam", a),
    "bamlinestreamer": lambda a: _lazy("texttools", "bam2sam", a),
    "streamsam": lambda a: _lazy("texttools", "bam2sam", a),
    # A8b group 4, the last of the long tail. On the device: postfilter
    # (BBMap, B4), reassemble (Tadpole's load) and the cardinality
    # harness (LogLog); the rest is host code copied from the JAX package
    "postfilter": lambda a: _lazy("research", "postfilter_main", a),
    "reassemble": lambda a: _lazy("research", "reassemble_main", a),
    "fll2simulate": lambda a: _lazy("research", "cardinality_sim_main", a, "fll2"),
    "ttllsimulate": lambda a: _lazy("research", "cardinality_sim_main", a, "ttll"),
    "dlctieraccuracy": lambda a: _lazy("research", "cardinality_sim_main", a, "dlctier"),
    "trainlchist": lambda a: _lazy("research", "cardinality_sim_main", a, "lchist"),
    "mantissacompare": lambda a: _lazy("research", "cardinality_sim_main", a, "mantissa"),
    "lowcomplexcalibrate": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "lowcomplex"),
    # the ddl sketch pipeline and the binning and log-collating research launchers
    "ddlwriter": lambda a: _lazy("research", "ddlwriter_main", a),
    "ddlmerger": lambda a: _lazy("research", "ddlmerger_main", a),
    "ddlcompare": lambda a: _lazy("research", "ddlcompare_main", a),
    "ddlblacklist": lambda a: _lazy("research", "ddlblacklist_main", a),
    "ddlcalibrate": lambda a: _lazy("research", "ddlcalibrate_main", a),
    "rankingvectorizer": lambda a: _lazy("research", "rankingvectorizer_main", a),
    "covmaker": lambda a: _lazy("research", "covmaker_main", a),
    "makequickbinvector": lambda a: _lazy("research", "makequickbinvector_main", a),
    "matrixtocolumns": lambda a: _lazy("research", "matrixtocolumns_main", a),
    "bloomfilterparser": lambda a: _lazy("research", "bloomfilterparser_main", a),
    "processfrag": lambda a: _lazy("research", "processfrag_main", a),
    # binning, gene calling and its models, scaffolding, consensus
    "quickbin": _quickbin,
    "gradebins": lambda a: _lazy("gradebins", "main", a),
    "callgenes": _callgenes,
    "analyzegenes": lambda a: _lazy("pgmtrain", "analyzegenes_main", a),
    "mergepgm": lambda a: _lazy("pgmtrain", "mergepgm_main", a),
    "consensus": _consensus,
    "consensusmaker": _consensus,
    "lilypad": _lilypad,
    "fixgaps": lambda a: _lazy("fixgaps", "main", a),
    "fungalrelease": lambda a: _lazy("fungalrelease", "main", a),
    "bbcrisprfinder": lambda a: _lazy("crispr", "main", a),
    # read and contig odds and ends
    "randomreads": _randomreads,
    "crosscontaminate": _crosscontaminate,
    "makecontaminatedgenomes": _makecontaminated,
    "countduplicates": lambda a: _lazy("misctools", "countduplicates", a),
    "commonkmers": lambda a: _lazy("misctools", "commonkmers", a),
    "kmerposition": lambda a: _lazy("misctools", "kmerposition", a),
    "mergebarcodes": lambda a: _lazy("misctools", "mergebarcodes", a),
    "removesmartbell": lambda a: _lazy("misctools", "removesmartbell", a),
    "filtersubs": lambda a: _lazy("misctools", "filtersubs", a),
    "consect": lambda a: _lazy("misctools", "consect", a),
    "mergeotus": lambda a: _lazy("misctools", "mergeotus", a),
    "mergefastacontigs": lambda a: _lazy("misctools", "mergefastacontigs", a),
    "partitionfastafile": lambda a: _lazy("misctools", "partitionfastafile", a),
    # SAM, VCF and GFF tools
    "dedupebymapping": lambda a: _lazy("samutils", "dedupebymapping", a),
    "mergesam": lambda a: _lazy("samutils", "mergesam", a),
    "mergesam2": lambda a: _lazy("samutils", "mergesam", a),
    "samtoest": lambda a: _lazy("samutils", "samtoest", a),
    "bbest": lambda a: _lazy("samutils", "samtoest", a),
    "samtoroc": lambda a: _lazy("samutils", "samtoroc", a),
    "splitsam": lambda a: _lazy("samutils", "splitsam", a),
    "splitsam4way": lambda a: _splitsam_n(a, 4),
    "splitsam6way": lambda a: _splitsam_n(a, 6),
    "invertvcf": lambda a: _lazy("vcftools", "invertvcf", a),
    "filtervcf": lambda a: _lazy("vcftools", "filtervcf", a),
    "applyvariants": lambda a: _lazy("vcftools", "applyvariants", a),
    "vcf2gff": lambda a: _lazy("vcftools", "vcf2gff", a),
    "gbff2gff": lambda a: _lazy("gfftools", "gbff2gff", a),
    "cutgff": lambda a: _lazy("gfftools", "cutgff", a),
    "comparegff": lambda a: _lazy("gfftools", "comparegff", a),
    # protein search and marker genes, scalar summaries
    "proteinsearch": lambda a: _lazy("prottools", "proteinsearch_main", a),
    "clusterproteins": lambda a: _lazy("prottools", "clusterproteins_main", a),
    "markerfactory": lambda a: _lazy("prottools", "markerfactory_main", a),
    "markervector": lambda a: _lazy("prottools", "markervector_main", a),
    "magqc": lambda a: _lazy("prottools", "magqc_main", a),
    "scalars": lambda a: _lazy("scalartools", "scalars_main", a),
    "scalarintervals": lambda a: _lazy("scalartools", "scalarintervals_main", a),
    "cloudplot": lambda a: _lazy("scalartools", "cloudplot_main", a),
}


#: flag names that name INPUT files (never treated as outputs below)
_INPUT_KEYS = frozenset({
    "in", "in1", "in2", "ref", "extra", "sam", "invcf", "vcfin", "vcf0",
    "input", "literal", "adapters", "barcodes", "names", "tree", "table",
    "gi", "accession", "config", "net", "netfile", "model", "sketch_in",
})

#: output values that never collide (stream/sink sentinels)
_SINK_VALUES = frozenset({"stdout", "stderr", "null", "/dev/null", "-"})


def guard_output_files(argv: list[str]):
    """Universal output-collision pre-check, applied to EVERY tool before
    dispatch — the reference calls shared/Tools.testOutputFiles in every
    tool's setup (e.g. bbduk/BBDukS.java:185); centralizing it here gives
    all 315 launchers the contract at once. Checks: duplicate output
    paths, outputs shadowing inputs, and existing files unless
    overwrite=t (ow). Tools with richer local checks still run them."""
    import os

    pairs = []
    for tok in argv:
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        pairs.append((k.strip().lower().lstrip("-"), v.strip()))
    overwrite = True
    for k, v in pairs:
        if k in ("overwrite", "ow"):
            overwrite = v.lower() in ("t", "true", "1", "yes", "y", "")
    ins = set()
    outs = []
    for k, v in pairs:
        if not v or v.lower() in _SINK_VALUES or v.lower().startswith(
            "stdout."
        ):
            continue
        # boolean-valued out* flags (e.g. enable toggles) are not paths
        if v.lower() in ("t", "f", "true", "false"):
            continue
        if k in _INPUT_KEYS:
            for p in v.split(","):
                if p:
                    ins.add(os.path.abspath(p))
        elif k.startswith("out"):
            # demux-style patterned outputs (out=%.fq) expand per key and
            # cannot collide statically
            if "%" in v or "#" in v:
                continue
            for p in v.split(","):
                if p:
                    outs.append(p)
    seen = {}
    for p in outs:
        ap = os.path.abspath(p)
        if ap in seen:
            raise ValueError(f"Duplicate output file: {p}")
        seen[ap] = p
        if ap in ins:
            raise ValueError(f"Output file {p} is also an input")
        if os.path.exists(p) and not overwrite:
            raise ValueError(
                f"Output file {p} exists; use overwrite=t (ow) to replace"
            )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("bbtools_torch — PyTorch/CUDA port of bbtools_tpu")
        print("usage: python -m bbtools_torch <tool> key=value ... [device=cuda|cpu]")
        print("tools:", ", ".join(sorted(TOOLS)))
        return 0
    tool = argv[0].lower().removesuffix(".sh")
    fn = TOOLS.get(tool)
    if fn is None:
        raise NotImplementedError(
            f"bbtools_torch: unknown tool {tool!r}; "
            f"tools: {', '.join(sorted(TOOLS))}"
        )
    # several processes: MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK (torchrun's
    # variables) join this process into a gloo group before any tool runs;
    # each process then reads its own input and the tools merge what is
    # global (parallel/distributed.py)
    if os.environ.get("WORLD_SIZE"):
        from .parallel.distributed import initialize, rank, world_size

        if initialize():
            print(
                f"Joined torch.distributed process group: process "
                f"{rank()}/{world_size()}, backend gloo",
                file=sys.stderr,
            )
    guard_output_files(argv[1:])
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
