"""Unified CLI of the port — the `tool.sh key=value` surface:
python -m bbtools_torch <tool> key=value ...

The tools ported so far are registered in TOOLS, each running on the
card unless given device=cpu (the host-only ones, stats, pileup,
calctruequality, gradesam, reformatpb and the host aligner launchers,
run anywhere). A name not in TOOLS raises, naming the ROADMAP item that
holds it (A8, the long tail). Before any tool runs, `guard_output_files`
refuses duplicate outputs, an output that is also an input, and an
existing output under ow=f.
"""

from __future__ import annotations

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
            f"bbtools_torch: tool {tool!r} is not ported (ROADMAP A8); "
            f"ported tools: {', '.join(sorted(TOOLS))}"
        )
    guard_output_files(argv[1:])
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
