"""Unified CLI of the port — the `tool.sh key=value` surface:
python -m bbtools_torch <tool> key=value ...

Only the tools ported so far are here; any other name raises, naming the
ROADMAP item that holds it (A8, the long tail).
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


def _mappacbio(args):
    from .models.bbmap import main

    return main(args, preset="pacbio")


def _bbmapskimmer(args):
    from .models.bbmap import main

    return main(args, preset="skimmer")


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
    # the long-read presets raise, naming ROADMAP A4b
    "mappacbio": _mappacbio,
    "bbmapskimmer": _bbmapskimmer,
    "mappacbioskimmer": _bbmapskimmer,
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
}


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
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
