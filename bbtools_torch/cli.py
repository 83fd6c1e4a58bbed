"""Unified CLI of the port — the `tool.sh key=value` surface:
python -m bbtools_torch <tool> key=value ...

Only the tools ported so far are here; any other name raises, naming the
ROADMAP item that holds it.
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
}

#: tools that the ported Tadpole, CallVariants and MSA fill unblock, queued
#: next (ROADMAP A6b); any other unported name is the long tail (A8)
A6B_TOOLS = {"bbrealign", "bbcms", "tadpipe", "tadwrapper", "tadpolewrapper"}


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
        item = "A6b" if tool in A6B_TOOLS else "A8"
        raise NotImplementedError(
            f"bbtools_torch: tool {tool!r} is not ported (ROADMAP {item}); "
            f"ported tools: {', '.join(sorted(TOOLS))}"
        )
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
