"""Unified CLI of the port — the `tool.sh key=value` surface:
python -m bbtools_torch <tool> key=value ...

Only the tools ported so far are here; any other name raises, naming the
ROADMAP items that still hold the rest of the JAX package's tools.
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
            f"bbtools_torch: tool {tool!r} is not ported (ROADMAP A3-A8); "
            f"ported tools: {', '.join(sorted(TOOLS))}"
        )
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
