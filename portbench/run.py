#!/usr/bin/env python3
"""The benchmark of bbtools_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. One process runs one cell of BENCHMARK.json:
set-up (CUDA, the kernels, the inputs from the seed, the tool and one
warm-up job), then jobs back to back for --seconds, then the comparison
of what the last job wrote with the plain reference under
portbench/reference/. The last line of standard output is the result as
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error. With --trace 1 the per-layer metrics are
reported, read from spans around the tool's calls over the window and
from a torch.profiler trace of one more job after it.

Exits non-zero without a result when CUDA is missing or has fewer cards
than the cell asks for, or when the JAX package or JAX is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build and kernel caches at fixed paths inside the checkout, so only a
#: checkout's first run builds
CACHE = os.path.join(ROOT, "portbench", "_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="run the configuration's control flags of this name (limit readings only)")
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell = harness.resolve(args.workload)
    need = int(cell.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        print(f"portbench: card {smi[0] if smi else 'unknown'}", file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired):
        print("portbench: nvidia-smi not available", file=sys.stderr)

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START, control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
