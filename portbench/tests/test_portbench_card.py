"""One short run of each cell through run.py on the card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.read_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          workload, "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
