"""The port's central output guard (`cli.guard_output_files`, ROADMAP
C3) against tests/test_crispr_cbcl.py's contract: duplicate outputs, an
output that is also an input, and an existing output under ow=f are
refused before any tool runs, for every name in the port's TOOLS; sinks
and boolean flags never trip it; the key sets are the JAX package's."""

import os
import subprocess
import sys

import pytest

from bbtools_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guard_key_sets_are_the_jax_packages():
    from bbtools_tpu import cli as jcli

    assert tcli._INPUT_KEYS == jcli._INPUT_KEYS
    assert tcli._SINK_VALUES == jcli._SINK_VALUES


def test_guard_refuses_the_three_violations(tmp_path):
    inp = tmp_path / "in.fq"
    inp.write_text("@r\nACGT\n+\nFFFF\n")
    with pytest.raises(ValueError, match="[Dd]uplicate"):
        tcli.guard_output_files([f"in={inp}", "out=x.fq", "out2=x.fq"])
    with pytest.raises(ValueError, match="also an input"):
        tcli.guard_output_files([f"in={inp}", f"out={inp}"])
    exists = tmp_path / "e.fq"
    exists.write_text("")
    with pytest.raises(ValueError, match="exists"):
        tcli.guard_output_files([f"in={inp}", f"out={exists}", "ow=f"])
    tcli.guard_output_files([f"in={inp}", f"out={exists}", "ow=t"])
    tcli.guard_output_files([f"in={inp}", f"out={exists}"])  # overwrite is the default


def test_guard_lets_sinks_and_flags_through(tmp_path):
    tcli.guard_output_files(["out=stdout.fq", "outm=t", "out2=null"])
    tcli.guard_output_files(["in=a.fq", "out=-", "outu=stderr", "outd=/dev/null"])
    tcli.guard_output_files(["in=a.fq", "out=o_%.fq", "out2=o_%.fq"])  # patterned
    tcli.guard_output_files(["in=a.fq", "outmatched=f", "ordered"])


def test_every_tool_refuses_its_input_as_output(tmp_path):
    """Each registered name raises before its tool body runs: the input
    stays byte for byte and no file appears."""
    inp = tmp_path / "in.fq"
    inp.write_text("@r\nACGT\n+\nFFFF\n")
    before = sorted(os.listdir(tmp_path))
    checked = 0
    for name in sorted(set(tcli.TOOLS)):
        with pytest.raises(ValueError, match="also an input"):
            tcli.main([name, f"in={inp}", f"out={inp}", "device=cpu"])
        checked += 1
    assert checked == len(set(tcli.TOOLS)) >= 343
    assert inp.read_text() == "@r\nACGT\n+\nFFFF\n" and sorted(os.listdir(tmp_path)) == before


def test_kmercountexact_does_not_overwrite_its_input(tmp_path):
    """The fault as it was reproduced: `python -m bbtools_torch
    kmercountexact in=s.fq out=s.fq k=21 device=cpu` replaced s.fq."""
    fq = tmp_path / "s.fq"
    data = b"@r\n" + b"ACGTTGCAAGGCTTACCGATACGT" * 2 + b"\n+\n" + b"I" * 48 + b"\n"
    fq.write_bytes(data)
    res = subprocess.run([sys.executable, "-m", "bbtools_torch", "kmercountexact",
                          f"in={fq}", f"out={fq}", "k=21", "device=cpu"],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode != 0 and "ValueError" in res.stderr and "also an input" in res.stderr
    assert fq.read_bytes() == data
