"""BBDuk's `profile=` in the port against the JAX package's, on the CPU
(tests/test_tools.py's `test_phase_timer_and_profile_flag`, end to end):
out=, stats= and stderr (its clocks and rates masked, the trace
directory named as given) equal the JAX package's run with profile=;
the directory holds the port's torch.profiler trace, and the port's
files equal its own run without profile=."""

import json
import os
import re

import numpy as np
import pytest

from torch_parity import run_both, warm_native_codecs  # noqa: F401  (autouse)

from bbtools_torch.cli import main as tmain
from bbtools_torch.utils.timer import device_events, device_profile, trace_path

ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
COMMON = ["k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"]
PANELS = {"one_adapter": [f"literal={ADAPTER.decode()}"], "adapters": ["ref=adapters"]}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """120 reads of 100 bp, every third with the adapter from base 67."""
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(120):
        s = acgt[rng.integers(0, 4, 100)].copy()
        if i % 3 == 0:
            s[67:] = np.frombuffer(ADAPTER, np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 100))
    path = tmp_path_factory.mktemp("prof") / "in.fq"
    path.write_bytes(b"".join(recs))
    return str(path)


def _mask_rates(text):
    return re.sub(r"\t\S+ (reads|bases)/sec", r"\tR \1/sec", text)


@pytest.mark.parametrize("panel", list(PANELS))
def test_profile_equals_jax_and_writes_a_trace(tmp_path, monkeypatch, reads, panel):
    monkeypatch.chdir(tmp_path)
    argv = [f"in={reads}", "out={d}.fq", "stats={d}.stats.txt", *PANELS[panel], *COMMON,
            "profile={d}_prof"]
    outs = ("{d}.fq", "{d}.stats.txt")
    res = run_both("bbduk", argv, outs=outs)
    for o, j, t in zip(outs, res["jax"][0], res["torch"][0]):
        assert j == t, f"{o} differs"
    assert _mask_rates(res["jax"][1]) == _mask_rates(res["torch"][1])
    assert "Device profile written to {d}_prof\n" in res["torch"][1]
    # the port's trace: a Chrome/Kineto JSON of the run's torch ops, in the
    # file of rank 0
    trace = trace_path("torch_prof")
    assert os.listdir("torch_prof") == [os.path.basename(trace)]
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    assert len(events) > 10 and not device_events(trace)  # a CPU run: no card
    # the same bytes without profile=
    tmain(["bbduk", f"in={reads}", "out=plain.fq", "stats=plain.stats.txt", *PANELS[panel],
           *COMMON, "device=cpu"])
    assert open("plain.fq", "rb").read() == res["torch"][0][0]
    assert open("plain.stats.txt", "rb").read() == res["torch"][0][1]


@pytest.mark.parametrize("flag", ["f", "false"])
def test_profile_off_writes_nothing(tmp_path, monkeypatch, reads, flag):
    monkeypatch.chdir(tmp_path)
    tmain(["bbduk", f"in={reads}", "out=o.fq", *PANELS["one_adapter"], *COMMON,
           f"profile={flag}", "device=cpu"])
    assert sorted(os.listdir(tmp_path)) == ["o.fq"]


def test_device_profile_without_a_path_is_a_no_op(tmp_path):
    with device_profile(None, "cuda"):
        pass
    with device_profile("", "cpu"):
        pass
    assert not os.listdir(tmp_path)


def test_kernel_table_sums_the_kernel_events(tmp_path):
    """The trace's device events, and its kernel table: launches and
    microseconds summed by kernel name, the most time first."""
    from bbtools_torch.utils.timer import kernel_table

    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "cummax_one_pass_kernel", "dur": 12.5},
        {"cat": "cpu_op", "name": "aten::sort", "dur": 40.0},
        {"cat": "kernel", "name": "lane_lookup_shared_kernel", "dur": 30.0},
        {"cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.0},
        {"cat": "kernel", "name": "cummax_one_pass_kernel", "dur": 12.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 3.0},
    ]}))
    assert [e["cat"] for e in device_events(str(trace))] == ["kernel", "kernel",
                                                             "gpu_memset", "kernel"]
    assert kernel_table(str(trace)) == [("lane_lookup_shared_kernel", 1, 30.0),
                                        ("cummax_one_pass_kernel", 2, 24.5)]
