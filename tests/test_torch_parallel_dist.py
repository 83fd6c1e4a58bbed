"""Two processes joined by a gloo process group (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK: the variables torchrun sets), each on its own input
shard: the port's counterpart of tests/test_multichip.py's two-process
tests. The global answers equal one process's on the whole input."""

import os
import socket
import subprocess
import sys

import numpy as np

from bbtools_torch.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JOIN_WORKER = r"""
import os, sys, tempfile

import torch
import torch.distributed as dist

from bbtools_torch.cli import main as cli_main
from bbtools_torch.parallel.distributed import (global_spectrum, global_sum_array,
                                                initialize, rank, world_size)

assert initialize(), "initialize() returned False with WORLD_SIZE=2"
assert initialize()  # a second join is a no-op
assert world_size() == 2 and dist.get_backend() == "gloo"
total = int(global_sum_array([rank() + 1] * 8).sum())
print("DIST_TOTAL=%d" % total)
keys = [[3, 5, 9], [5, 7]][rank()]
k, c = global_spectrum(keys, [1] * len(keys))
print("DIST_SPECTRUM=%s" % ",".join("%d:%d" % kc for kc in zip(k, c)))
# a tool inside the group
with tempfile.TemporaryDirectory() as td:
    with open(os.path.join(td, "r.fq"), "w") as f:
        for i in range(50):
            f.write("@r%d\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n+\n" % i + "F" * 36 + "\n")
    cli_main(["kmercountexact", "in=%s/r.fq" % td, "k=31", "khist=%s/h.txt" % td,
              "device=cpu"])
    nlines = len(open(os.path.join(td, "h.txt")).read().splitlines())
print("DIST_TOOL_OK=%d" % (nlines > 1))
"""

_GLOBAL_WORKER = r"""
import os
from bbtools_torch.cli import main as cli_main

pid = int(os.environ["RANK"])
shared = os.environ["DIST_SHARED"]
# each process reads ITS OWN input shard; the tools give ONE global answer
cli_main(["kmercountexact", "in=%s/shard%d.fq" % (shared, pid), "k=31",
          "khist=%s/khist_p%d.txt" % (shared, pid), "dump=%s/dump_p%d.fa" % (shared, pid),
          "device=cpu"])
cli_main(["bbduk", "in=%s/shard%d.fq" % (shared, pid), "out=%s/out_p%d.fq" % (shared, pid),
          "literal=AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", "k=23", "mink=11", "hdist=1",
          "ktrim=r", "minlen=40", "stats=%s/stats_p%d.txt" % (shared, pid), "device=cpu"])
print("GLOBAL_OK")
"""


def _run_two(tmp_path, source: str, extra_env=None, timeout=240):
    """The worker in two processes of one group on a free localhost port;
    returns their stdout and stderr."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(source)
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(pid),
                   OMP_NUM_THREADS="1", **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, (out.decode(), err.decode()[-3000:])
            outs.append((out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_processes_join_over_gloo(tmp_path):
    """Both join one gloo group, sum over it, merge their spectra into
    the same global one, and run a tool inside the group; the CLI says
    that it joined."""
    outs = _run_two(tmp_path, _JOIN_WORKER)
    for out, err in outs:
        assert "DIST_TOTAL=24" in out  # 8 cells of 1 + 8 cells of 2
        assert "DIST_SPECTRUM=3:1,5:2,7:1,9:1" in out
        assert "DIST_TOOL_OK=1" in out
        assert "Joined torch.distributed process group: process" in err


def test_two_processes_global_result_equals_concat(tmp_path):
    """Two processes, each reading its own half: kmercountexact's khist
    and dump on each equal one process's on the whole input (the all-T
    31-mer of a poly-T read included); the BBDuk outputs in rank order
    equal its output, and the stats equal but for the #File line."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    reads = []
    for i in range(400):
        seq = bytearray(acgt[rng.integers(0, 4, 120)].tobytes())
        if i % 3 == 0:
            p = int(rng.integers(50, 100))
            ins = adapter[: 120 - p]
            seq[p : p + len(ins)] = ins
        if i == 7:
            seq[10:60] = b"T" * 50
        reads.append(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), b"F" * 120))
    (tmp_path / "all.fq").write_bytes(b"".join(reads))
    (tmp_path / "shard0.fq").write_bytes(b"".join(reads[:200]))
    (tmp_path / "shard1.fq").write_bytes(b"".join(reads[200:]))
    cli_main(["kmercountexact", f"in={tmp_path}/all.fq", "k=31",
              f"khist={tmp_path}/khist_ref.txt", f"dump={tmp_path}/dump_ref.fa", "device=cpu"])
    cli_main(["bbduk", f"in={tmp_path}/all.fq", f"out={tmp_path}/out_ref.fq",
              "literal=" + adapter.decode(), "k=23", "mink=11", "hdist=1", "ktrim=r",
              "minlen=40", f"stats={tmp_path}/stats_ref.txt", "device=cpu"])
    outs = _run_two(tmp_path, _GLOBAL_WORKER, {"DIST_SHARED": str(tmp_path)})
    assert all("GLOBAL_OK" in out for out, _ in outs)

    def rb(name):
        return (tmp_path / name).read_bytes()

    assert b"T" * 31 in rb("dump_ref.fa")
    for pid in range(2):
        assert rb(f"khist_p{pid}.txt") == rb("khist_ref.txt")
        assert rb(f"dump_p{pid}.fa") == rb("dump_ref.fa")
    assert rb("out_p0.fq") + rb("out_p1.fq") == rb("out_ref.fq")

    def norm(name):
        return [ln for ln in rb(name).splitlines() if not ln.startswith(b"#File")]

    assert norm("stats_ref.txt")
    for pid in range(2):
        assert norm(f"stats_p{pid}.txt") == norm("stats_ref.txt")
