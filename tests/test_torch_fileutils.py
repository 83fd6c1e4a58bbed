"""The file and launcher utilities, the graders of graders2 and the
launcher aliases of A8b on the CPU: each launcher name of the port
against the JAX package's on the same seeded inputs, one case a name
(the 22 fileutils names, gradevcf, comparevcf, grademerge, grademerged,
grademergedreads, bbdukold, bbstats, stats3, bbversion). Every output
file, the standard output and the standard error are equal byte for
byte, with these masks, each a clock reading or a property of the host:

- filescan's MB/s, stream's and samstreamer's reads/s and Mbases/s,
  diskbench's write and read MB/s, testfilesystem's create/stat/delete
  microseconds;
- printtime's stamp (milliseconds since the epoch) and its elapsed
  seconds;
- calcmem's and memdetect's available and suggested megabytes, which
  change between two calls;
- profile's cProfile table (function names, paths, call counts and
  seconds) and its .prof file, which name each package's own code; the
  profiled tool's outputs are compared whole;
- bbdukold's (BBDuk's) seconds and its reads/s and bases/s rates;
- bbversion's package name.

javasetup is held to its own expected lines (python's, numpy's and
torch's versions and the CUDA devices torch sees), not to the JAX
package's, which reports JAX. bbdukold runs BBDuk, which takes
device=cpu in the port."""

import gzip
import os
import platform
import re
import stat

import numpy as np
import pytest
import torch

from torch_parity import capture, run_host_both, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: tools that do device work (the port's run takes device=cpu)
DEVICE = ("bbdukold",)


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 47."""
    d = tmp_path_factory.mktemp("fileutils_in")
    rng = np.random.default_rng(47)
    text = b"".join(b"line %d %s\n" % (i, _seq(rng, 10)) for i in range(40))
    (d / "lines.txt").write_bytes(text)
    (d / "x.txt.gz").write_bytes(gzip.compress(text[:200]))
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"
    reads = []
    for i in range(200):
        s = _seq(rng, 100)
        if i % 3 == 0:
            p = int(rng.integers(30, 90))
            s = (s[:p] + adapter)[:100]
        reads.append(b"@r%d insert=%d\n%s\n+\n%s\n" % (i, 100 - i % 4, s, b"F" * 100))
    (d / "reads.fq").write_bytes(b"".join(reads))
    (d / "merged.fq").write_bytes(b"".join(
        b"@m%d_insert%d\n%s\n+\n%s\n" % (i, 60 + i % 5 if i % 6 else 60, _seq(rng, 60 + i % 3),
                                          b"F" * (60 + i % 3)) for i in range(50))
        + b"@noinfo\nACGT\n+\nFFFF\n@p insert=7 x\nACGTACG\n+\nFFFFFFF\n")
    sam = [b"@SQ\tSN:c1\tLN:500"] + [
        b"r%d\t0\tc1\t%d\t60\t20M\t*\t0\t0\t%s\t%s" % (i, 1 + 10 * i, _seq(rng, 20), b"I" * 20)
        for i in range(30)]
    (d / "in.sam").write_bytes(b"\n".join(sam) + b"\n")
    contigs = [b">c%d\n%s\n" % (i, _seq(rng, int(rng.integers(200, 2000)))) for i in range(8)]
    (d / "contigs.fa").write_bytes(b"".join(contigs) + b">gappy\nACGTNNNNNNNNNNACGTACGT\n")
    (d / "time.log").write_bytes(b"running\nreal\t1m23.456s\nuser\t2m0.5s\nsys\t0m1.250s\n"
                                 b"real 1h2m3s\nnoise line\nuser bad\n")
    (d / "web.log").write_bytes(b"2020 http://a.org/x 200 12.5\nhttp://a.org/x\t503\t100.0\n"
                                b"http://b.org 301 7.25\ngarbage here\n\nhttps://c.net 200 1000\n")
    rep = (b"header\n|Taxonomy|SeqUnits|Reads|\n|Escherichia|3|1200|\n|Homo sapiens|1|5|\n"
           b"|TOTAL|4|1205|\n\n|Taxonomy|SeqUnits|Reads|\n|Phix|2|77|\n|TOTAL|2|77|\n")
    (d / "contam1.txt").write_bytes(rep)
    (d / "contam2.txt").write_bytes(rep.replace(b"1200", b"300").replace(b"Homo", b"Mus"))
    (d / "sk1.txt").write_bytes(b"Query\tRef\tWKID\tANI\tMatches\tSize\n"
                                b"q1\trefA\t41.50%\t97.20%\t415\t1000\nq1\trefB\t2.10%\t88.00%\t21\t1000\n"
                                b"q2\trefB\t77.00%\t99.10%\t770\t1000\n")
    (d / "sk2.txt").write_bytes(b"#Query\tRef\tANI\n"
                                b"q1\trefC\t45.00%\t97.60%\t450\t1000\nq3\trefA\t0.40%\t80.10%\t4\t1000\n")
    vcf_h = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    (d / "truth.vcf").write_text(vcf_h + "".join(
        f"s0\t{100 * i}\t.\tA\t{'T' if i % 2 else 'G,C'}\t50\tPASS\t.\n" for i in range(1, 20)))
    (d / "called.vcf").write_text(vcf_h + "".join(
        f"s0\t{100 * i}\t.\tA\t{'T' if i % 3 else 'G'}\t40\tPASS\t.\n" for i in range(1, 25))
        + "s0\t100\t.\tA\tT\t40\tPASS\t.\n")
    return d


def _shell_scripts(o):
    """Launcher scripts for fix_script_paths and addx."""
    for i, body in enumerate(('#!/bin/bash\nSCRIPT="$0"\necho x\n', "#!/bin/bash\necho y\n",
                              'SCRIPT="$0"\nSCRIPT="$0"\n')):
        p = o / f"tool{i}.sh"
        p.write_text(body)
        os.chmod(p, 0o644)
    (o / "notes.txt").write_text('SCRIPT="$0"\n')


#: name -> (argv with {i} the inputs and {o} the side's output directory,
#: masks of the standard streams, prepare)
RATE = r"[0-9.]+ (MB/s|reads/s|Mbases/s)"
CASES = {
    "unzip": (["{i}/x.txt.gz", "{o}/x.txt"], (), None),
    "cat": (["{i}/lines.txt", "{i}/x.txt.gz", "out={o}/cat.txt"], (), None),
    "copyfile": (["{i}/lines.txt", "{o}/copy.txt"], (), None),
    "textfile": (["{i}/lines.txt", "3", "7"], (), None),
    "filescan": (["in={i}/reads.fq"], [(RATE, "R")], None),
    "stream": (["in={i}/reads.fq"], [(RATE, "R")], None),
    "samstreamer": (["in={i}/in.sam"], [(RATE, "R")], None),
    "diskbench": (["path={o}", "size=3000000"], [(RATE, "R")], None),
    "testfilesystem": (["path={o}", "rounds=20"], [(r"[0-9.]+us", "Tus")], None),
    "a_sample_mt": (["in={i}/reads.fq", "out={o}/s.fq"], (), None),
    "calcmem": ([], [(r"Available: \d+ MB", "Available: A MB"), (r": \d+ MB$", ": B MB")],
                None),
    "memdetect": (["fraction=0.5"], [(r"Available: \d+ MB", "Available: A MB"),
                                     (r": \d+ MB$", ": B MB")], None),
    "fix_script_paths": (["path={o}"], (), _shell_scripts),
    "addx": (["dir={o}"], (), _shell_scripts),
    "zz_rename_package": ([], (), None),
    "processspeed": (["in={i}/time.log", "out={o}/speed.tsv"], (), None),
    "webcheck": (["in={i}/web.log", "out={o}/web.tsv", "outbad={o}/bad.txt"], (), None),
    "summarizecontam": (["{i}/contam1.txt", "{i}/contam2.txt", "out={o}/contam.tsv",
                         "minreads=10"], (), None),
    "analyzesketchresults": (["in={i}/sk1.txt,{i}/sk2.txt", "out={o}/ask.tsv"], (), None),
    "gradevcf": (["in={i}/called.vcf", "truth={i}/truth.vcf"], (), None),
    "comparevcf": (["vcf={i}/truth.vcf", "giab={i}/called.vcf"], (), None),
    "grademerge": (["in={i}/merged.fq"], (), None),
    "grademerged": (["in={i}/reads.fq"], (), None),
    "grademergedreads": (["in1={i}/merged.fq"], (), None),
    "bbdukold": (["in={i}/reads.fq", "out={o}/t.fq", "literal=AGATCGGAAGAGCACACGTCTG",
                  "k=19", "mink=11", "ktrim=r", "minlen=40", "stats={o}/stats.txt"],
                 [(r"Time:\s+\t[0-9.]+ seconds\.", "Time: T seconds."),
                  (r"[0-9.]+k reads/sec", "Rk reads/sec"), (r"[0-9.]+m bases/sec", "Rm bases/sec")],
                 None),
    "bbstats": (["in={i}/contigs.fa"], (), None),
    "stats3": (["in={i}/contigs.fa", "mingap=3"], (), None),
    "bbversion": ([], [(r"bbtools_t(pu|orch)", "PKG")], None),
}


@pytest.mark.parametrize("tool", list(CASES))
def test_host_tool_equals_jax(inputs, tmp_path, tool):
    argv, masks, prepare = CASES[tool]
    res = run_host_both(tool, argv, inputs, tmp_path, device=tool in DEVICE, masks=masks,
                        prepare=prepare)
    assert res["torch"] == res["jax"]
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"
    if tool == "addx":
        modes = {d: sorted((p.name, stat.S_IMODE(p.stat().st_mode))
                           for p in (tmp_path / d).iterdir()) for d in ("jax", "torch")}
        assert modes["torch"] == modes["jax"]
        assert ("tool0.sh", 0o755) in modes["torch"] and ("notes.txt", 0o644) in modes["torch"]


def test_printtime_equals_jax(tmp_path):
    """printtime writes its stamp, then on a second call prints the
    seconds since it and writes it anew: the same lines from both
    packages, the stamp and the seconds masked."""
    from bbtools_torch.cli import main as tmain
    from bbtools_tpu.cli import main as jmain

    seen = {}
    for d, cli in (("jax", jmain), ("torch", tmain)):
        stamp = tmp_path / f"{d}.stamp"
        first = capture(cli, ["printtime", str(stamp)])
        stamp.write_text(str(int(stamp.read_text()) - 1500))
        second = capture(cli, ["printtime", str(stamp), "t"])
        third = capture(cli, ["printtime"])
        assert 1.5 <= float(second[0].split("\t")[1]) < 600
        seen[d] = [first, tuple(re.sub(r"Elapsed:\t[0-9.]+", "Elapsed:\tE", t) for t in second),
                   tuple(t.split("\t")[0] for t in third), stamp.read_text().isdigit()]
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == ("Elapsed:\tE\n", "Elapsed:\tE\n") and seen["torch"][3]


def test_profile_equals_jax(inputs, tmp_path):
    """profile runs a tool of its own package under cProfile: the tool's
    outputs are equal, each side writes its .prof and names it."""
    res = run_host_both("profile", ["countgc", "in={i}/contigs.fa", "out={o}/gc.txt",
                                    "profile={o}/p.prof"], inputs, tmp_path,
                        masks=[(r"(?s)\s*\d+ function calls.*?(?=Profile written)", "\nTABLE\n")])
    for d in ("jax", "torch"):
        assert len(res[d][2].pop("p.prof")) > 100
    assert res["torch"] == res["jax"]
    assert "Overall GC:" in res["torch"][1] and "TABLE\nProfile written to O/p.prof" in res["torch"][1]


def test_javasetup_prints_torch_and_its_devices():
    """javasetup reports python, numpy, torch and the CUDA devices torch
    sees; nothing of JAX."""
    from bbtools_torch.cli import main as tmain

    out, err = capture(tmain, ["javasetup"])
    n = torch.cuda.device_count()
    want = [f"python\t{platform.python_version()}", f"numpy\t{np.__version__}",
            f"torch\t{torch.__version__}",
            f"devices\t{n}" if n else "devices\tnone (no CUDA device)"]
    want += [f"cuda:{i}\t{torch.cuda.get_device_name(i)}" for i in range(n)]
    assert out.splitlines() == want and err == ""
    assert "jax" not in out.lower()


def test_graders2_library_equals_jax(inputs):
    """tests/test_tools.py's graders2 case at a small size: the VCF grade
    (the marking contract) and the insert parsed from read names."""
    from bbtools_torch.utils import graders2 as t
    from bbtools_tpu.utils import graders2 as j

    gt = t.grade_vcf(str(inputs / "called.vcf"), str(inputs / "truth.vcf"))
    gj = j.grade_vcf(str(inputs / "called.vcf"), str(inputs / "truth.vcf"))
    assert (gt.tp, gt.fp, gt.fn, gt.f1) == (gj.tp, gj.fp, gj.fn, gj.f1) == (10, 14, 18, gj.f1)
    for name in (b"r5_scaf0_pos7_strand0_insert240", b"pair insert=311 x", b"noinfo",
                 b"m3_insert61", b"x insert= 5"):
        assert t.parse_insert(name) == j.parse_insert(name)
