"""Helpers of the port's CPU parity tests of the last device-using tools
(tests/test_torch_{findprimers,indelfree,cmstools,mltools,calibrate}.py):
both CLIs on the same argv, their files and stderr compared."""

import contextlib
import fcntl
import io
import os
import re
import tempfile

import pytest

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain

CLIS = (("jax", jmain, []), ("torch", tmain, ["device=cpu"]))


def run_both(tool, argv, outs=(), stdout=False):
    """Run argv through both CLIs (outputs named {d}); returns {d: (files,
    stderr with its seconds masked and the argv's paths named as given,
    stdout)}."""
    res = {}
    for d, cli, extra in CLIS:
        err, out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            cli([tool, *(x.format(d=d) for x in argv), *extra])
        text = re.sub(r"Time:\s+\S+", "Time: T", err.getvalue())
        for x in argv:
            text = text.replace(x.format(d=d).split("=")[-1], x.split("=")[-1])
        res[d] = ([open(o.format(d=d), "rb").read() for o in outs], text,
                  out.getvalue() if stdout else "")
    return res


def assert_equal(res, outs=()):
    """Each file, stderr and stdout of the two runs equal."""
    for o, j, t in zip(outs, res["jax"][0], res["torch"][0]):
        assert j == t, f"{o} differs"
    assert res["jax"][1] == res["torch"][1], "stderr differs"
    assert res["jax"][2] == res["torch"][2], "stdout differs"


@pytest.fixture(autouse=True, scope="module")
def warm_native_codecs():
    """Both packages' native FASTQ codecs built and loaded before any
    case. A first use prints to stderr once a process when the build
    fails, and the JAX package's build writes one temp name shared by all
    processes, so test processes that start together with a fresh TMPDIR
    race on it; inside `run_both` that line would land in one side's
    captured stderr only. The lock makes the builds take turns."""
    from bbtools_torch import native as tnative
    from bbtools_tpu import native as jnative

    lock = os.path.join(tempfile.gettempdir(), "bbtools_native_build.lock")
    with open(lock, "w") as fh, contextlib.redirect_stderr(io.StringIO()):
        fcntl.flock(fh, fcntl.LOCK_EX)
        jnative.get_lib()
        tnative.get_lib()


def capture(cli, argv):
    """Run cli(argv) with stdout and stderr captured as text, the tools'
    byte writes (sys.stdout.buffer) included, in the order written."""
    out_b, err_b = io.BytesIO(), io.BytesIO()
    out = io.TextIOWrapper(out_b, encoding="utf-8", write_through=True)
    err = io.TextIOWrapper(err_b, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli(argv)
    return (out_b.getvalue().decode(errors="replace"),
            err_b.getvalue().decode(errors="replace"))


def file_tree(root):
    """{relative path: content} of every file under root; a .npz file's
    content is its arrays (its zip entries carry the time of writing), a
    .gz file's its decompressed bytes (its header carries that time)."""
    import gzip

    import numpy as np

    tree = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path, allow_pickle=False) as z:
                    tree[rel] = sorted((k, z[k].dtype.str, z[k].shape, z[k].tobytes())
                                       for k in z.files)
            else:
                with (gzip.open if f.endswith(".gz") else open)(path, "rb") as fh:
                    tree[rel] = fh.read()
    return tree


def run_host_both(tool, argv, inputs, tmp_path, device=False, masks=(), prepare=None):
    """Run argv ({i} the inputs, {o} the side's output directory) through
    both CLIs; the port gets device=cpu where the tool does device work.
    Returns {side: (stdout, stderr, files)}, with the side's directory
    named O (in the streams and in the files) and each (pattern,
    replacement) of masks applied to the standard streams. prepare(o),
    where given, fills each side's directory before its run."""
    res = {}
    for d, cli, extra in CLIS:
        o = tmp_path / d
        o.mkdir()
        if prepare is not None:
            prepare(o)
        out, err = capture(cli, [tool, *(a.format(i=inputs, o=o) for a in argv),
                                 *(extra if device else [])])
        texts = []
        for t in (out, err):
            t = t.replace(str(o), "O")
            for pat, rep in masks:
                t = re.sub(pat, rep, t)
            texts.append(t)
        files = {rel: c.replace(str(o).encode(), b"O") if isinstance(c, bytes) else c
                 for rel, c in file_tree(o).items()}
        res[d] = (*texts, files)
    return res
