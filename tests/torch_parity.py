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
