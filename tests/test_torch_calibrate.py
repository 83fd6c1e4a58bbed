"""The port's calibrate (`models/research.py` `calibrate_main`) against the
JAX package's on the CPU, in the case of tests/test_research.py
(test_calibrate_recovers_monotone_fit) and at other sizes, learning
rates and epochs. The fit is gradient descent in float64 with float32
parameters in both packages, but XLA's and torch's float64 sums run in
other orders, so the printed constants are held within CAL_TOL of the
JAX package's (one unit of their fifth decimal) and the mse within
MSE_TOL (one unit of its sixth). A CPU dry run (`tools/a8c_dryrun.py
--only calibrate`) printed the same line on both packages at 500 rows
(1,200 epochs) and at the chip smoke's 100,000 rows (2,000 epochs)."""

import numpy as np
import pytest

from torch_parity import run_both, warm_native_codecs  # noqa: F401

#: the largest difference of a printed constant (a, b, K, c)
CAL_TOL = 1e-5
#: the largest difference of the printed mse
MSE_TOL = 1e-6


def _rows(path, n, seed, slope=2.0, shift=0.5):
    """tests/test_research.py's rows: labels drawn from a logistic curve
    of the score's logit."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.02, 0.98, n)
    p = 1.0 / (1 + np.exp(-(slope * np.log(x / (1 - x)) + shift)))
    y = (rng.random(n) < p).astype(float)
    path.write_text("#score\tlabel\n" + "".join(f"{a:.5f}\t{b:.0f}\n" for a, b in zip(x, y)))


def _fields(line):
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split())}


@pytest.mark.parametrize("n,seed,flags", [(500, 0, ["epochs=1200"]),
                                          (2000, 3, ["epochs=300", "lr=0.2"]),
                                          (800, 5, [])])
def test_calibrate_within_tolerance_of_jax(tmp_path, n, seed, flags):
    src = tmp_path / "cal.tsv"
    _rows(src, n, seed)
    outs = [f"{tmp_path}/c.{{d}}.txt"]
    res = run_both("calibrate", [f"in={src}", f"out={outs[0]}", *flags], outs, stdout=True)
    got = {d: _fields(res[d][0][0].decode()) for d in res}
    for d in res:
        assert res[d][0][0].decode() == res[d][2]  # the line printed is the line written
    assert set(got["torch"]) == {"a", "b", "K", "c", "mse"}
    for k in ("a", "b", "K", "c"):
        assert abs(got["jax"][k] - got["torch"][k]) <= CAL_TOL, (k, got)
    assert abs(got["jax"]["mse"] - got["torch"]["mse"]) <= MSE_TOL
    if flags == ["epochs=1200"]:  # test_research's own bounds
        assert got["torch"]["mse"] < 0.2 and got["torch"]["a"] > 0.5


def test_calibrate_fit_keeps_float32_parameters():
    """The parameters stay float32 through the update (the JAX package's
    jnp.float32 under x64), while the loss is float64."""
    from bbtools_torch.models.research import calibrate_fit

    rng = np.random.default_rng(1)
    x = rng.uniform(0.05, 0.95, 200)
    y = (rng.random(200) < x).astype(float)
    p, mse = calibrate_fit(x, y, 50, 0.05, "cpu")
    assert {k: v.dtype for k, v in p.items()} == {k: np.float32 for k in ("a", "b", "K", "logc")}
    assert isinstance(mse, float) and 0 < mse < 0.3
