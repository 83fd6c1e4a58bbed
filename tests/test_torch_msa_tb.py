"""The fill with traceback planes of `ops.msa` against the JAX package's
`msa_fill(R, Cc, prune, True, ...)`, on the CPU: tests/test_msa.py's
task sets (ragged windows, N bases, tasks that prune mode kills). The
pruned fill with planes (fillLimitedX with traceback) and the unpruned
one give the JAX scores, columns and states, and its planes on every
live cell; the port's walk over its planes, with every dead byte set to
0xFF, gives the JAX walk's ops and step counts; `msa_fill_batch(...,
traceback=True)` gives both in one call, and the same in groups under a
small plane budget. All integer arithmetic: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import msa as tmsa
from bbtools_torch.ops import msa_fill as tmsa_fill
from bbtools_torch.ops.msa_fill import live_cells
from bbtools_tpu.ops import msa as jmsa
from bbtools_tpu.ops import msa_constants as C


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the fill's many small ops stall a thread pool
    shared with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases(monkeypatch):
    """tests/test_msa.py's task sets, drawn with its make_task from its
    seed (as tests/test_torch_a8b4_research.py draws them)."""
    from test_torch_a8b4_research import _msa_cases

    return _msa_cases(monkeypatch)


def _jax_fill(reads, rl, refs, cl, mins, prune):
    B, R = reads.shape
    Cc = refs.shape[1]
    ms = (mins - C.MIN_SCORE_ADJUST) if prune else np.zeros(B, np.int64)
    vert, horiz, floor, subfloor = jmsa.prepare_limits_np(reads, rl, refs, cl, ms)
    if not prune:
        subfloor = -2 * ((rl.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH)
    out = jmsa.msa_fill(
        R, Cc, prune, True, jnp.asarray(reads), jnp.asarray(rl), jnp.asarray(refs),
        jnp.asarray(cl), *(jnp.asarray(x.astype(np.int32)) for x in (vert, horiz, floor,
                                                                    subfloor)))
    walk = jmsa.msa_walk(R, Cc, out[3], jnp.asarray(rl), out[1], out[2])
    return [np.asarray(x) for x in (*out, *walk)]


@pytest.mark.parametrize("prune", [True, False])
def test_fill_with_planes_and_walk_equal_jax(monkeypatch, prune):
    killed = 0
    for name, reads, rl, refs, cl, mins in _cases(monkeypatch):
        js, jc, jst, jplanes, jops, jsteps = _jax_fill(reads, rl, refs, cl, mins, prune)
        bs, bc, bst, planes = tmsa.msa_fill_tb(reads, rl, refs, cl, mins, prune=prune,
                                               device="cpu")
        for g, w in ((bs, js), (bc, jc), (bst, jst)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        Cc = refs.shape[1]
        Rp = planes.shape[2] - 1
        assert Rp == int(rl.max()) and planes.shape == (Rp + Cc - 1, len(rl), Rp + 1)
        live = live_cells(torch.from_numpy(rl), Rp, Cc)
        np.testing.assert_array_equal(planes.numpy()[live.numpy()],
                                      jplanes[: Rp + Cc - 1, :, : Rp + 1][live.numpy()],
                                      err_msg=name)
        # the walk reads live cells only
        ops, steps = tmsa.msa_walk(Rp, Cc, planes.masked_fill(~live, 0xFF),
                                   torch.from_numpy(rl), bc, bst)
        np.testing.assert_array_equal(ops.numpy(), jops[:, : Rp + Cc], err_msg=name)
        assert not jops[:, Rp + Cc :].any()
        np.testing.assert_array_equal(steps.numpy(), jsteps, err_msg=name)
        if prune:
            killed += int((bs.numpy() < mins - C.MIN_SCORE_ADJUST).sum())
    assert killed > 0 or not prune


@pytest.mark.parametrize("budget", [None, 1])
def test_fill_batch_with_traceback_equals_jax(monkeypatch, budget):
    """msa_fill_batch(traceback=True): scores, columns, states, the walk's
    ops and steps of the JAX fill and walk; under a budget of one byte
    each task is filled and walked alone, with the same output."""
    if budget is not None:
        monkeypatch.setattr(tmsa_fill, "CPU_PLANE_BUDGET", budget)
    for name, reads, rl, refs, cl, mins in _cases(monkeypatch)[-3:]:
        js, jc, jst, _, jops, jsteps = _jax_fill(reads, rl, refs, cl, mins, True)
        got = tmsa.msa_fill_batch(reads, rl, refs, cl, mins, prune=True, device="cpu",
                                  traceback=True)
        Rp, Cc = int(rl.max()), refs.shape[1]
        for g, w in zip(got, (js, jc, jst, jops[:, : Rp + Cc], jsteps)):
            np.testing.assert_array_equal(g, w, err_msg=name)
        score_only = tmsa.msa_fill_batch(reads, rl, refs, cl, mins, prune=True, device="cpu")
        for g, w in zip(score_only, got[:3]):
            np.testing.assert_array_equal(g, w, err_msg=name)
