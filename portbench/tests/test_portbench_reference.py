"""The plain references agree with the port's device=cpu run, through the
whole harness, at a small size of each cell's mix."""

import pytest

from portbench import harness

from .helpers import INDEL_MIX, run_small

CELLS = [w["name"] for w in harness.read_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload,mix", [(c, None) for c in CELLS]
                         + [("bbmap.se151_reseq", INDEL_MIX)])
def test_reference_agrees_with_the_port_on_the_cpu(workload, mix):
    r = run_small(workload, mix=mix)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"mbp_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", ["bbduk.pe151_adapters", "bbmap.se151_reseq"])
def test_a_traced_run_reads_its_spans(workload):
    r = run_small(workload, trace=True)
    assert r["correct"]
    assert 0 < r["metrics"]["compute_pct"]["value"] <= 100
    assert r["metrics"]["host_cpu_s_per_mbp"]["value"] > 0
    assert "mbp_per_s" not in r["metrics"]
