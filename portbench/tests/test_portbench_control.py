"""The comparison fails where it should: the configuration's control (a
stated guarantee broken through the program's own flag) and faults
planted in the timed path under a run that skips the look for a card."""

import pytest

from .helpers import INDEL_MIX, run_small

CASES = [("bbduk.pe151_adapters", None), ("bbduk.se151_adapters", None),
         ("bbmap.se151_reseq", INDEL_MIX), ("bbmap.se151_reseq", None)]
CONTROL = {"bbduk": "hdist0", "bbmap": "pambig_off"}


@pytest.mark.parametrize("workload,mix", CASES)
def test_the_control_is_not_correct(workload, mix):
    r = run_small(workload, mix=mix, control=CONTROL[workload.split(".")[0]])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload,mix", CASES)
@pytest.mark.parametrize("fault", ["drop_half", "alter"])
def test_a_broken_timed_path_is_not_correct(workload, mix, fault):
    r = run_small(workload, mix=mix, fault=fault)
    assert not r["correct"], r["checks"]
