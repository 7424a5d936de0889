"""A run with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have (one card: no exchange between chips)."""

import pytest

from portbench import control, harness

from .conftest import TINY

FAULTS = ["stale", "half", "type", "zone", "price", "encode"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["delta50k.churn", "cells500k.churn"])
def test_fault_makes_the_run_incorrect(bench, name, fault):
    spec = next(w for w in bench["workloads"] if w["name"] == name)
    with control.planted(fault, smallest="c4.small"):
        out = harness.run_cell(bench, name, 2**32 + 3, 0.2, False, device="cpu",
                               config_override=TINY[spec["config"]])
    assert out["result"]["correct"] is False
    assert out["result"]["failed"] > 0


@pytest.mark.parametrize("name", ["delta50k.churn", "cells500k.churn"])
def test_control_and_faults_read_apart_from_sound_runs(name):
    """At a tiny size: the sound rounds pass every limit, the control and
    every fault fail one."""
    spec_cfg = {"delta50k.churn": "delta_50k", "cells500k.churn": "cells_500k"}[name]
    r = control.readings(name, 2**31 + 4, 2, device="cpu", config_override=TINY[spec_cfg])
    over = {mode: [k for k, v in nums.items() if v > harness.LIMITS[k]]
            for mode, nums in r.items()}
    assert over["sound"] == []
    for mode in control.MODES[1:]:
        assert over[mode], mode
