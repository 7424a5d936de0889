"""The check's control and planted faults on the card, at the cells' own
sizes: every fault and the control fail one of the compared numbers, and
the program's own rounds fail none."""

import json

import pytest

from portbench import control, harness


@pytest.mark.card
@pytest.mark.parametrize("name", ["delta50k.churn", "cells500k.churn"])
def test_control_fails_at_the_cells_size(card, name):
    for seed in (11, 12, 13):
        r = control.readings(name, seed, 2, device=card)
        print(json.dumps({"workload": name, "seed": seed, "readings": r}))
        over = {mode: [k for k, v in nums.items() if v > harness.LIMITS[k]]
                for mode, nums in r.items()}
        assert over["sound"] == [], r["sound"]
        for mode in control.MODES[1:]:
            assert over[mode], (mode, r[mode])
