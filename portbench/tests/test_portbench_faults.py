"""A run with the timed path broken underneath comes out not correct:
for each fault a cell can have on one chip (faults.py)."""

import pytest

import faults
import harness
from tiny import cells, run_tiny


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", cells())
def test_fault_is_not_correct(name, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    cell, res = run_tiny(name, voices=4)
    assert res["checks"]["correct"] is False
    line = harness.result_line(cell, res, trace=False)
    assert line["correct"] is False
    assert line["check"]["mix_err"]["value"] > \
        line["check"]["mix_err"]["limit"]
