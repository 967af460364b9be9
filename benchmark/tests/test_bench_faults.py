"""A run whose timed path is broken underneath comes out not correct, one
run per fault in ``benchmark/faults.py``: each skips the harness's look for
a card and drives the rest of a run on the CPU at a small size, against
the limits the cells hold."""

import pytest

from benchmark import faults
from benchmark.tests import tiny

EXPECT = {"ba_unchanged": {"dba"}, "lookup_half": {"lookup"},
          "prior_altered": {"dpt"}, "step_frozen": {"grad", "change"},
          "half_rays": {"loss", "grad", "change"}, "loss_altered": {"loss"},
          "color_loss_dropped": {"grad.color", "change.color"}}


@pytest.mark.parametrize("fault", faults.TRACKING + faults.MAPPING)
def test_fault_is_not_correct(fault, monkeypatch):
    tiny.small_dpt(monkeypatch)
    cell = "replica-track" if fault in faults.TRACKING else "replica-map"
    undo = faults.install(fault)
    try:
        res = tiny.run(cell)
    finally:
        undo()
    failed = {k for k, v in res["checked"].items()
              if not isinstance(v["value"], float) or v["value"] > v["limit"]}
    assert not res["correct"]
    assert failed & EXPECT[fault], res["checked"]
