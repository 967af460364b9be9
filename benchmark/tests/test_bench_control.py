"""The control (the plain reference one precision step below the
configuration's, put in the program's place: ``reference/precision.py``)
comes out not correct against each cell's limits: on the card (marked
``cuda``) at the cell's own size on three seeds, where the program itself
comes out correct; and on the CPU at a small size for the tracking cells,
whose bf16 and product-free stages have a lower precision there too (the
mapper's control is TF32, which the CPU does not have)."""

import os
import subprocess
import sys

import pytest

from benchmark import check, harness
from benchmark.tests import tiny

SEEDS = (2147483659, 2147491578, 2147499497)


@pytest.mark.parametrize("cell", ["replica-track", "tum-track"])
def test_control_fails_on_cpu(cell, monkeypatch):
    tiny.small_dpt(monkeypatch)
    res = tiny.run(cell, control=True)
    limits = harness.Bench().limits(cell)["limits"]
    ok, _ = check.judge(res["control"], limits)
    assert not ok, res["control"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["replica-track", "tum-track",
                                  "replica-map"])
def test_control_fails_on_the_card(cell, card, tmp_path):
    out = tmp_path / "readings.jsonl"
    seconds = "24" if cell == "replica-map" else "12"
    subprocess.run([sys.executable, "-m", "benchmark.calibrate",
                    "--workload", cell, "--seconds", seconds, "--out",
                    str(out), "--seeds", *map(str, SEEDS)],
                   cwd=harness.ROOT, check=True, timeout=1800,
                   env=dict(os.environ))
    import json
    limits = harness.Bench().limits(cell)["limits"]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(SEEDS)
    for r in rows:
        assert check.judge(r["program"], limits)[0], r["program"]
        assert not check.judge(r["control"], limits)[0], r["control"]
