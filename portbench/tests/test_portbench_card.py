"""One short run of each cell on the card, through the command the
driver runs (``cuda``: skips where no CUDA device is visible)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["northstar-10k.burst", "northstar-10k.churn"])
def test_cell_on_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4000000001", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
