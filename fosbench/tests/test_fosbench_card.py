"""On the card: one short run of each cell comes out correct.  Skips
where there is no card (decided inside the test)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from fosbench import common

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in common.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "fosbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
