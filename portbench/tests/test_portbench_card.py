"""Each cell once on the card, through the benchmark's command, at
a short window: it exits 0 and its last line reads ``correct``. Marked
``cuda``: it skips on a host without a card. Run it there with

    python3 -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cuda_device, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
