"""The control at each cell's own size, on the chip: the reference put in
the program's place in float8 (``run.py --control 1``) is not correct on
three seeds, while the program is.  Skips without a CUDA device.

    python -m pytest perfbench/tests/test_perfbench_card.py   # on the chip
"""
import json
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_at_the_cells_size(card, cell, seed):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(BENCH["run_seconds"]), "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert any(c["value"] > c["limit"] for c in result["control"].values()), \
        result["control"]
