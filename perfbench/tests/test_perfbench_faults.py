"""The comparison that decides ``correct`` against a run whose timed path
is broken underneath, and against the control: the harness's look for a
card is skipped (the CPU, the toy cells of ``fixtures/``), the rest of a
run is driven as the benchmark drives it.  Each toy cell's limits were set
from its own readings at the toy size (program on five seeds: train
loss 5.5e-5, first gradient 1.5e-3, change 8.5e-4; bsr chat mean gap
7.2e-5, worst request's median gap 0; MoE chat 1.8e-3 and 1.1e-2; the
float8 control's smallest: 1.8e-4, 1.4e-2, 3.3e-3; mean gap 2.9e-3 and
1.4e-2; one slot's tokens altered: worst request 0.83 or more).  The
control at each cell's own size runs on the chip
(``test_perfbench_card.py``)."""
import time

import pytest

from perfbench import harness
from perfbench.tests import toy

SEEDS = (11, 2 ** 31 + 3)

FAULTS = [("toy-bsr.train", "unchanged"), ("toy-bsr.train", "half_batch"),
          ("toy-bsr.chat", "token"), ("toy-bsr.chat", "token_slot"),
          ("toy-bsr.chat", "unchanged"), ("toy-moe.chat", "token"),
          ("toy-moe.chat", "token_slot"), ("toy-moe.chat", "unchanged")]


def run(tree, cell, seed, **options):
    return harness.run_cell(tree, cell, seed, 1.5, False,
                            t_start=time.perf_counter(), device="cpu",
                            bench_file=tree / "BENCHMARK.json",
                            options=options)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tree, cell, fault):
    out = run(tree, cell, SEEDS[0], fault=fault)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [c[0] for c in toy.CELLS])
def test_the_control_is_not_correct(tree, cell, seed):
    out = run(tree, cell, seed, control=True)
    assert out["correct"] is True, out["compared"]
    assert any(c["value"] > c["limit"] for c in out["control"].values()), \
        out["control"]
