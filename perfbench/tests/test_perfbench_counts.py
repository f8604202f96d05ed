"""The frozen counts against numbers worked by hand for one layer of
granite-3-8b-bsr (d_model 4096, d_ff 12800, 64 x 64 blocks at density
0.25) and for the device-interval union."""
import json

import pytest

from perfbench.counts import flops, intervals, spmm
from perfbench.counts.peaks import H100
from perfbench.inputs import arch, ffn_nnz
from perfbench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def granite():
    return arch(json.loads((ROOT / "perfbench/configs/granite-3-8b-bsr.json")
                           .read_text()))


def test_stored_blocks(granite):
    # up and gate: 200 x 64 cells, down: 64 x 200; a quarter of each
    assert [ffn_nnz(granite, p) for p in ("up", "gate", "down")] == \
        [3200, 3200, 3200]


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("proj,d_out,d_in", [("up", 12800, 4096),
                                              ("gate", 12800, 4096),
                                              ("down", 4096, 12800)])
def test_one_call(granite, n, proj, d_out, d_in):
    ops, moved = spmm.call(3200, 64, d_out, d_in, n)
    assert ops == 2 * 3200 * 4096 * n            # 26,214,400 * n
    # fp32 blocks 52,428,800 B; bf16 B (d_in x n) and C (d_out x n)
    assert moved == 52_428_800 + 2 * d_in * n + 2 * d_out * n
    t_ops, t_bytes = ops / 989e12, moved / 3.35e12
    assert spmm.least_seconds(ops, moved) == max(t_ops, t_bytes)
    # N = 64 is bound by the blocks' bytes, N = 4096 by the operations
    assert (t_bytes > t_ops) == (n == 64)


def test_one_call_worked_numbers():
    # up at N = 64: 1.6777e9 ops (1.696 us at 989 TFLOP/s); 52,428,800 +
    # 524,288 + 1,638,400 = 54,591,488 B (16.296 us at 3.35 TB/s)
    ops, moved = spmm.call(3200, 64, 12800, 4096, 64)
    assert ops == 1_677_721_600 and moved == 54_591_488
    assert spmm.least_seconds(ops, moved) == pytest.approx(16.2959e-6,
                                                           rel=1e-4)
    # down at N = 4096, transposed (dx): K = d_out = 4096 rows of dy
    ops, moved = spmm.call(3200, 64, 4096, 12800, 4096, transposed=True)
    assert moved == 52_428_800 + 2 * 4096 * 4096 + 2 * 12800 * 4096
    assert spmm.least_seconds(ops, moved) == pytest.approx(
        107_374_182_400 / 989e12)


def test_ffn_least_seconds(granite):
    one = sum(spmm.least_seconds(*spmm.call(3200, 64, o, i, 64))
              for o, i in ((12800, 4096), (12800, 4096), (4096, 12800)))
    assert spmm.ffn_least_seconds(granite, 64) == pytest.approx(40 * one)
    both = spmm.ffn_least_seconds(granite, 4096, dx=True)
    assert both == pytest.approx(40 * 6 * 107_374_182_400 / 989e12)


def test_model_flops(granite):
    # attention 2 x 4096 x 4096 + 2 x 4096 x 1024 = 41,943,040; the FFN's
    # 9,600 stored blocks 39,321,600; 40 layers; the head 49155 x 4096
    assert flops.active_params(granite) == 40 * (41_943_040 + 39_321_600) \
        + 49155 * 4096
    n = flops.active_params(granite)
    # a step of 2 rows of 2048: 3 x (2 N 4096 + 4 x 2 x 2048 x 2049 / 2 x
    # 32 x 128 x 40)
    want = 3 * (2 * n * 4096 + 4 * 2 * 2048 * 2049 / 2 * 32 * 128 * 40)
    assert flops.train_step_flops(granite, 2, 2048) == pytest.approx(want)
    assert want == pytest.approx(9.31e13, rel=2e-3)
    assert flops.causal_ctx(10, 3) == 11 + 12 + 13


def test_peaks():
    assert H100 == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_interval_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert intervals.merged(spans) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert intervals.busy(spans) == pytest.approx(4.0)
    assert intervals.gaps(spans, -1.0, 6.5) == [(-1.0, 0.0), (2.0, 3.0),
                                                (4.0, 6.0)]
    assert intervals.busy([]) == 0.0
