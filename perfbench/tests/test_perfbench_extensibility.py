"""A later change adds a configuration, a traffic mix, a per-layer metric
and cells as new files and new entries: the toy ones of ``fixtures/`` run
end to end on the CPU through the harness, and no file of the benchmark is
edited for them."""
import time

import pytest

from perfbench import harness
from perfbench.tests import toy

SEED = 2 ** 31 + 977


def run(tree, cell, trace, **options):
    return harness.run_cell(tree, cell, SEED, 2.0, trace,
                            t_start=time.perf_counter(), device="cpu",
                            bench_file=tree / "BENCHMARK.json",
                            options=options)


@pytest.mark.parametrize("cell", [c[0] for c in toy.CELLS])
def test_a_new_cell_runs_end_to_end(tree, cell):
    out = run(tree, cell, False)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"setup_s"} | ({"train_tokens_per_s"} if "train" in cell else
                          {"output_tokens_per_s"})
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "compared"
    for c in out["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", [c[0] for c in toy.CELLS])
def test_a_new_metric_is_read_in_the_traced_run(tree, cell):
    out = run(tree, cell, True)
    assert out["correct"] is True
    got = set(out["metrics"])
    assert "steps_per_s.toy" in got
    kind = "train" if "train" in cell else "chat"
    assert {f"mfu.{kind}", f"idle_share.{kind}"} <= got
    if kind == "chat":
        assert {"decode_step_ms.chat", "admit_ms.chat", "itl_p95_ms",
                "ttft_p90_ms"} <= got
    # the CPU has no device trace: no roofline is read, none reads 0
    assert not any(k.startswith("spmm_roofline") for k in got)
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_the_benchmark_lacks_is_refused(tree):
    with pytest.raises(harness.BenchError):
        run(tree, "no-such-cell", False)
