"""The per-layer readers on runs made by hand: what each reads, and that
a reader with nothing to read returns nothing."""
import json

import pytest

from perfbench import harness
from perfbench.counts import spmm
from perfbench.counts.flops import forward_flops, train_step_flops
from perfbench.tests.conftest import ROOT

GRANITE_TRAIN = "granite-3-8b-bsr.train-2x2048"
PHI_CHAT = "phi3.5-moe-8of32.chat-64"


def cell(name):
    return harness.Cell.load(ROOT, name)


def reader(name):
    return cell(PHI_CHAT).reader(name)


def make_run(name, spans, kernels=None, window=(0.0, 100.0)):
    rec = harness.Recorder()
    rec.spans = [harness.Span(*s) for s in spans]
    c = cell(name)
    trace = (None if kernels is None else
             harness.DeviceTrace(kernels, [], 90.0, 100.0))
    return harness.Run(c, c.arch, rec, trace, window)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(cell(PHI_CHAT).reader(m["name"]))
    for w in bench["workloads"]:
        c = cell(w["name"])
        assert set(c.limits) and callable(c.driver().run)
        e2e = {m["name"] for m in c.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.metrics("per_layer")


def test_decode_and_admit_leave_out_what_the_profiler_slowed():
    spans = [("decode step", 1.0, 1.2, {"n": 64, "ctx_sum": 1000}, False),
             ("decode step", 2.0, 2.4, {"n": 64, "ctx_sum": 1000}, False),
             ("decode step", 3.0, 9.0, {"n": 64, "ctx_sum": 1000}, True),
             ("admit", 4.0, 4.3, {"n": 3, "tokens": 9, "ctx_sum": 18},
             False),
             ("admit", 5.0, 5.1, {"n": 0, "tokens": 0, "ctx_sum": 0},
             False),
             ("decode step", 150.0, 151.0, {"n": 64, "ctx_sum": 1}, False)]
    run = make_run(PHI_CHAT, spans)
    assert reader("decode_step_ms.chat")(run) == pytest.approx(300.0)
    assert reader("admit_ms.chat")(run) == pytest.approx(100.0)
    empty = make_run(PHI_CHAT, [])
    assert reader("decode_step_ms.chat")(empty) is None
    assert reader("admit_ms.chat")(empty) is None
    assert reader("mfu.chat")(empty) is None


def test_mfu_counts_useful_flops_over_span_time():
    run = make_run(PHI_CHAT, [
        ("decode step", 0.0, 0.5, {"n": 64, "ctx_sum": 64 * 500}, False),
        ("admit", 1.0, 1.5, {"n": 1, "tokens": 300, "ctx_sum": 45150},
         False)])
    a = run.arch
    want = (forward_flops(a, 64, 32000) + forward_flops(a, 300, 45150)) \
        / 1.0 / 989e12 * 100
    assert reader("mfu.chat")(run) == pytest.approx(want)
    train = make_run(GRANITE_TRAIN, [
        ("train step", 0.0, 3.0, {"batch": 2, "seq": 2048}, False)])
    got = cell(GRANITE_TRAIN).reader("mfu.train")(train)
    assert got == pytest.approx(train_step_flops(train.arch, 2, 2048) / 3.0
                                / 989e12 * 100)
    assert 0 < got < 100


def test_spmm_roofline_counts_the_needed_calls():
    kernels = [("void segment_spmm_tc_kernel<false, 0>", 90.0, 90.004),
               ("void segment_spmm_fold_kernel<8>", 91.0, 91.002),
               ("ampere_sgemm", 92.0, 99.0)]
    train = make_run(GRANITE_TRAIN, [
        ("train step", 90.0, 99.0, {"batch": 2, "seq": 2048}, True)],
        kernels)
    read = cell(GRANITE_TRAIN).reader("spmm_roofline.train")
    assert read(train) == pytest.approx(
        100 * spmm.ffn_least_seconds(train.arch, 4096, dx=True) / 0.006)
    # no trace, or no kernel of that name: nothing, never 0
    assert read(make_run(GRANITE_TRAIN, [])) is None
    other = make_run(GRANITE_TRAIN, [("train step", 90.0, 99.0,
                                      {"batch": 2, "seq": 2048}, True)],
                     [("ampere_sgemm", 92.0, 99.0)])
    assert read(other) is None


def test_idle_share_is_the_uncovered_share_of_the_slice():
    run = make_run(PHI_CHAT, [], [("a", 90.0, 93.0), ("b", 92.0, 95.0),
                                      ("c", 99.0, 100.0)])
    assert reader("idle_share.chat")(run) == pytest.approx(40.0)
    assert run.trace.breakdown()["device_ops"][0][0] in ("a", "b")
    assert reader("idle_share.chat")(make_run(PHI_CHAT, [])) is None
