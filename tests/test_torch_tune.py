"""The port's plan tuner (``repro_torch.tune``) and shared-memory budget
(``repro_torch.analysis.budget``) against ``repro``'s, on the CPU.

Under one explicit :class:`CostModel` both packages price every candidate
the same way, so the ranked candidates agree leaf for leaf (candidate,
``cost_us``, traffic, ``lane_len``, ``n_tiles_n``; not ``vmem_bytes``,
which measures other hardware), and so do the dataflow scores, the choice,
the rejections and the winner.  The cases are those of
``tests/test_autotune.py``.  The ``"cuda"`` objective (the card's fitted
models) and the budget's closed forms are checked on their own terms; the
card pins the closed forms to the kernels (``chip_smoke.py --only tune``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402

from repro_torch import api, tune  # noqa: E402
from repro_torch.analysis import budget  # noqa: E402
from repro_torch.core.formats import BSR  # noqa: E402
from repro_torch.models.sparse_ffn import SparseLinear  # noqa: E402

#: repro's interpret-shaped and TPU-shaped models, passed explicitly to
#: both packages (neither is a default of the port)
SEQUENTIAL = dict(bytes_per_us=2.0e3, step_us=10.0, lane_parallel=False,
                  legacy_factor=4.0)
PARALLEL = dict(bytes_per_us=8.0e5, step_us=0.5, lane_parallel=True,
                prefetch_step_credit=1.0)


def _staircase(bm=32, bk=32, stack=1):
    """``tests/test_autotune.py``'s staircase: Gustavson's m-order beats the
    segment order on B fetches."""
    base_r = np.array([0, 1, 2, 2, 3])
    base_c = np.array([0, 0, 0, 1, 1])
    brow = np.concatenate([base_r + 4 * s for s in range(stack)])
    bcol = np.concatenate([base_c + 2 * s for s in range(stack)])
    blocks = np.random.default_rng(7).standard_normal(
        (brow.size, bm, bk)).astype(np.float32)
    return BSR(shape=(4 * stack * bm, 2 * stack * bk), block_shape=(bm, bk),
               brow=brow.astype(np.int64), bcol=bcol.astype(np.int64),
               blocks=blocks)


def _scattered(seed=11, grid=(16, 16), blk=(16, 16), density=0.2):
    return BSR.random(np.random.default_rng(seed),
                      (grid[0] * blk[0], grid[1] * blk[1]), blk, density)


def _jax(a: BSR) -> JaxBSR:
    return JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)


@pytest.fixture(autouse=True)
def _fresh_caches():
    api.clear_plan_cache()
    japi.clear_plan_cache()
    yield
    api.clear_plan_cache()
    japi.clear_plan_cache()


def _same_scored(got, want):
    assert dataclasses.asdict(got.candidate) == dataclasses.asdict(
        want.candidate)
    assert got.cost_us == want.cost_us
    assert got.traffic == want.traffic
    assert (got.lane_len, got.n_tiles_n) == (want.lane_len, want.n_tiles_n)


def _both(a, b=None, *, model=SEQUENTIAL, **kw):
    """Both packages' searches under one explicit model; asserts they
    agree and returns ``(port, repro)``."""
    got = tune.autotune_matmul(a, b, cost_model=tune.CostModel(**model),
                               **kw)
    want = jtune.autotune_matmul(
        _jax(a), None if b is None else _jax(b),
        cost_model=jtune.CostModel(**model), **kw)
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        _same_scored(g, w)
    _same_scored(got.best, want.best)
    assert got.dataflow_scores == want.dataflow_scores
    assert (got.dataflow_choice, got.dataflow_dispatched) == (
        want.dataflow_choice, want.dataflow_dispatched)
    assert got.n_rejected_vmem == want.n_rejected_vmem == 0
    assert got.objective == want.objective == "custom"
    assert got.plan_kwargs() == want.plan_kwargs()
    return got, want


# ---------------------------------------------------------------------------
# search parity, case by case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [SEQUENTIAL, PARALLEL],
                         ids=["sequential", "parallel"])
def test_staircase_gustavson_wins_in_both(model):
    got, _ = _both(_staircase(), n_cols_hint=256, model=model)
    assert got.dataflow_scores["gustavson"] < got.dataflow_scores["segment"]
    if model is SEQUENTIAL:
        assert got.best.candidate.policy == "gustavson"


@pytest.mark.parametrize("seed,hint", [(11, 256), (11, 64), (5, 1024)])
@pytest.mark.parametrize("model", [SEQUENTIAL, PARALLEL],
                         ids=["sequential", "parallel"])
def test_scattered_patterns_rank_as_repro(seed, hint, model):
    _both(_scattered(seed), n_cols_hint=hint, model=model)


def test_pins_rank_as_repro():
    got, _ = _both(_scattered(), n_cols_hint=256, cache=False,
                   pins={"n_lanes": 2, "unroll": 1, "pipeline": True})
    assert all(s.candidate.n_lanes == 2 and s.candidate.unroll == 1
               and s.candidate.pipeline for s in got.candidates)


def test_search_cache_and_counters_as_repro():
    a = _scattered()
    model = tune.CostModel(**SEQUENTIAL)
    jmodel = jtune.CostModel(**SEQUENTIAL)

    def stats():
        keys = ("searched", "search_cache_hits", "dataflow_fallbacks")
        got, want = api.plan_cache_stats(), japi.plan_cache_stats()
        assert [got[k] for k in keys] == [want[k] for k in keys]
        return got

    for hint in (256, 256, 64):
        r1 = tune.autotune_matmul(a, n_cols_hint=hint, cost_model=model)
        r2 = jtune.autotune_matmul(_jax(a), n_cols_hint=hint,
                                   cost_model=jmodel)
        assert r1.from_cache == r2.from_cache
    s = stats()
    assert (s["searched"], s["search_cache_hits"]) == (2, 1)
    api.clear_plan_cache()
    japi.clear_plan_cache()
    assert stats()["searched"] == 0
    tune.autotune_matmul(a, n_cols_hint=256, cost_model=model)
    assert api.plan_cache_stats()["searched"] == 1


def test_dataflow_fallback_counter_as_repro():
    """A segment-only space with an absurd step cost, then the space's
    "inner" comparison: the counters and scores move as in ``repro``."""
    a = _scattered()
    space = dict(policies=("segment",))
    heavy = dict(bytes_per_us=1.0, step_us=1e9, lane_parallel=False)
    res = tune.autotune_matmul(a, n_cols_hint=256, cache=False,
                               space=tune.SearchSpace(**space),
                               cost_model=tune.CostModel(**heavy))
    jres = jtune.autotune_matmul(_jax(a), n_cols_hint=256, cache=False,
                                 space=jtune.SearchSpace(**space),
                                 cost_model=jtune.CostModel(**heavy))
    assert res.dataflow_scores == jres.dataflow_scores
    assert res.dataflow_choice == jres.dataflow_choice
    assert res.dataflow_dispatched == jres.dataflow_dispatched
    assert "inner" in res.dataflow_scores
    assert (api.plan_cache_stats()["dataflow_fallbacks"]
            == japi.plan_cache_stats()["dataflow_fallbacks"])


def test_spgemm_search_as_repro():
    rng = np.random.default_rng(21)
    a = BSR.random(rng, (128, 128), (16, 16), 0.25)
    b = BSR.random(rng, (128, 96), (16, 16), 0.25)
    got, _ = _both(a, b)
    assert got.best.candidate.bn == 16


def test_with_grad_search_as_repro():
    _both(_scattered(), n_cols_hint=128, with_grad=True, model=PARALLEL)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int8.rowwise"])
def test_quantized_search_as_repro(mode):
    _both(_scattered(), n_cols_hint=256, quantize=mode)


def test_calibrate_equals_repro():
    """Synthetic recovery and the degenerate samples, as ``repro``'s."""
    true = tune.CostModel(bytes_per_us=5.0e4, step_us=2.5,
                          lane_parallel=False)
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(12):
        by = float(rng.integers(10_000, 5_000_000))
        st = float(rng.integers(10, 5_000))
        samples.append((by, st, by / true.bytes_per_us + st * true.step_us))
    fit = tune.calibrate(samples, lane_parallel=False)
    assert fit.bytes_per_us == pytest.approx(true.bytes_per_us, rel=1e-6)
    assert fit.step_us == pytest.approx(true.step_us, rel=1e-6)
    for s in (samples, [(1000.0, 10.0, 5.0)], [(1e6, 3.0, 2.0)] * 3):
        assert dataclasses.astuple(tune.calibrate(s)) == dataclasses.astuple(
            jtune.calibrate(s))
    with pytest.raises(ValueError):
        tune.calibrate([])


# ---------------------------------------------------------------------------
# the "cuda" objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["tpu", "interpret"])
def test_other_hardware_objectives_raise(objective):
    with pytest.raises(ValueError, match="'cuda'"):
        tune.autotune_matmul(_scattered(), n_cols_hint=256,
                             objective=objective)


def _granite_like(seed=0):
    """A granite-3-8b up projection cut to 16 of its 200 block rows (its
    4096 inputs, block size and density: rows of ~16 items)."""
    return BSR.random(np.random.default_rng(seed), (1024, 4096), (64, 64),
                      0.25)


@pytest.mark.parametrize("n,rhs,path", [(4, None, "split"), (64, None, "tc"),
                                        (2048, None, "tc"),
                                        (64, "float32", "simt")])
def test_cuda_objective_keeps_default_where_the_card_cannot_tell(n, rhs,
                                                                 path):
    """Knobs the card ignores (pipeline, prefetch, bn off the simt tile;
    fold on the split path, which ignores the flags) price equal, and the
    tie-break keeps the planner's default point."""
    a = _granite_like()
    res = tune.autotune_matmul(a, n_cols_hint=n, rhs_dtype=rhs)
    assert res.objective == "cuda"
    assert tune.cost.spmm_path(64, 64, n, rhs) == path
    c = res.best.candidate
    assert (c.policy, c.fold_len, c.n_lanes, c.unroll, c.bn, c.pipeline,
            c.prefetch) == ("segment", None, 1, 1, 512, True, None)
    by = {s.candidate: s.cost_us for s in res.candidates}
    for cand, cost in by.items():
        twin = dataclasses.replace(cand, pipeline=True, prefetch=None,
                                   bn=512)
        assert cost == by[twin]
        if path == "split" and cand.fold_len is not None:
            assert cost == by[dataclasses.replace(cand, fold_len=None)]
    # a fold adds C writes and reads where the flags are read
    if path != "split":
        d = res.best
        folded = by[dataclasses.replace(d.candidate, fold_len=8)]
        assert folded > d.cost_us


def test_card_work_counts():
    """The card's work by hand on a 2-row pattern: rows of 3 and 1 items,
    64x64 fp32 blocks, N = 64 on tc (one 128-wide tile, bf16 B)."""
    m = np.array([0, 0, 0, 1])
    ones = np.ones(4, np.int32)
    w = tune.cost.spmm_card_work(
        path="tc", m=m, valid=ones, seg_write=np.array([0, 0, 1, 1]),
        accum_prev=np.zeros(4), runs=np.array([0, 3, 4]), bm=64, bk=64, n=64)
    assert w["a_bytes"] == 4 * 64 * 64 * 4
    assert w["b_bytes"] == 4 * 64 * 128 * 2
    assert w["c_bytes"] == 2 * 64 * 128 * 4
    assert (w["steps"], w["n_tiles"]) == (3.0, 1.0)
    g = tune.cost.spgemm_card_work(
        valid=ones, seg_write=np.array([0, 1, 0, 1]),
        accum_prev=np.array([0, 0, 0, 1]), runs=np.array([0, 2, 4]),
        bm=64, bk=64, bn=64, block_dtype="int8")
    assert g["a_bytes"] == g["b_bytes"] == 4 * (64 * 64 + 4)
    assert g["c_bytes"] == 3 * 64 * 64 * 4 and g["steps"] == 2.0


# ---------------------------------------------------------------------------
# the budget
# ---------------------------------------------------------------------------


def test_budget_closed_forms_equal_hand_counts():
    """Counted by hand from the sources' layouts (the card compares the
    closed forms with the compiled numbers)."""
    # segment_spmm_tc.cu Layout<fp32, none, 1>: 57344-byte stages, 4 fit
    assert budget.tc_spmm_smem_bytes(64, 0, 0) == 4 * 57344 + 1024 + 96
    # ... two warpgroups: 73728-byte stages, 3 fit
    assert budget.tc_spmm_smem_bytes(256, 0, 0) == 3 * 73728 + 1024 + 72
    # per-block int8, one warpgroup: B 16 KiB + 8 KiB part + 4 KiB raw
    assert budget.tc_spmm_smem_bytes(128, 1, 1) == 6 * 28672 + 1024 + 144
    # segment_spgemm_tc.cu Layout<fp32, none>: 2 pipes of 6 parts + 4 slots
    assert budget.tc_spgemm_smem_bytes(0, 0) == 1024 + 2 * 114688 + 2 * 704
    # segment_spmm.cu smem_bytes<64, 64, 32, false, fp32>
    assert budget.simt_spmm_smem_bytes(64, 32, False, 0, 0) == (
        3 * 4 * 64 * 68 + 4 * 2 * 64 * 33)
    # ... an int8 ring plus one fp32 tile, transposed at 32 x 32, TN 8
    assert budget.simt_spmm_smem_bytes(32, 8, True, 1, 2) == (
        3 * 32 * 32 + 4 * 32 * 36 + 4 * 2 * 32 * 9)
    # fold::smem_bytes<16, fp32, none> and <4, int8, rowwise>
    assert budget.split_spmm_smem_bytes(16, 0, 0) == 3 * 64 * 272 + 8 * 64 * 20
    assert budget.split_spmm_smem_bytes(4, 1, 2) == (
        3 * (64 * 80 + 256) + 8 * 64 * 4)
    # segment_spgemm.cu smem_bytes<64, 32, 64, fp8>
    assert budget.simt_spgemm_smem_bytes(64, 32, 64, 2, 1) == (
        3 * (64 * 32 + 32 * 64) + 4 * (64 * 36 + 32 * 64))
    with pytest.raises(ValueError):
        budget.tc_spmm_smem_bytes(64, 0, 1)
    # every launch fits the H100's limit
    for p, s in ((0, 0), (1, 1), (1, 2), (2, 1), (2, 2)):
        for n in (64, 256):
            assert budget.tc_spmm_smem_bytes(n, p, s) <= (
                budget.DEFAULT_VMEM_LIMIT_BYTES)
        assert budget.tc_spgemm_smem_bytes(p, s) <= (
            budget.DEFAULT_VMEM_LIMIT_BYTES)


def test_plan_budget_takes_the_worst_path_and_the_grad_plan():
    a = _granite_like()
    plan = api.plan_matmul(a, 64, with_grad=True, device="cpu")
    need = budget.plan_vmem_bytes(plan, n_cols=64)
    assert need == max(budget.tc_spmm_smem_bytes(64, 0, 0),
                       budget.split_spmm_smem_bytes(16, 0, 0),
                       budget.simt_spmm_smem_bytes(64, 32, True, 0, 0))
    # decode widths cannot reach the tensor cores
    assert budget.plan_vmem_bytes(plan, n_cols=4) == max(
        budget.split_spmm_smem_bytes(4, 0, 0),
        budget.simt_spmm_smem_bytes(64, 4, True, 0, 0))
    with pytest.raises(budget.VmemBudgetError, match="shared memory"):
        api.plan_matmul(a, 64, with_grad=True, device="cpu",
                        vmem_limit_bytes=need - 1)
    got = api.plan_matmul(a, 64, with_grad=True, device="cpu",
                          vmem_limit_bytes=budget.DEFAULT_VMEM_LIMIT_BYTES)
    assert budget.check_plan_vmem(got, n_cols=64) == need
    # SpGEMM at 64 x 64 tiles: the tensor-core launch
    b = BSR.random(np.random.default_rng(9), (4096, 512), (64, 64), 0.25)
    g = api.plan_matmul(a, b, device="cpu", quantize="int8.rowwise")
    assert budget.plan_vmem_bytes(g) == budget.tc_spgemm_smem_bytes(1, 2)


# ---------------------------------------------------------------------------
# plan_matmul(policy="auto")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(quantize="int8"),
                                dict(with_grad=True)])
def test_auto_plan_equals_the_winners_plan(kw):
    a = _scattered(blk=(32, 32), grid=(8, 8), density=0.4)
    res = tune.autotune_matmul(a, n_cols_hint=64, **kw)
    got = api.plan_matmul(a, 64, policy="auto", cache=False, device="cpu",
                          **kw)
    want = api.plan_matmul(a, 64, cache=False, device="cpu", **kw,
                           **res.plan_kwargs())
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("fingerprint", "grad_plan"):
            continue
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f.name
        else:
            assert g == w, f.name
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (a.shape[1], 64)).astype(np.float32))
    dense = torch.zeros(a.shape)
    for i, (r, c) in enumerate(zip(a.brow, a.bcol)):
        dense[r * 32:(r + 1) * 32, c * 32:(c + 1) * 32] = torch.from_numpy(
            a.blocks[i])
    tol = 5e-2 if kw.get("quantize") else 1e-5
    torch.testing.assert_close(got(x, backend="reference"), dense @ x,
                               rtol=tol, atol=tol * float(
                                   (dense @ x).abs().max()))


def test_auto_honours_pins_and_limits():
    a = _scattered()
    assert api.plan_matmul(a, 256, policy="auto", n_lanes=2,
                           device="cpu").n_lanes == 2
    with pytest.raises(ValueError, match="VMEM"):
        api.plan_matmul(a, 256, policy="auto", vmem_limit_bytes=1024,
                        device="cpu")


def test_sparse_linear_auto_counts_one_search_then_a_hit():
    w = _granite_like(3)
    SparseLinear.from_pattern(w, policy="auto", device="cpu")
    s = api.plan_cache_stats()
    assert (s["searched"], s["search_cache_hits"]) == (1, 0)
    lin = SparseLinear.from_pattern(w, policy="auto", device="cpu")
    s = api.plan_cache_stats()
    assert (s["searched"], s["search_cache_hits"]) == (1, 1)
    x = torch.randn(8, w.shape[1], generator=torch.Generator().manual_seed(0))
    from repro_torch.api import use_backend
    with torch.no_grad():
        got = lin(x)
        with use_backend("reference"):
            want = lin(x)
    # fp32 sums over 4096 inputs in two orders: relative to the largest
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
