"""The port's copy of the paper's dataflow layer against ``repro`` on the
same numpy inputs, exactly (no tolerance: both sides run the same numpy
arithmetic): the element formats and their round trips, ``BSR.from_dense``
and its orderings, the three static dataflows, SELECTA, the elementwise
Segment SpGEMM, spatial and temporal folding, ``spmm_schedule_traffic``,
each registered policy's ``cost_hint`` and ``dataflow_estimates``."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflows as jdf  # noqa: E402
from repro.core import folding as jfold  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import segmentbc as jseg  # noqa: E402
from repro.core import selecta as jsel  # noqa: E402
from repro.sim import baselines as jbase  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.core import dataflows, folding, formats, policies  # noqa: E402
from repro_torch.core import schedule, segmentbc, selecta  # noqa: E402
from repro_torch.sim import baselines  # noqa: E402

BLOCKS = [(32, 32), (64, 64), (32, 64), (64, 32), (16, 16), (128, 128)]


def same(got, want, where="value"):
    """Exact equality of nested results: dataclasses field by field, dicts
    key by key, arrays with their dtype, floats bit for bit."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name),
                 f"{where}.{f.name}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _csr_pair(seed=0, shape=(48, 40), density=0.08):
    return (formats.random_csr(np.random.default_rng(seed), shape, density),
            jfmt.random_csr(np.random.default_rng(seed), shape, density))


# ---------------------------------------------------------------------------
# element formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape,density", [
    (0, (48, 40), 0.08), (1, (17, 63), 0.2), (2, (64, 64), 0.01),
    (3, (5, 7), 0.9)])
def test_element_formats_match_repro(seed, shape, density):
    got, want = _csr_pair(seed, shape, density)
    same(got, want, "random_csr")
    same(got.to_dense(), want.to_dense(), "to_dense")
    same(got.transpose(), want.transpose(), "transpose")
    same(got.row_lengths(), want.row_lengths(), "row_lengths")
    assert got.density == want.density
    dense = got.to_dense()
    same(formats.CSR.from_dense(dense), jfmt.CSR.from_dense(dense),
         "from_dense")
    np.testing.assert_array_equal(formats.CSR.from_dense(dense).to_dense(),
                                  dense)
    csc, jcsc = formats.CSC.from_csr(got), jfmt.CSC.from_csr(want)
    same(csc, jcsc, "CSC")
    np.testing.assert_array_equal(csc.to_dense(), dense)
    same(csc.col_lengths(), jcsc.col_lengths(), "col_lengths")
    dcsr, jdcsr = formats.DCSR.from_csr(got), jfmt.DCSR.from_csr(want)
    same(dcsr, jdcsr, "DCSR")
    for r in range(shape[0]):
        assert dcsr.lookup(r) == jdcsr.lookup(r)


def test_csr_from_coo_sums_duplicates_like_repro():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 12, 80)
    cols = rng.integers(0, 9, 80)
    vals = rng.standard_normal(80).astype(np.float32)
    got = formats.csr_from_coo((12, 9), rows, cols, vals)
    same(got, jfmt.csr_from_coo((12, 9), rows, cols, vals))
    want = np.zeros((12, 9), np.float64)
    np.add.at(want, (rows, cols), vals.astype(np.float64))
    np.testing.assert_array_equal(got.to_dense(), want.astype(np.float32))
    same(formats.csr_from_coo((3, 4), [], [], np.zeros(0, np.float32)),
         jfmt.csr_from_coo((3, 4), [], [], np.zeros(0, np.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spgemm_reference_matches_repro(seed):
    a, ja = _csr_pair(seed, (40, 30), 0.1)
    b, jb = _csr_pair(seed + 10, (30, 36), 0.1)
    got = formats.spgemm_reference(a, b)
    same(got, jfmt.spgemm_reference(ja, jb))
    np.testing.assert_array_equal(got.to_dense(),
                                  a.to_dense() @ b.to_dense())


# ---------------------------------------------------------------------------
# BSR
# ---------------------------------------------------------------------------


def _pruned_dense(seed, shape, block, keep=0.4):
    """A dense weight with whole blocks zeroed (a pruned weight), rows and
    columns not multiples of the block."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    gm, gk = -(-shape[0] // block[0]), -(-shape[1] // block[1])
    drop = rng.random((gm, gk)) >= keep
    for r, c in zip(*np.nonzero(drop)):
        a[r * block[0]:(r + 1) * block[0], c * block[1]:(c + 1) * block[1]] = 0
    return a


@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("threshold", [0.0, 2.5])
def test_bsr_from_dense_and_orders_match_repro(block, threshold):
    dense = _pruned_dense(7, (3 * block[0] + 5, 4 * block[1] - 3), block)
    got = formats.BSR.from_dense(dense, block, keep_threshold=threshold)
    want = jfmt.BSR.from_dense(dense, block, keep_threshold=threshold)
    same(got, want, "from_dense")
    assert got.block_density == want.block_density
    same(got.block_mask(), want.block_mask(), "block_mask")
    same(got.to_dense(), want.to_dense(), "to_dense")
    if threshold == 0.0:
        np.testing.assert_array_equal(got.to_dense(), dense)
    perm = np.random.default_rng(1).permutation(got.nblocks)
    shuffled = formats.BSR(got.shape, got.block_shape, got.brow[perm],
                           got.bcol[perm], got.blocks[perm])
    jshuffled = jfmt.BSR(want.shape, want.block_shape, want.brow[perm],
                         want.bcol[perm], want.blocks[perm])
    same(shuffled.row_major_order(), jshuffled.row_major_order(), "row")
    same(shuffled.col_major_order(), jshuffled.col_major_order(), "col")
    same(shuffled.row_major_order(), got, "row order restores storage")


# ---------------------------------------------------------------------------
# static dataflows, SELECTA, the elementwise Segment SpGEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["inner", "outer", "gustavson"])
@pytest.mark.parametrize("seed", [0, 3])
def test_static_dataflows_match_repro(name, seed):
    a, ja = _csr_pair(seed, (24, 20), 0.15)
    b, jb = _csr_pair(seed + 1, (20, 28), 0.15)
    c, stats = dataflows.DATAFLOWS[name](a, b)
    jc, jstats = jdf.DATAFLOWS[name](ja, jb)
    same(c, jc, "C")
    same(stats, jstats, "stats")
    np.testing.assert_allclose(c, a.to_dense() @ b.to_dense(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("w_max,r_max", list(itertools.product(
    (1, 4, 32), (1, 3, 16))))
@pytest.mark.parametrize("dynamic_k", [True, False])
def test_selecta_matches_repro(w_max, r_max, dynamic_k):
    a, ja = _csr_pair(4, (40, 36), 0.1)
    csc, jcsc = formats.CSC.from_csr(a), jfmt.CSC.from_csr(ja)
    got = selecta.run_selecta(csc, w_max=w_max, r_max=r_max,
                              dynamic_k=dynamic_k)
    want = jsel.run_selecta(jcsc, w_max=w_max, r_max=r_max,
                            dynamic_k=dynamic_k)
    same(got, want, "batches")
    same(selecta.selecta_stats(got, r_max), jsel.selecta_stats(want, r_max),
         "stats")
    assert sorted(p for b in got for p in b) == sorted(
        (int(m), k) for k in range(36) for m in csc.col(k)[0])


def test_selecta_state_and_empty_stats():
    a, ja = _csr_pair(6, (20, 20), 0.2)
    k_active = np.arange(20) % 3 != 0
    st = selecta.SelectaState(a=formats.CSC.from_csr(a), w_max=4, r_max=5,
                              k_active=k_active)
    jst = jsel.SelectaState(a=jfmt.CSC.from_csr(ja), w_max=4, r_max=5,
                            k_active=k_active)
    while not jst.done:
        same(st.select(), jst.select(), "select")
        same(st.entry_batch, jst.entry_batch, "entry_batch")
    assert st.done
    same(selecta.selecta_stats([], 4), jsel.selecta_stats([], 4))


@pytest.mark.parametrize("mapping", ["zero", "ideal", "lut"])
@pytest.mark.parametrize("dynamic_k", [True, False])
def test_segment_spgemm_elementwise_matches_repro(mapping, dynamic_k):
    a, ja = _csr_pair(8, (32, 28), 0.12)
    b, jb = _csr_pair(9, (28, 30), 0.12)
    got = segmentbc.segment_spgemm_elementwise(
        formats.CSC.from_csr(a), b, w_max=8, r_max=4, mapping=mapping,
        dynamic_k=dynamic_k)
    want = jseg.segment_spgemm_elementwise(
        jfmt.CSC.from_csr(ja), jb, w_max=8, r_max=4, mapping=mapping,
        dynamic_k=dynamic_k)
    same(got, want)
    np.testing.assert_allclose(got[0],
                               formats.spgemm_reference(a, b).to_dense(),
                               rtol=1e-5, atol=1e-5)


def test_vspace_routing_and_errors_match_repro():
    v, jv = segmentbc.VSpace("lut"), jseg.VSpace("lut")
    rng = np.random.default_rng(3)
    for m, n in zip(rng.integers(0, 4, 60), rng.integers(0, 50, 60)):
        assert v.route(int(m), int(n), 1.5) == jv.route(int(m), int(n), 1.5)
        if n % 3 == 0:
            v.tick()
            jv.tick()
    v.check_invariants()
    same(v.to_coo(), jv.to_coo())
    assert v.mean_displacement == jv.mean_displacement
    with pytest.raises(ValueError, match="unknown V-space mapping"):
        segmentbc.VSpace("oracle")
    row = segmentbc.VirtualRow(cols=[1, 3, 2], vals=[0.0] * 3)
    with pytest.raises(ValueError, match="column ordering violated"):
        row.check_invariants()


# ---------------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,P", [(4, 4), (16, 16), (2, 8)])
@pytest.mark.parametrize("enabled", [True, False])
def test_spatial_fold_matches_repro(R, P, enabled):
    lengths = np.random.default_rng(R * P).integers(0, 3 * P, 3 * R)
    same(folding.spatial_fold(lengths, R, P, enabled=enabled),
         jfold.spatial_fold(lengths, R, P, enabled=enabled))


@pytest.mark.parametrize("capacity", [0, 4, 16, 1000])
def test_temporal_fold_spills_matches_repro(capacity):
    lengths = np.random.default_rng(capacity).integers(0, 40, 50)
    got = folding.temporal_fold_spills(lengths, capacity)
    assert got == jfold.temporal_fold_spills(lengths, capacity)
    assert isinstance(got, int)


# ---------------------------------------------------------------------------
# schedule traffic, cost hints, dataflow estimates
# ---------------------------------------------------------------------------


def _bsr_pair(seed, shape=(256, 192), block=(32, 32), density=0.35):
    a = formats.BSR.random(np.random.default_rng(seed), shape, block,
                           density)
    return a, jfmt.BSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)


@pytest.mark.parametrize("policy,fold_len", list(itertools.product(
    ("segment", "gustavson", "outer"), (None, 3))))
@pytest.mark.parametrize("n_cols", [1, 64])
def test_spmm_schedule_traffic_matches_repro(policy, fold_len, n_cols):
    a, ja = _bsr_pair(11)
    sched = schedule.build_spmm_schedule(a, policy=policy, fold_len=fold_len)
    jsched_ = jsched.build_spmm_schedule(ja, policy=policy,
                                         fold_len=fold_len)
    assert sched.n_items == jsched_.n_items
    same(schedule.spmm_schedule_traffic(sched, 32, 32, n_cols),
         jsched.spmm_schedule_traffic(jsched_, 32, 32, n_cols))


def _spgemm_coords(a, b):
    s = schedule.build_spgemm_schedule(a, b, policy="gustavson")
    return dict(m=s.m, n=s.n, k=s.k, c=s.c_idx, a_idx=s.a_idx,
                b_idx=s.b_idx)


def test_policy_registry_matches_repro():
    assert policies.available_policies() == jpol.available_policies()
    for name in policies.available_policies():
        got, want = policies.get_policy(name), jpol.get_policy(name)
        assert got.supports_fold == want.supports_fold
        assert (got.cost_hint is None) == (want.cost_hint is None), name
    assert policies.get_policy("segment").cost_hint is None


@pytest.mark.parametrize("name", ["gustavson", "outer"])
@pytest.mark.parametrize("kind", ["spmm", "spgemm"])
def test_cost_hints_match_repro(name, kind):
    a, ja = _bsr_pair(12)
    b, jb = _bsr_pair(13, shape=(192, 160))
    if kind == "spmm":
        coords = dict(m=a.brow, k=a.bcol, bm=32, bk=32, n_cols=48)
    else:
        coords = dict(_spgemm_coords(a, b), bm=32, bk=32, bn=32)
    got = policies.get_policy(name).cost_hint(kind, **coords)
    same(got, jpol.get_policy(name).cost_hint(kind, **coords))
    assert policies.get_policy(name).cost_hint("sddmm", **coords) is None


@pytest.mark.parametrize("kind", ["spmm", "spgemm"])
@pytest.mark.parametrize("bytes_per_el", [4, 1])
def test_dataflow_estimates_match_repro(kind, bytes_per_el):
    a, _ = _bsr_pair(14)
    b, _ = _bsr_pair(15, shape=(192, 160))
    if kind == "spmm":
        kw = dict(m=a.brow, k=a.bcol, n_cols=96)
    else:
        kw = dict(_spgemm_coords(a, b), bn=32)
    got = baselines.dataflow_estimates(kind, bm=32, bk=32,
                                       bytes_per_el=bytes_per_el, **kw)
    assert sorted(got) == ["gustavson", "inner", "outer"]
    same(got, jbase.dataflow_estimates(kind, bm=32, bk=32,
                                       bytes_per_el=bytes_per_el, **kw))


def test_core_exports_repro_names():
    """Every name ``repro.core`` exports is importable from the port's
    ``core`` (which also carries the quantization names)."""
    import repro.core as jcore
    missing = [n for n in jcore.__all__ if not hasattr(core, n)]
    assert not missing, missing
    assert set(jcore.__all__) <= set(core.__all__)
