"""The port's patterns and SpMM plans against ``repro``'s, leaf for leaf.

Same numpy seed → same ``BSR.random`` matrix; same BSR and knobs → every
plan leaf (forward and transposed backward schedule) equal elementwise,
and the same static fields and traffic estimate.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api.plan import _AUX_FIELDS, _LEAF_FIELDS  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.formats import BSR  # noqa: E402
from repro_torch.core.schedule import check_lane_accum  # noqa: E402
from repro_torch.kernels.segment_spmm import run_offsets  # noqa: E402


@pytest.mark.parametrize("seed,shape,block,density", [
    (0, (512, 768), (32, 32), 0.4),
    (3, (12800, 4096), (64, 64), 0.25),
    (5, (64, 64), (32, 32), 0.0),       # empty mask: one block forced
])
def test_bsr_random_matches_repro(seed, shape, block, density):
    a = BSR.random(np.random.default_rng(seed), shape, block, density)
    b = JaxBSR.random(np.random.default_rng(seed), shape, block, density)
    for f in ("brow", "bcol", "blocks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape and a.block_shape == b.block_shape
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())


def _pattern():
    """Rows long enough to fold at 8, and a few empty block rows."""
    a = BSR.random(np.random.default_rng(7), (512, 768), (32, 32), 0.45)
    keep = a.brow % 5 != 2
    return BSR(a.shape, a.block_shape, a.brow[keep], a.bcol[keep],
               a.blocks[keep])


def _assert_same_plan(got, want, path="plan"):
    for f in _AUX_FIELDS:
        if f in ("fingerprint", "backend"):
            continue      # the digest keys on each package's policy serial
        assert getattr(got, f) == getattr(want, f), f"{path}.{f}"
    for f in _LEAF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "grad_plan":
            assert (g is None) == (w is None), f"{path}.{f}"
            if w is not None:
                _assert_same_plan(g, w, path + ".grad_plan")
            continue
        assert (g is None) == (w is None), f"{path}.{f}"
        if w is not None:
            w = np.asarray(w)
            g = g.numpy()
            assert g.dtype == w.dtype, f"{path}.{f}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}.{f}")


@pytest.mark.parametrize("policy,fold_len,n_lanes,unroll", list(
    itertools.product(("segment", "gustavson", "outer"), (None, 8),
                      (1, 2, 4), (1, 2))))
def test_plan_leaves_match_repro(policy, fold_len, n_lanes, unroll):
    a = _pattern()
    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    kw = dict(policy=policy, fold_len=fold_len, n_lanes=n_lanes,
              unroll=unroll, with_grad=True)
    got = api.plan_matmul(a, 48, device="cpu", **kw)
    want = japi.plan_matmul(ja, 48, **kw)
    _assert_same_plan(got, want)
    # the port's extra leaf: one run per live block row, in lane order
    offs = got.run_offsets.numpy()
    assert offs[0] == 0 and offs[-1] == got.n_items
    assert got.n_runs == int(np.asarray(want.row_mask).sum())
    m = got.m_idx.numpy()
    for lo, hi in zip(offs[:-1], offs[1:]):
        assert (m[lo:hi] == m[lo]).all()


def test_plan_cache_hits_on_same_pattern():
    api.clear_plan_cache()
    a = _pattern()
    p1 = api.plan_matmul(a, 16, device="cpu")
    p2 = api.plan_matmul(a, 16, device="cpu")
    assert api.plan_cache_stats() == {"hits": 1, "misses": 1, "size": 1}
    assert p1.slot_idx is p2.slot_idx     # leaves uploaded once per device


def test_run_offsets_reject_split_owner():
    with pytest.raises(ValueError, match="two non-contiguous runs"):
        run_offsets(np.array([0, 0, 1, 0], np.int32), 1)
    np.testing.assert_array_equal(
        run_offsets(np.array([3, 3, 1, 5, 5, 5], np.int32), 2), [0, 2, 3, 6])


def test_check_lane_accum_flags_read_before_write():
    owner = np.array([0, 0, 1, 0])
    seg_start = np.array([1, 0, 1, 1])
    seg_write = np.array([0, 1, 1, 1])
    ok = np.array([0, 0, 0, 1])
    assert check_lane_accum(owner, seg_start, seg_write, ok, np.ones(4), 1) == []
    # the continuation lands in another lane than its tile's first write
    bad = check_lane_accum(owner, seg_start, seg_write, ok, np.ones(4), 2)
    assert len(bad) == 1 and "accum_prev=1" in bad[0]


@pytest.mark.parametrize("kw", [{"policy": "auto"}, {"verify": True},
                                {"vmem_limit_bytes": 1 << 20},
                                {"quantize": "int8"}])
def test_unported_planner_knobs_raise(kw):
    with pytest.raises(NotImplementedError):
        api.plan_matmul(_pattern(), 16, device="cpu", **kw)
