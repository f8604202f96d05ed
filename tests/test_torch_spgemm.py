"""The port's SpGEMM slice against ``repro`` on shared numpy inputs: the
symbolic phase and the triple schedules array for array, ``plan_matmul(A,
B)`` leaf for leaf with its traffic across the knob grid (fp32 and the four
quantized modes), ``plan()`` on the ``"cuda"`` backend (the kernel's plain
version, which the wrapper runs on CPU tensors) and on ``"reference"``
against ``repro``'s interpret and reference backends, the wrapper against
``repro``'s ``segment_spgemm(..., interpret=True)``, and ``repro``'s named
errors."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api.plan import _AUX_FIELDS, _LEAF_FIELDS  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402
from repro.core.formats import QUANT_MODES  # noqa: E402
from repro.kernels.segment_spgemm import (  # noqa: E402
    segment_spgemm as jax_spgemm)

from repro_torch import api  # noqa: E402
from repro_torch.api import executor  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.core.formats import BSR, quantize_blocks  # noqa: E402
from repro_torch.kernels.segment_spgemm import (  # noqa: E402
    segment_spgemm, segment_spgemm_plain)

# fp32 on both sides, summed in other orders, on unit-scale blocks
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = (None,) + QUANT_MODES


def _pair(block_a=(32, 32), block_b=(32, 32), seed=0, density=0.4,
          shapes=((256, 320), (320, 192))):
    """A and B from one seed each, values scaled by 1/sqrt(K) so that C has
    unit scale and the atol means something."""
    a = BSR.random(np.random.default_rng(seed), shapes[0], block_a, density)
    b = BSR.random(np.random.default_rng(seed + 1), shapes[1], block_b,
                   density)
    k = shapes[0][1]
    a.blocks = (a.blocks / np.sqrt(k)).astype(np.float32)
    return a, b


def _jax(m: BSR) -> JaxBSR:
    return JaxBSR(m.shape, m.block_shape, m.brow, m.bcol, m.blocks)


def _np(x):
    """A leaf of either package as numpy; fp8 payloads as their bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _assert_same_plan(got, want):
    for f in _AUX_FIELDS:
        if f in ("fingerprint", "backend"):
            continue      # the digest keys on each package's policy serial
        assert getattr(got, f) == getattr(want, f), f
    for f in _LEAF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            g, w = _np(g), _np(w)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("policy,fold_len", list(itertools.product(
    ("segment", "gustavson", "outer"), (None, 2))))
def test_symbolic_and_schedule_match_repro(policy, fold_len):
    a, b = _pair(density=0.3)
    brow, bcol = schedule.symbolic_spgemm(a.block_mask(), b.block_mask())
    jbrow, jbcol = jsched.symbolic_spgemm(_jax(a).block_mask(),
                                          _jax(b).block_mask())
    np.testing.assert_array_equal(brow, jbrow)
    np.testing.assert_array_equal(bcol, jbcol)
    got = schedule.build_spgemm_schedule(a, b, policy, fold_len=fold_len)
    want = jsched.build_spgemm_schedule(_jax(a), _jax(b), policy,
                                        fold_len=fold_len)
    for f in ("m", "n", "k", "a_idx", "b_idx", "c_idx", "seg_start",
              "seg_write", "c_brow", "c_bcol"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.n_items == want.n_items and got.n_c_blocks == want.n_c_blocks
    assert (schedule.spgemm_schedule_traffic(got, 32, 32, 32)
            == jsched.spgemm_schedule_traffic(want, 32, 32, 32))


@pytest.mark.parametrize("policy,fold_len,n_lanes,unroll", list(
    itertools.product(("segment", "gustavson", "outer"), (None, 2), (1, 4),
                      (1, 2))))
def test_plan_leaves_and_traffic_match_repro(policy, fold_len, n_lanes,
                                             unroll):
    a, b = _pair(density=0.3)
    kw = dict(policy=policy, fold_len=fold_len, n_lanes=n_lanes,
              unroll=unroll)
    for q in MODES:
        got = api.plan_matmul(a, b, device="cpu", quantize=q, **kw)
        want = japi.plan_matmul(_jax(a), _jax(b), quantize=q, **kw)
        _assert_same_plan(got, want)
        assert got.traffic_items == want.traffic_items
        assert got.quantized == want.quantized and got.n_c_blocks == \
            want.n_c_blocks
        np.testing.assert_array_equal(got.c_brow, want.c_brow)
        np.testing.assert_array_equal(got.c_bcol, want.c_bcol)
        # the port's extra leaf: one run per C block, every run one owner
        offs = got.run_offsets.numpy()
        assert offs[0] == 0 and offs[-1] == got.n_items
        assert got.n_runs == got.n_c_blocks
        c = got.c_idx.numpy()
        for lo, hi in zip(offs[:-1], offs[1:]):
            assert (c[lo:hi] == c[lo]).all()


@pytest.mark.parametrize("q", MODES)
@pytest.mark.parametrize("knobs", [
    {}, {"policy": "outer", "n_lanes": 2}, {"fold_len": 2, "n_lanes": 4},
    {"policy": "gustavson", "n_lanes": 2, "unroll": 2}])
def test_plan_results_match_repro_backends(q, knobs):
    a, b = _pair()
    plan = api.plan_matmul(a, b, device="cpu", quantize=q, **knobs)
    jplan = japi.plan_matmul(_jax(a), _jax(b), quantize=q, **knobs)
    want_kernel = np.asarray(jplan(backend="interpret"))
    want_ref = np.asarray(jplan(backend="reference"))
    got = plan()
    assert got.dtype == torch.float32 and got.shape == want_kernel.shape
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(plan(backend="reference").numpy(), want_ref,
                               **TOL)


@pytest.mark.parametrize("q", [None, "int8", "fp8.rowwise"])
def test_mixed_block_sizes_in_the_plain_version(q):
    """(32, 64) A tiles against (64, 32) B tiles: the CUDA kernel takes
    square tiles only, its plain version any."""
    a, b = _pair((32, 64), (64, 32), seed=3)
    plan = api.plan_matmul(a, b, device="cpu", quantize=q, n_lanes=2)
    jplan = japi.plan_matmul(_jax(a), _jax(b), quantize=q, n_lanes=2)
    got = plan().numpy()
    assert got.shape == (plan.n_c_blocks, 32, 32)
    np.testing.assert_allclose(got, np.asarray(jplan(backend="interpret")),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(jplan(backend="reference")),
                               **TOL)
    want = a.to_dense() @ b.to_dense()
    if q is None:
        for i, (r, c) in enumerate(zip(plan.c_brow, plan.c_bcol)):
            np.testing.assert_allclose(
                got[i], want[r * 32:(r + 1) * 32, c * 32:(c + 1) * 32],
                **TOL)


def _leaves(plan):
    return (plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx,
            plan.c_idx, plan.seg_start, plan.seg_write, plan.accum_prev,
            plan.valid)


@pytest.mark.parametrize("q", [None, "int8", "int8.rowwise"])
def test_wrapper_matches_repro_kernel_direct_call(q):
    a, b = _pair(seed=5)
    plan = api.plan_matmul(a, b, device="cpu", quantize=q, n_lanes=2,
                           unroll=2, fold_len=2)
    got = segment_spgemm(*_leaves(plan), n_c_blocks=plan.n_c_blocks,
                         n_lanes=plan.n_lanes, unroll=plan.unroll,
                         a_scales=plan.lhs_scales, b_scales=plan.rhs_scales,
                         prefetch="cross_pass")
    jargs = [jnp.asarray(t.numpy()) for t in _leaves(plan)]
    fetch = {f: jnp.asarray(getattr(plan, f).numpy())
             for f in ("a_fetch", "b_fetch", "a_slot", "b_slot")}
    scales = {k: None if v is None else jnp.asarray(v.numpy())
              for k, v in (("a_scales", plan.lhs_scales),
                           ("b_scales", plan.rhs_scales))}
    want = jax_spgemm(*jargs, n_c_blocks=plan.n_c_blocks,
                      n_lanes=plan.n_lanes, unroll=plan.unroll,
                      interpret=True, **scales, **fetch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = segment_spgemm_plain(
        plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx,
        plan.c_idx, plan.valid, n_c_blocks=plan.n_c_blocks,
        a_scales=plan.lhs_scales, b_scales=plan.rhs_scales, chunk=7)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **TOL)


# ---------------------------------------------------------------------------
# repro's named-error battery (tests/test_analysis.py), on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gplan():
    a = BSR.random(np.random.default_rng(7), (128, 128), (32, 32), 0.5)
    b = BSR.random(np.random.default_rng(8), (128, 128), (32, 32), 0.5)
    return api.plan_matmul(a, b, n_lanes=2, cache=False, device="cpu")


def _call(args, plan, **kw):
    kw.setdefault("n_c_blocks", plan.n_out_blocks)
    return segment_spgemm(*args, n_lanes=plan.n_lanes, **kw)


def test_spgemm_rejects_contraction_mismatch(gplan):
    args = list(_leaves(gplan))
    args[1] = torch.zeros((gplan.rhs_blocks.shape[0], 16, 32))
    with pytest.raises(ValueError, match=r"contraction blocks disagree"):
        _call(args, gplan)


def test_spgemm_rejects_empty_output_with_work(gplan):
    with pytest.raises(ValueError, match=r"n_c_blocks=0 with a non-empty"):
        _call(_leaves(gplan), gplan, n_c_blocks=0)


def test_spgemm_rejects_length_mismatch(gplan):
    args = list(_leaves(gplan))
    args[3] = gplan.b_idx[:-1]
    with pytest.raises(ValueError, match=r"b_idx has shape"):
        _call(args, gplan)


@pytest.mark.parametrize("side,shape", [("a_scales", (3,)),
                                        ("b_scales", (2, 7))])
def test_spgemm_rejects_scale_shapes(gplan, side, shape):
    with pytest.raises(ValueError, match=side + r" has shape"):
        _call(_leaves(gplan), gplan, **{side: torch.ones(shape)})


def test_spgemm_rejects_unknown_prefetch_and_lane_split(gplan):
    with pytest.raises(ValueError, match=r"prefetch='ahead'"):
        _call(_leaves(gplan), gplan, prefetch="ahead")
    with pytest.raises(ValueError, match=r"not divisible by n_lanes"):
        segment_spgemm(*_leaves(gplan), n_c_blocks=gplan.n_out_blocks,
                       n_lanes=gplan.n_items + 1)


# ---------------------------------------------------------------------------
# edges of the entry points
# ---------------------------------------------------------------------------


def test_empty_symbolic_c_returns_no_blocks_without_a_launch(monkeypatch):
    ones = np.ones((2, 32, 32), np.float32)
    a = BSR((64, 64), (32, 32), np.array([0, 1], np.int32),
            np.array([0, 0], np.int32), ones)
    b = BSR((64, 64), (32, 32), np.array([1], np.int32),
            np.array([0], np.int32), ones[:1])

    def no_kernel(*args, **kw):
        raise AssertionError("the kernel was called for an empty C")

    monkeypatch.setattr(executor, "segment_spgemm", no_kernel)
    for q in (None, "int8"):
        plan = api.plan_matmul(a, b, quantize=q, device="cpu")
        jplan = japi.plan_matmul(_jax(a), _jax(b), quantize=q)
        assert plan.n_out_blocks == 0 and plan.n_items == 0
        assert plan.n_runs == jplan.n_items == 0
        for backend in ("cuda", "reference"):
            out = plan(backend=backend)
            assert tuple(out.shape) == (0, 32, 32)


def test_single_block_spgemm():
    rng = np.random.default_rng(20)
    one = BSR((32, 32), (32, 32), np.zeros(1, np.int32),
              np.zeros(1, np.int32),
              (rng.standard_normal((1, 32, 32)) / np.sqrt(32)).astype(
                  np.float32))
    plan = api.plan_matmul(one, one, device="cpu", n_lanes=4)
    assert plan.n_lanes == 1 and plan.n_items == 1 and plan.n_runs == 1
    np.testing.assert_allclose(plan()[0].numpy(),
                               one.to_dense() @ one.to_dense(), **TOL)


def test_spgemm_rejects_grad_and_apply_plan():
    a, b = _pair()
    with pytest.raises(NotImplementedError, match="only supported for SpMM"):
        api.plan_matmul(a, b, with_grad=True, device="cpu")
    plan = api.plan_matmul(a, b, device="cpu")
    with pytest.raises(ValueError, match="spmm"):
        api.apply_plan(plan, torch.zeros((a.shape[1], 32)))
    with pytest.raises(ValueError, match="takes no right-hand side"):
        plan(torch.zeros((a.shape[1], 32)))
    with pytest.raises(ValueError, match="unknown quantize dtype"):
        api.plan_matmul(a, b, quantize="int4", device="cpu")


def test_quantized_plans_are_their_own_cache_entries():
    api.clear_plan_cache()
    a, b = _pair()
    plans = {q: api.plan_matmul(a, b, quantize=q, device="cpu")
             for q in MODES}
    api.plan_matmul(a, b, quantize="int8", device="cpu")
    stats = api.plan_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == stats["size"] == 5
    assert stats["by_dtype"] == {"fp32": 1, "int8": 1, "fp8": 1,
                                 "int8.rowwise": 1, "fp8.rowwise": 1}
    assert len({p.fingerprint for p in plans.values()}) == 5
    assert plans["int8"].lhs_blocks.dtype == torch.int8
    assert plans["fp8"].rhs_blocks.dtype == torch.float8_e4m3fn
    assert tuple(plans["int8.rowwise"].rhs_scales.shape) == (
        b.nblocks, b.block_shape[0])


def test_pre_quantized_blocks_are_taken_verbatim():
    a, b = _pair()
    qa, qb = quantize_blocks(a.blocks, "fp8"), quantize_blocks(b.blocks,
                                                               "fp8")
    pa = BSR(a.shape, a.block_shape, a.brow, a.bcol, qa)
    pb = BSR(b.shape, b.block_shape, b.brow, b.bcol, qb)
    plan = api.plan_matmul(pa, pb, quantize="fp8", device="cpu")
    assert torch.equal(plan.lhs_blocks.view(torch.uint8),
                       qa.payload.view(torch.uint8))
    assert torch.equal(plan.rhs_scales, qb.scales)
    ref = api.plan_matmul(a, b, quantize="fp8", device="cpu")
    np.testing.assert_array_equal(plan().numpy(), ref().numpy())
    with pytest.raises(ValueError, match="pre-quantized blocks are 'fp8'"):
        api.plan_matmul(pa, pb, quantize="int8", device="cpu")


def test_with_values_checks_the_storage_dtype():
    a, b = _pair()
    plan = api.plan_matmul(a, b, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="stores int8 payloads"):
        plan.with_values(plan.lhs_blocks.float())
    fp = api.plan_matmul(a, b, device="cpu")
    with pytest.raises(ValueError, match="quantized payload dtype"):
        fp.with_values(fp.lhs_blocks, plan.rhs_blocks)
    # new values of the right format: the same schedule, new C
    doubled = fp.with_values(fp.lhs_blocks * 2)
    np.testing.assert_allclose(doubled().numpy(), 2 * fp().numpy(), **TOL)
    q2 = plan.with_values(plan.lhs_blocks, lhs_scales=plan.lhs_scales * 2)
    np.testing.assert_allclose(q2().numpy(), 2 * plan().numpy(), **TOL)
