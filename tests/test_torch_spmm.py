"""The port's Segment SpMM (its plain version, which the wrapper runs on CPU
tensors), ``execute_plan`` and ``apply_plan``'s gradients against
``repro``'s ``segment_spmm`` in interpret mode, its ``spmm_ref`` oracle and
``jax.grad`` of ``repro.api.apply_plan``, on shared numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm as jax_spmm  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.formats import BSR  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.segment_spmm import segment_spmm  # noqa: E402

# fp32 outputs on both sides, summed in different orders
TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "random": ((256, 192), {}),
    "empty_rows": ((256, 192), {}),
    "fold": ((128, 384), {"fold_len": 2}),
    "multi_lane": ((256, 192), {"n_lanes": 4}),
    "unroll2": ((256, 192), {"n_lanes": 2, "unroll": 2}),
    "outer": ((256, 192), {"policy": "outer", "n_lanes": 2}),
}


def _bsr(case, seed=0):
    shape, knobs = CASES[case]
    rng = np.random.default_rng(seed)
    a = BSR.random(rng, shape, (32, 32), 0.4)
    # unit-scale values keep the atol meaningful
    a.blocks = (a.blocks / np.sqrt(shape[1])).astype(np.float32)
    if case == "empty_rows":
        keep = a.brow % 3 != 1
        a = BSR(a.shape, a.block_shape, a.brow[keep], a.bcol[keep],
                a.blocks[keep])
    return a, knobs


def _rhs(k, n, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    if dtype == "bfloat16":
        # values exactly representable in bf16 feed both packages alike
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [16, 5])          # 5: ragged N
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_matches_repro_kernel_and_oracle(case, n, dtype):
    a, knobs = _bsr(case)
    x = _rhs(a.shape[1], n, dtype)
    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    jplan = japi.plan_matmul(ja, n, **knobs)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want_kernel = np.asarray(jplan(jx, backend="interpret", bn=8))
    want_ref = np.asarray(jref.spmm_ref(
        jplan.lhs_blocks, jplan.a_brow, jplan.a_bcol, *jplan.grid, jx))

    plan = api.plan_matmul(a, n, device="cpu", **knobs)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = plan(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(plan(tx, backend="reference").numpy(),
                               want_ref, **TOL)
    # the wrapper itself, fed the plan's leaves as the kernel would be
    direct = segment_spmm(
        plan.lhs_blocks, plan.slot_idx, plan.m_idx, plan.k_idx,
        plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid, tx,
        grid_m=plan.grid_m, n_lanes=plan.n_lanes, unroll=plan.unroll)
    live = np.repeat(np.asarray(jplan.row_mask) > 0, 32)
    np.testing.assert_allclose(direct.numpy()[live], want_kernel[live], **TOL)


def test_transposed_view_rhs_and_out_dtype():
    """The sparse FFN passes x.T, a non-contiguous view."""
    a, _ = _bsr("random")
    x = _rhs(7, a.shape[1], "float32")        # (N, K)
    plan = api.plan_matmul(a, 7, device="cpu", out_dtype=torch.bfloat16)
    got = plan(torch.from_numpy(x).T)
    assert got.dtype == torch.bfloat16
    want = a.to_dense() @ x.T
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_bsr_to_dense_matches_repro():
    a, _ = _bsr("empty_rows")
    got = ref.bsr_to_dense(torch.from_numpy(a.blocks),
                           torch.from_numpy(a.brow), torch.from_numpy(a.bcol),
                           *a.grid)
    want = jref.bsr_to_dense(jnp.asarray(a.blocks), jnp.asarray(a.brow),
                             jnp.asarray(a.bcol), *a.grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick_bn_matches_repro():
    from repro.api.executor import pick_bn as jax_pick_bn
    for n in (1, 4, 5, 16, 64, 100, 256, 640, 1000):
        for bn in (8, 128, 512):
            assert api.pick_bn(n, bn) == jax_pick_bn(n, bn)


def test_jax_kernel_direct_call_matches():
    """``repro``'s Pallas kernel called directly on the port's plan leaves."""
    a, knobs = _bsr("unroll2")
    x = _rhs(a.shape[1], 8, "float32")
    plan = api.plan_matmul(a, 8, device="cpu", **knobs)
    leaves = {f: jnp.asarray(getattr(plan, f).numpy()) for f in (
        "slot_idx", "m_idx", "k_idx", "seg_start", "seg_write", "accum_prev",
        "valid", "a_fetch", "b_fetch", "a_slot", "b_slot")}
    want = np.asarray(jax_spmm(
        jnp.asarray(a.blocks), leaves["slot_idx"], leaves["m_idx"],
        leaves["k_idx"], leaves["seg_start"], leaves["seg_write"],
        leaves["accum_prev"], leaves["valid"], jnp.asarray(x),
        grid_m=plan.grid_m, n_lanes=plan.n_lanes, bn=8, unroll=plan.unroll,
        masked=plan.has_pads, interpret=True, a_fetch=leaves["a_fetch"],
        b_fetch=leaves["b_fetch"], a_slot=leaves["a_slot"],
        b_slot=leaves["b_slot"]))
    got = plan(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [{"a_scales": torch.ones(1)}])
def test_unported_kernel_modes_raise(kw):
    a, _ = _bsr("random")
    plan = api.plan_matmul(a, 4, device="cpu")
    with pytest.raises(NotImplementedError):
        segment_spmm(plan.lhs_blocks, plan.slot_idx, plan.m_idx, plan.k_idx,
                     plan.seg_start, plan.seg_write, plan.accum_prev,
                     plan.valid, torch.zeros(a.shape[1], 4),
                     grid_m=plan.grid_m, **kw)


@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("direction", ["forward", "grad"])
def test_cross_pass_plans_run_as_drained(direction, quantize):
    """``prefetch="cross_pass"`` only times the TPU's DMAs: such a plan
    gives the drained plan's result bit for bit, forward and for dx
    through ``apply_plan``'s grad plan, and matches ``repro``'s
    ``execute_plan`` / ``jax.grad`` of ``apply_plan`` with the same
    prefetch on the interpret backend (N = 16 over bn = 8: two passes, so
    the next pass's early fetch happens there)."""
    a, _ = _bsr("random")
    n = 16
    knobs = dict(with_grad=True, quantize=quantize, n_lanes=2)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, a.shape[1])).astype(np.float32)   # (N, K)
    ct = rng.standard_normal((a.shape[0], n)).astype(np.float32)
    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    jplan = japi.plan_matmul(ja, n, prefetch="cross_pass", **knobs)

    def run(plan):
        tx = torch.from_numpy(x).requires_grad_(direction == "grad")
        y = api.apply_plan(plan, tx.T, blocks=plan.lhs_blocks,
                           scales=plan.lhs_scales)
        if direction == "forward":
            return y.detach()
        (y * torch.from_numpy(ct)).sum().backward()
        return tx.grad

    drained = api.plan_matmul(a, n, device="cpu", **knobs)
    cross = api.plan_matmul(a, n, device="cpu", prefetch="cross_pass",
                            **knobs)
    assert cross.prefetch == cross.grad_plan.prefetch == "cross_pass"
    got = run(cross)
    assert torch.equal(got, run(drained))
    if direction == "forward":
        want = np.asarray(japi.execute_plan(jplan, jnp.asarray(x).T,
                                            backend="interpret", bn=8))
    else:
        def loss(xx):
            y = japi.apply_plan(jplan, xx.T, backend="interpret", bn=8)
            return jnp.sum(y * jnp.asarray(ct))
        want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


_GRAD_LEAVES = ("slot_idx", "m_idx", "k_idx", "seg_start", "seg_write",
                "accum_prev", "valid", "a_fetch", "b_fetch", "a_slot",
                "b_slot")


@pytest.mark.parametrize("case", ["random", "empty_rows", "fold",
                                  "multi_lane", "unroll2"])
@pytest.mark.parametrize("n", [16, 5])          # 5: ragged N
def test_transposed_spmm_matches_repro_kernel_and_oracle(case, n):
    """``transpose_lhs``: ``Wᵀ @ dy`` under the grad plan, against the
    forward storage, as ``apply_plan``'s backward runs it."""
    a, knobs = _bsr(case)
    dy = _rhs(a.shape[0], n, "float32", seed=4)
    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    jplan = japi.plan_matmul(ja, n, with_grad=True, **knobs)
    g = jplan.grad_plan
    leaves = {f: getattr(g, f) for f in _GRAD_LEAVES}
    want_kernel = np.asarray(jax_spmm(
        jplan.lhs_blocks, *(leaves[f] for f in _GRAD_LEAVES[:7]),
        jnp.asarray(dy), grid_m=g.grid[0], n_lanes=g.n_lanes,
        bn=8 if n % 8 == 0 else n,
        unroll=g.unroll, transpose_lhs=True, masked=g.has_pads,
        interpret=True, a_fetch=leaves["a_fetch"], b_fetch=leaves["b_fetch"],
        a_slot=leaves["a_slot"], b_slot=leaves["b_slot"]))
    want_ref = np.asarray(jref.spmm_ref(
        jplan.lhs_blocks, jplan.a_brow, jplan.a_bcol, *jplan.grid,
        jnp.asarray(dy), transpose_lhs=True))

    plan = api.plan_matmul(a, n, device="cpu", with_grad=True, **knobs)
    gp = plan.grad_plan.with_values(plan.lhs_blocks)
    tdy = torch.from_numpy(dy)
    live = np.repeat(np.asarray(g.row_mask) > 0, 32)
    direct = segment_spmm(
        plan.lhs_blocks, gp.slot_idx, gp.m_idx, gp.k_idx, gp.seg_start,
        gp.seg_write, gp.accum_prev, gp.valid, tdy, grid_m=gp.grid_m,
        n_lanes=gp.n_lanes, unroll=gp.unroll, transpose_lhs=True).numpy()
    np.testing.assert_allclose(direct[live], want_kernel[live], **TOL)
    got = gp(tdy).numpy()       # rows no item visits: zeroed
    np.testing.assert_allclose(got[live], want_kernel[live], **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(gp(tdy, backend="reference").numpy(),
                               want_ref, **TOL)
    np.testing.assert_allclose(
        ref.spmm_ref(plan.lhs_blocks, plan.a_brow, plan.a_bcol, *plan.grid,
                     tdy, transpose_lhs=True).numpy(), want_ref, **TOL)


def test_transposed_spmm_checks_the_contraction_block():
    """In the transposed mode B's K is a multiple of ``bm``, not ``bk``."""
    a = BSR.random(np.random.default_rng(2), (96, 128), (32, 32), 0.5)
    plan = api.plan_matmul(a, 4, device="cpu", with_grad=True)
    gp = plan.grad_plan
    args = (plan.lhs_blocks[:, :, :16].contiguous(), gp.slot_idx, gp.m_idx,
            gp.k_idx, gp.seg_start, gp.seg_write, gp.accum_prev, gp.valid)
    # (32, 16) tiles: the transposed contraction runs over their 32 rows
    got = segment_spmm(*args, torch.ones(96, 3), grid_m=gp.grid_m,
                       transpose_lhs=True)
    assert got.shape == (gp.grid_m * 16, 3)
    with pytest.raises(ValueError, match="contraction block 32"):
        segment_spmm(*args, torch.ones(80, 3), grid_m=gp.grid_m,
                     transpose_lhs=True)


@pytest.mark.parametrize("case", ["random", "empty_rows", "fold",
                                  "multi_lane", "unroll2"])
def test_apply_plan_grads_match_repro(case):
    """dx and dW of ``apply_plan`` against ``jax.grad`` of
    ``repro.api.apply_plan`` on its reference and interpret backends, and
    against the dense gradients.  ``x`` goes in as a transposed view, as in
    the sparse FFN, so dy comes back as one too."""
    a, knobs = _bsr(case)
    n = 6
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, a.shape[1])).astype(np.float32)   # (N, K)
    ct = rng.standard_normal((a.shape[0], n)).astype(np.float32)

    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    jplan = japi.plan_matmul(ja, n, with_grad=True, **knobs)
    want = {}
    for backend in ("reference", "interpret"):
        def loss(blocks, xx, backend=backend):
            y = japi.apply_plan(jplan.with_values(blocks), xx.T,
                                backend=backend, bn=8)
            return jnp.sum(y * jnp.asarray(ct))
        gb, gx = jax.grad(loss, argnums=(0, 1))(jplan.lhs_blocks,
                                                  jnp.asarray(x))
        want[backend] = (np.asarray(gb), np.asarray(gx))

    plan = api.plan_matmul(a, n, device="cpu", with_grad=True, **knobs)
    for backend in ("cuda", "reference"):
        blocks = plan.lhs_blocks.clone().requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        y = api.apply_plan(plan, tx.T, blocks=blocks, backend=backend)
        (y * torch.from_numpy(ct)).sum().backward()
        for w in want.values():
            np.testing.assert_allclose(blocks.grad.numpy(), w[0], **TOL)
            np.testing.assert_allclose(tx.grad.numpy(), w[1], **TOL)
        # dense: dW = ct @ x masked to the pattern, dx = Wᵀ @ ct
        gw = ct @ x
        dense_gb = np.stack([gw[r * 32:(r + 1) * 32, c * 32:(c + 1) * 32]
                             for r, c in zip(a.brow, a.bcol)])
        np.testing.assert_allclose(blocks.grad.numpy(), dense_gb, **TOL)
        np.testing.assert_allclose(tx.grad.numpy(),
                                   (a.to_dense().T @ ct).T, **TOL)


def test_apply_plan_grads_keep_input_dtypes():
    """bf16 activations get a bf16 dx; fp32 blocks an fp32 dW."""
    a, _ = _bsr("random")
    plan = api.plan_matmul(a, 4, device="cpu", with_grad=True)
    blocks = plan.lhs_blocks.clone().requires_grad_(True)
    x = torch.from_numpy(_rhs(a.shape[1], 4, "bfloat16")).bfloat16()
    x.requires_grad_(True)
    api.apply_plan(plan, x, blocks=blocks).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert blocks.grad.dtype == torch.float32


def test_backward_without_grad_plan_raises():
    a, _ = _bsr("random")
    plan = api.plan_matmul(a, 4, device="cpu")          # no with_grad
    blocks = plan.lhs_blocks.clone().requires_grad_(True)
    y = api.apply_plan(plan.with_values(blocks), torch.ones(a.shape[1], 4))
    with pytest.raises(ValueError, match="with_grad"):
        y.sum().backward()


def test_apply_plan_takes_blocks_of_a_shared_plan():
    """Layers sharing one plan pass their own blocks to ``apply_plan``."""
    a, _ = _bsr("fold")
    plan = api.plan_matmul(a, 6, device="cpu", fold_len=2)
    other = torch.from_numpy(np.random.default_rng(3).standard_normal(
        a.blocks.shape).astype(np.float32))
    x = torch.from_numpy(_rhs(a.shape[1], 6, "float32"))
    got = api.apply_plan(plan, x, blocks=other)
    b = BSR(a.shape, a.block_shape, a.brow, a.bcol, other.numpy())
    np.testing.assert_allclose(got.numpy(), b.to_dense() @ x.numpy(), **TOL)
    with pytest.raises(ValueError, match="blocks has shape"):
        api.apply_plan(plan, x, blocks=other[1:])
