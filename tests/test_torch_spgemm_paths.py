"""The Segment SpGEMM wrapper's two CUDA paths, checked on the CPU: the work
table the tensor-core ("tc") path walks (owner runs in Z-order over C), a
plain emulation of that path's order of operations against ``repro``'s
kernel in interpret mode on shared numpy inputs, and the dispatch
function.

Tolerance: fp32 C, fp32 sums in other orders on both sides, 1e-5 (as
``tests/test_torch_spgemm.py``).  bf16 C: a stored C block (a folded
partial or the final sum) may round to the other neighbour where the two
fp32 sums straddle a bf16 rounding boundary, so the two sides agree to one
bf16 rounding of the largest value, 2**-8 of max |C|.
"""
import functools
import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.segment_spgemm import (  # noqa: E402
    segment_spgemm as jax_spgemm)

from repro_torch import api  # noqa: E402
from repro_torch.core.formats import BSR, QUANT_MODES  # noqa: E402
from repro_torch.kernels.segment_spmm import split_bf16x3  # noqa: E402

# the module (the package exports its function under the same name)
spgemm = importlib.import_module("repro_torch.kernels.segment_spgemm")

TOL = dict(rtol=1e-5, atol=1e-5)
LEAVES = ("a_idx", "b_idx", "c_idx", "seg_start", "seg_write", "accum_prev",
          "valid")
FETCH = ("a_fetch", "b_fetch", "a_slot", "b_slot")
# the five schedules of chip_smoke.py's SpGEMM edge sweep
VARIANTS = {"segment": {}, "fold": {"fold_len": 2}, "lanes": {"n_lanes": 4},
            "gustavson": {"policy": "gustavson", "n_lanes": 2, "unroll": 2},
            "outer": {"policy": "outer", "n_lanes": 2}}
# the tensor-core kernel's passes (part of A, part of B), smallest first
PASSES = {"fp32": ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)),
          "block": ((0, 0),), "rowwise": ((0, 2), (0, 1), (0, 0))}


def _pair(variant, block=64, seed=0):
    """A (6 x 5 blocks) and B (5 x 6 blocks) of 64 x 64 tiles, values scaled
    by 1/sqrt(K) so that C has unit scale and the atol means something."""
    rng = np.random.default_rng(seed)
    a = BSR.random(rng, (6 * block, 5 * block), (block, block), 0.45)
    b = BSR.random(rng, (5 * block, 6 * block), (block, block), 0.45)
    a.blocks = (a.blocks / np.sqrt(a.shape[1])).astype(np.float32)
    return a, b


@functools.lru_cache(maxsize=None)
def _plan(variant, q):
    a, b = _pair(variant)
    return api.plan_matmul(a, b, quantize=q, device="cpu",
                           **VARIANTS[variant])


# ---------------------------------------------------------------------------
# the work table
# ---------------------------------------------------------------------------


def _check_table(plan):
    arr = {f: getattr(plan, f).numpy() for f in LEAVES}
    runs = plan.run_offsets.numpy()
    run_steps, steps = spgemm.work_table(
        arr["a_idx"], arr["b_idx"], arr["c_idx"], arr["valid"],
        arr["seg_start"], arr["seg_write"], arr["accum_prev"], runs,
        plan.c_brow, plan.c_bcol)
    assert run_steps.dtype == np.int32 and steps.dtype == np.int32
    assert steps.shape[1] == 5 and run_steps.size == runs.size
    assert run_steps[0] == 0 and run_steps[-1] == steps.shape[0]
    flagged = (arr["valid"] | arr["seg_start"] | arr["seg_write"]
               | arr["accum_prev"]) != 0
    a_tile, items, b, c, flags = steps.T
    # every item with a flag appears once; pads without flags do not
    np.testing.assert_array_equal(np.sort(items), np.nonzero(flagged)[0])
    # each row carries its item's tiles, C block and flags; the A tile is
    # -1 where the item is not valid
    np.testing.assert_array_equal(
        a_tile, np.where(arr["valid"][items] != 0, arr["a_idx"][items], -1))
    np.testing.assert_array_equal(b, arr["b_idx"][items])
    np.testing.assert_array_equal(c, arr["c_idx"][items])
    np.testing.assert_array_equal(
        flags, arr["valid"][items] * spgemm.FLAG_VALID
        + arr["seg_start"][items] * spgemm.FLAG_START
        + arr["accum_prev"][items] * spgemm.FLAG_PREV
        + arr["seg_write"][items] * spgemm.FLAG_WRITE)
    # each table run is one owner run, once, its items in schedule order
    run_of = np.repeat(np.arange(runs.size - 1), np.diff(runs))
    seen = set()
    for lo, hi in zip(run_steps[:-1], run_steps[1:]):
        if lo == hi:
            continue
        mine = items[lo:hi]
        r = run_of[mine[0]]
        assert r not in seen and (run_of[mine] == r).all()
        seen.add(r)
        want = np.nonzero(flagged[runs[r]:runs[r + 1]])[0] + runs[r]
        np.testing.assert_array_equal(mine, want)
    # the runs follow the Z-order of their C blocks
    first = arr["c_idx"][items[run_steps[:-1][np.diff(run_steps) > 0]]]
    key = spgemm._morton(plan.c_brow[first].astype(np.int64),
                         plan.c_bcol[first].astype(np.int64))
    assert (np.diff(key) > 0).all()
    return run_steps, steps


@pytest.mark.parametrize("variant,q", list(itertools.product(
    VARIANTS, (None, "int8.rowwise"))))
def test_work_table_covers_each_run_once_in_order(variant, q):
    _check_table(_plan(variant, q))


def test_work_table_is_the_plans_leaf():
    plan = _plan("segment", "fp8")
    run_steps, steps = _check_table(plan)
    np.testing.assert_array_equal(plan.tc_runs.numpy(), run_steps)
    np.testing.assert_array_equal(plan.tc_steps.numpy(), steps)


def test_morton_order_interleaves_row_and_column_bits():
    row = np.array([0, 0, 1, 1, 0, 2, 3])
    col = np.array([0, 1, 0, 1, 2, 0, 3])
    np.testing.assert_array_equal(spgemm._morton(row, col),
                                  [0, 1, 2, 3, 4, 8, 15])


def test_work_table_of_an_empty_schedule():
    z = np.zeros(0, np.int32)
    run_steps, steps = spgemm.work_table(z, z, z, z, z, z, z,
                                         np.zeros(1, np.int32), z, z)
    np.testing.assert_array_equal(run_steps, [0])
    assert steps.shape == (0, 5)


# ---------------------------------------------------------------------------
# the tensor-core path's order of operations against repro's kernel
# ---------------------------------------------------------------------------


def _kind(plan):
    if not plan.quantized:
        return "fp32"
    return "rowwise" if plan.lhs_scales.ndim == 2 else "block"


def _emulate_tc(plan, out_dtype):
    """The tensor-core kernel's arithmetic, walked in its work table's
    order (runs in Z-order, each run's items in schedule order): each
    valid item's A tile and B tile split (fp32: hi/mid/lo; a payload: its
    exact bf16 values; a rowwise B dequantized by its row scales, then
    split), the passes summed in fp32 into a fresh product, promoted into
    the C block's fp32 accumulator (times A's row scales, or (p * a_scale)
    * b_scale), under the item's flags; C stored in ``out_dtype`` at each
    seg_write."""
    kind = _kind(plan)
    a_s, b_s = plan.lhs_scales, plan.rhs_scales
    qa, qb = plan.lhs_blocks.float(), plan.rhs_blocks.float()
    if kind == "rowwise":
        qb = qb * b_s[:, :, None]
    out = torch.zeros((plan.n_c_blocks, 64, 64), dtype=out_dtype)
    acc = torch.zeros(64, 64)
    for a_tile, _, b, c, fl in plan.tc_steps.numpy():
        if fl & spgemm.FLAG_START:
            acc = (out[c].float().clone() if fl & spgemm.FLAG_PREV
                   else torch.zeros(64, 64))
        if a_tile >= 0:
            ap = (split_bf16x3(qa[a_tile]) if kind == "fp32"
                  else (qa[a_tile].bfloat16(),))
            bp = (split_bf16x3(qb[b]) if kind != "block"
                  else (qb[b].bfloat16(),))
            part = torch.zeros(64, 64)
            for i, j in PASSES[kind]:
                part = part + ap[i].float() @ bp[j].float()
            if kind == "block":
                part = (part * a_s[a_tile]) * b_s[b]
            elif kind == "rowwise":
                part = part * a_s[a_tile][:, None]
            acc = acc + part
        if fl & spgemm.FLAG_WRITE:
            out[c] = acc.to(out_dtype)
    return out


def _to_jax(t):
    """A payload tensor as a jax array of the same dtype (fp8 through its
    bits)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@functools.lru_cache(maxsize=None)
def _repro(variant, q, out_name):
    plan = _plan(variant, q)
    args = [_to_jax(plan.lhs_blocks), _to_jax(plan.rhs_blocks)]
    args += [jnp.asarray(getattr(plan, f).numpy()) for f in LEAVES]
    scales = {k: None if v is None else jnp.asarray(v.numpy())
              for k, v in (("a_scales", plan.lhs_scales),
                           ("b_scales", plan.rhs_scales))}
    fetch = {f: jnp.asarray(getattr(plan, f).numpy()) for f in FETCH}
    want = jax_spgemm(*args, n_c_blocks=plan.n_c_blocks,
                      n_lanes=plan.n_lanes, unroll=plan.unroll,
                      interpret=True, out_dtype=getattr(jnp, out_name),
                      **scales, **fetch)
    return np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("variant,q,out_name", list(itertools.product(
    VARIANTS, (None,) + QUANT_MODES, ("float32", "bfloat16"))))
def test_tc_numerics_match_repro_kernel(variant, q, out_name):
    plan = _plan(variant, q)
    out_dtype = getattr(torch, out_name)
    got = _emulate_tc(plan, out_dtype).float().numpy()
    want = _repro(variant, q, out_name)
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
        # the wrapper's plain version (what CPU tensors run) agrees as well
        plain = plan().numpy()
        np.testing.assert_allclose(got, plain, **TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

F32, I8, F8 = torch.float32, torch.int8, torch.float8_e4m3fn


@pytest.mark.parametrize("tiles,dtypes,scales,out,want", [
    # the main path: granite's 64 x 64 FFN tiles, fp32 and the four modes
    ((64, 64, 64), (F32, F32), (None, None), F32, "tc"),
    ((64, 64, 64), (I8, I8), (1, 1), F32, "tc"),
    ((64, 64, 64), (F8, F8), (1, 1), F32, "tc"),
    ((64, 64, 64), (I8, I8), (2, 2), F32, "tc"),
    ((64, 64, 64), (F8, F8), (2, 2), torch.bfloat16, "tc"),
    # 32-wide and non-square tiles on the CUDA cores
    ((32, 32, 32), (F32, F32), (None, None), F32, "simt"),
    ((32, 64, 32), (I8, I8), (1, 1), F32, "simt"),
    ((64, 32, 64), (F8, F8), (2, 2), torch.bfloat16, "simt"),
    ((64, 64, 32), (F32, F32), (None, None), F32, "simt"),
    ((32, 64, 64), (F32, F32), (None, None), F32, "simt"),
])
def test_choose_path_on_each_kind_of_call(tiles, dtypes, scales, out, want):
    mode = spgemm.storage_mode(*dtypes, *scales)
    assert spgemm.choose_path(*tiles, mode, out) == want
    able = spgemm.paths_for(*tiles, mode, out)
    assert able[0] == want and set(able) <= set(spgemm.PATHS)
    assert able == (("tc", "simt") if want == "tc" else ("simt",))


@pytest.mark.parametrize("tiles,dtypes,scales,out,match", [
    ((16, 16, 16), (F32, F32), (None, None), F32, "tiles"),
    ((128, 64, 64), (F32, F32), (None, None), F32, "tiles"),
    ((64, 64, 128), (I8, I8), (1, 1), F32, "tiles"),
    ((64, 64, 64), (I8, F8), (1, 1), F32, "one dtype"),
    ((64, 64, 64), (F32, F32), (1, 1), F32, "one dtype"),
    ((64, 64, 64), (I8, I8), (1, None), F32, "one dtype"),
    ((64, 64, 64), (I8, I8), (1, 2), F32, "one dtype"),
    ((64, 64, 64), (F32, F32), (None, None), torch.float16, "out_dtype"),
])
def test_choose_path_raises_where_no_path_takes_the_call(tiles, dtypes,
                                                         scales, out, match):
    mode = spgemm.storage_mode(*dtypes, *scales)
    assert spgemm.paths_for(*tiles, mode, out) == ()
    with pytest.raises(NotImplementedError, match=match):
        spgemm.choose_path(*tiles, mode, out)


def _leaves(plan):
    return (plan.lhs_blocks, plan.rhs_blocks) + tuple(
        getattr(plan, f) for f in LEAVES)


def test_forced_paths_are_checked_on_every_device():
    small = BSR.random(np.random.default_rng(2), (96, 96), (32, 32), 0.5)
    plan = api.plan_matmul(small, small, device="cpu")
    kw = dict(n_c_blocks=plan.n_c_blocks, n_lanes=plan.n_lanes,
              unroll=plan.unroll)
    with pytest.raises(ValueError, match="can take"):
        spgemm.segment_spgemm(*_leaves(plan), path="tc", **kw)
    got = spgemm.segment_spgemm(*_leaves(plan), path="simt", **kw)
    np.testing.assert_allclose(got.numpy(), plan().numpy(), **TOL)
    big = _plan("segment", "int8")
    kw = dict(n_c_blocks=big.n_c_blocks, a_scales=big.lhs_scales,
              b_scales=big.rhs_scales)
    for path in spgemm.PATHS:
        got = spgemm.segment_spgemm(*_leaves(big), path=path, **kw)
        np.testing.assert_allclose(got.numpy(), big().numpy(), **TOL)
    with pytest.raises(ValueError, match="can take"):
        spgemm.segment_spgemm(*_leaves(big), path="split", **kw)


def test_cpu_tensors_launch_nothing():
    counts = ("launches", "quantized_launches", "tc_launches",
              "simt_launches")
    for name in counts:
        setattr(spgemm.segment_spgemm, name, 0)
    for q in (None, "int8"):
        _plan("lanes", q)()
    assert all(getattr(spgemm.segment_spgemm, n) == 0 for n in counts)
