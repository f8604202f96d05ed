"""The Segment SpMM wrapper's three CUDA paths, checked on the CPU: the
chunk table the folded ("split") path launches from, the exact three-way
bf16 split the tensor-core ("tc") path multiplies, plain emulations of
both paths' order of operations against ``repro``'s kernel in interpret
mode on shared numpy inputs, and the dispatch function.

Tolerance: fp32 sums in other orders on both sides, 1e-5 (as
``tests/test_torch_spmm.py``).  The split is checked bit for bit.
"""
import dataclasses
import functools
import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm as jax_spmm  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.formats import BSR, QUANT_MODES  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.sparse_ffn import SparseMLP  # noqa: E402

# the module (the package exports its function under the same name)
spmm = importlib.import_module("repro_torch.kernels.segment_spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
SCHED = ("slot_idx", "m_idx", "k_idx", "seg_start", "seg_write",
         "accum_prev", "valid")
FETCH = ("a_fetch", "b_fetch", "a_slot", "b_slot")
# the schedules chip_smoke.py's edge sweep runs (static-order = "outer")
VARIANTS = {"plain": {}, "fold": {"fold_len": 2},
            "lanes_unroll": {"n_lanes": 4, "unroll": 2},
            "outer": {"policy": "outer", "n_lanes": 2}, "holes": {}}


def _bsr(variant, block=64, seed=0):
    a = BSR.random(np.random.default_rng(seed), (12 * block, 9 * block),
                   (block, block), 0.35)
    a.blocks = (a.blocks / np.sqrt(a.shape[1])).astype(np.float32)
    if variant == "holes":
        keep = a.brow % 3 != 1
        a = BSR(a.shape, a.block_shape, a.brow[keep], a.bcol[keep],
                a.blocks[keep])
    return a


# ---------------------------------------------------------------------------
# the chunk table
# ---------------------------------------------------------------------------


def _check_chunks(plan, c):
    runs = plan.run_offsets.numpy()
    table = spmm.chunk_offsets(runs, c)
    assert table.dtype == np.int32 and table.shape[1] == 4
    lo, hi, first, count = table.T
    # the chunks tile the schedule in order, none empty or longer than c
    assert lo[0] == 0 and hi[-1] == plan.n_items
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    assert ((hi - lo >= 1) & (hi - lo <= c)).all()
    run_of = np.searchsorted(runs, lo, side="right") - 1
    # every chunk lies inside one run ...
    assert (hi <= runs[run_of + 1]).all()
    m = plan.m_idx.numpy()
    for a, b in zip(lo, hi):
        assert (m[a:b] == m[a]).all()
    # ... and a run's chunks are consecutive rows that cover it in order
    for r in range(runs.size - 1):
        rows = np.nonzero(run_of == r)[0]
        assert rows.size == max(1, -(-(runs[r + 1] - runs[r]) // c))
        np.testing.assert_array_equal(rows, np.arange(rows[0],
                                                      rows[-1] + 1))
        assert lo[rows[0]] == runs[r] and hi[rows[-1]] == runs[r + 1]
        assert (first[rows] == rows[0]).all() and (count[rows] == rows.size
                                                   ).all()
        if runs[r + 1] - runs[r] <= c:
            assert rows.size == 1


@pytest.mark.parametrize("variant,direction,c", list(itertools.product(
    VARIANTS, ("forward", "grad"), (1, 3, spmm.CHUNK_ITEMS))))
def test_chunk_offsets_on_edge_schedules(variant, direction, c):
    plan = api.plan_matmul(_bsr(variant), 16, device="cpu", with_grad=True,
                           **VARIANTS[variant])
    sched = plan.grad_plan if direction == "grad" else plan
    _check_chunks(sched, c)
    if c == spmm.CHUNK_ITEMS:
        # the planner stores the table with the default chunk length
        np.testing.assert_array_equal(sched.chunk_offsets.numpy(),
                                      spmm.chunk_offsets(
                                          sched.run_offsets.numpy()))


def _granite_ffn_plans():
    """Forward and grad plans of granite-3-8b's reduced FFN (the model's
    layer 0), and of one FFN at granite's block size and density with its
    widths cut by 8."""
    cfg = dataclasses.replace(reduced_config(get_config("granite-3-8b")),
                              dtype="float32", ffn_block_sparse=True,
                              ffn_block=32)
    model = build_model(cfg, device="cpu")
    mlp = SparseMLP.create(3, 4096 // 8, 12800 // 8, block=64, density=0.25,
                           device="cpu")
    out = {}
    for name, m in (("reduced", model.layers[0].mlp), ("eighth", mlp)):
        for proj in ("up", "gate", "down"):
            plan = getattr(m, proj).plan
            out[f"{name} {proj}"] = plan
            out[f"{name} {proj} grad"] = plan.grad_plan
    return out


@pytest.mark.parametrize("c", (1, 5, spmm.CHUNK_ITEMS, 64))
def test_chunk_offsets_on_granite_ffn_plans(c):
    for plan in _granite_ffn_plans().values():
        _check_chunks(plan, c)


def test_chunk_offsets_of_short_and_empty_runs():
    np.testing.assert_array_equal(
        spmm.chunk_offsets(np.array([0, 3, 11, 12]), 4),
        [[0, 3, 0, 1], [3, 7, 1, 2], [7, 11, 1, 2], [11, 12, 3, 1]])
    assert spmm.chunk_offsets(np.zeros(1, np.int32)).shape == (0, 4)
    with pytest.raises(ValueError, match="chunk length"):
        spmm.chunk_offsets(np.array([0, 4]), 0)


# ---------------------------------------------------------------------------
# the three-way bf16 split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo_exp,hi_exp", [(-60, 60), (-100, -60),
                                           (60, 126)])
def test_split_bf16x3_is_exact(lo_exp, hi_exp):
    """Random fp32 over a wide exponent range (the last part stays above
    bf16's subnormal spacing, 2**-133, from |a| >= 2**-103 on)."""
    rng = np.random.default_rng(abs(lo_exp))
    size = 1 << 18
    mant = rng.uniform(1.0, 2.0, size)
    exp = rng.integers(lo_exp, hi_exp, size)
    sign = rng.choice([-1.0, 1.0], size)
    a = torch.from_numpy((sign * np.ldexp(mant, exp)).astype(np.float32))
    a = torch.cat([a, torch.tensor([0.0, 1.0, -3.0, 2.0 ** -100])])
    hi, mid, lo = spmm.split_bf16x3(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # every partial sum is exact, so the fp32 sums are a, bit for bit
    for total in ((hi.float() + mid.float()) + lo.float(),
                  (lo.float() + mid.float()) + hi.float()):
        assert torch.equal(total.view(torch.int32), a.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_split_bf16x3_of_payload_values_is_one_part(dtype):
    if dtype == torch.int8:
        vals = torch.arange(-128, 128, dtype=torch.int8)
    else:
        bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        vals = bits.view(torch.float8_e4m3fn)
        vals = vals[torch.isfinite(vals.float())]
    hi, mid, lo = spmm.split_bf16x3(vals.float())
    np.testing.assert_array_equal(hi.float().numpy(), vals.float().numpy())
    assert not mid.float().any() and not lo.float().any()


# ---------------------------------------------------------------------------
# the two paths' order of operations against repro's kernel
# ---------------------------------------------------------------------------


def _tiles(blocks, scales, slots, transpose):
    """Each item's stored tile as the kernels multiply it: fp32 (a payload
    times its rowwise scales), transposed in the ``transpose_lhs`` mode."""
    a = blocks[slots].float()
    if scales is not None and scales.ndim == 2:
        a = a * scales[slots][:, :, None]
    return a.transpose(1, 2) if transpose else a


def _emulate(path, blocks, scales, sched, b, transpose):
    """The tensor-core path: each item's product summed from its bf16 parts
    (lo, mid, hi; the products are exact in fp32), promoted per item into
    an fp32 accumulator (times a per-block scale) under the plan's flags.
    The split path: each item's fp32 product summed per chunk of its run,
    the chunks of a run then added in chunk order."""
    slots = sched.slot_idx.long()
    tiles = _tiles(blocks, scales, slots, transpose)
    n_items, out_blk, kc = tiles.shape
    n = b.shape[1]
    bsl = b.float().reshape(-1, kc, n)[sched.k_idx.long()]
    per_block = scales is not None and scales.ndim == 1
    if path == "tc":
        parts = ([tiles.bfloat16()] if per_block
                 else list(spmm.split_bf16x3(tiles)))
        prod = None
        for p in reversed(parts):                   # lo, mid, hi
            term = torch.bmm(p.float(), bsl)
            prod = term if prod is None else prod + term
    else:
        prod = torch.bmm(tiles, bsl)
    if per_block:
        prod = prod * scales[slots][:, None, None]
    out = torch.zeros(sched.grid_m, out_blk, n)
    m = sched.m_idx.numpy()
    valid = sched.valid.numpy().astype(bool)
    if path == "tc":
        acc = torch.zeros(out_blk, n)
        flags = [getattr(sched, f).numpy() for f in ("seg_start",
                                                     "accum_prev",
                                                     "seg_write")]
        for it in range(n_items):
            if flags[0][it]:
                acc = out[m[it]].clone() if flags[1][it] else acc * 0
            if valid[it]:
                acc = acc + prod[it]
            if flags[2][it]:
                out[m[it]] = acc
    else:
        runs = sched.run_offsets.numpy()
        table = spmm.chunk_offsets(runs)
        for r in range(runs.size - 1):
            rows = np.nonzero((table[:, 0] >= runs[r])
                              & (table[:, 1] <= runs[r + 1]))[0]
            total = None
            for lo, hi, _, _ in table[rows]:
                part = torch.zeros(out_blk, n)
                for it in range(lo, hi):
                    if valid[it]:
                        part = part + prod[it]
                total = part if total is None else total + part
            out[m[runs[r]]] = total
    return out.reshape(-1, n)


@functools.lru_cache(maxsize=None)
def _case(mode, transpose, variant):
    """The shared inputs and ``repro``'s interpret-mode result."""
    a = _bsr(variant, seed=7)
    n = 24
    quant = None if mode == "fp32" else mode
    knobs = VARIANTS[variant]
    ja = JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    jplan = japi.plan_matmul(ja, n, with_grad=True, quantize=quant, **knobs)
    plan = api.plan_matmul(a, n, with_grad=True, quantize=quant,
                           device="cpu", **knobs)
    jsched = jplan.grad_plan if transpose else jplan
    sched = plan.grad_plan if transpose else plan
    k = a.shape[0] if transpose else a.shape[1]
    # B in bf16, as both new paths take it: values exact in bf16 feed both
    x = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    scales = {} if quant is None else {"a_scales": jplan.lhs_scales}
    want = np.asarray(jax_spmm(
        jplan.lhs_blocks, *(jnp.asarray(np.asarray(getattr(jsched, f)))
                            for f in SCHED), jnp.asarray(x),
        grid_m=jsched.grid[0], n_lanes=jsched.n_lanes, bn=8,
        unroll=jsched.unroll, transpose_lhs=transpose,
        masked=jsched.has_pads, interpret=True,
        **{f: jnp.asarray(np.asarray(getattr(jsched, f))) for f in FETCH},
        **scales))
    live = np.repeat(np.asarray(jsched.row_mask) > 0, 64)
    return plan, sched, torch.from_numpy(x).bfloat16(), want, live


@pytest.mark.parametrize("mode,transpose,variant,path", list(
    itertools.product(("fp32",) + QUANT_MODES, (False, True),
                      ("plain", "fold", "lanes_unroll"), ("tc", "split"))))
def test_path_numerics_match_repro_kernel(mode, transpose, variant, path):
    plan, sched, b, want, live = _case(mode, transpose, variant)
    got = _emulate(path, plan.lhs_blocks, plan.lhs_scales, sched, b,
                   transpose).numpy()
    np.testing.assert_allclose(got[live], want[live], **TOL)
    # the wrapper's plain version (what CPU tensors run) agrees as well
    plain = spmm.segment_spmm_plain(
        plan.lhs_blocks, sched.slot_idx, sched.m_idx, sched.k_idx,
        sched.valid, b, grid_m=sched.grid_m, transpose_lhs=transpose,
        a_scales=plan.lhs_scales).numpy()
    np.testing.assert_allclose(got[live], plain[live], **TOL)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _view(shape, transposed, dtype=torch.bfloat16, offset=0):
    """A (K, N) operand laid out as the main path lays it: the transpose
    of a contiguous (N, K) tensor, or contiguous; ``offset`` elements past
    an aligned base."""
    k, n = shape
    if transposed:
        buf = torch.empty(offset + n * k, dtype=dtype)
        return buf[offset:].view(n, k).T
    buf = torch.empty(offset + k * n, dtype=dtype)
    return buf[offset:].view(k, n)


def _choose(b, bm=64):
    return spmm.choose_path(b.shape[1], b.dtype, bm, bm, b.stride(),
                            b.data_ptr())


@pytest.mark.parametrize("label,shape,transposed,want", [
    # decode steps: x.T of 4 tokens (up, gate), h.T contiguous (down)
    ("decode up", (4096, 4), True, "split"),
    ("decode down", (12800, 4), False, "split"),
    ("prefill 16", (4096, 16), True, "split"),
    ("prefill 64", (4096, 64), True, "tc"),
    ("prefill down 64", (12800, 64), False, "tc"),
    # training: x.T and h.T of 2048 tokens, dy in either layout
    ("train up", (4096, 2048), True, "tc"),
    ("train down", (12800, 2048), False, "tc"),
    ("train dx", (12800, 2048), True, "tc"),
    ("ragged N", (4096, 200), True, "tc"),
    ("ragged N contiguous", (12800, 200), False, "tc"),
])
def test_choose_path_on_main_path_shapes(label, shape, transposed, want):
    assert _choose(_view(shape, transposed)) == want, label


def test_choose_path_at_the_edges():
    n = spmm.TC_MIN_N
    assert _choose(_view((4096, n - 1), True)) == "split"
    assert _choose(_view((4096, n), True)) == "tc"
    # fp32 B and 32 x 32 blocks: the one-block-per-run kernel, any N
    assert _choose(_view((4096, 2048), True, torch.float32)) == "simt"
    assert _choose(_view((4096, 4), True), bm=32) == "simt"
    # what TMA cannot take stays on the split path at any N: an
    # N-contiguous B whose N is not a multiple of 8, a base that is not
    # 16-byte aligned, a row stride that is not a multiple of 16 bytes
    assert _choose(_view((4096, 2046), False)) == "split"
    assert _choose(_view((4096, 2048), True, offset=2)) == "split"
    assert _choose(torch.empty(2050, 4100, dtype=torch.bfloat16)[:2048,
                                                                 :4096].T
                   ) == "split"
    assert spmm.paths_for(torch.bfloat16, 64, 64, (1, 4096), 0) == (
        "tc", "split")
    assert spmm.paths_for(torch.bfloat16, 64, 64, (4, 1), 0) == (
        "split",)


def test_forced_paths_are_checked_on_every_device():
    a = _bsr("plain", seed=2)
    plan = api.plan_matmul(a, 8, device="cpu")
    args = [getattr(plan, f) for f in SCHED]
    b32 = torch.randn(a.shape[1], 8)
    with pytest.raises(ValueError, match="path='wide'"):
        spmm.segment_spmm(plan.lhs_blocks, *args, b32.bfloat16(),
                          grid_m=plan.grid_m, path="wide")
    for path in ("tc", "split"):
        with pytest.raises(ValueError, match="cannot take this call"):
            spmm.segment_spmm(plan.lhs_blocks, *args, b32,
                              grid_m=plan.grid_m, path=path)
    # a call either new path takes runs the plain version on CPU tensors,
    # whichever is forced, and counts no launch
    spmm.segment_spmm.launches = spmm.segment_spmm.tensor_core_launches = 0
    spmm.segment_spmm.split_launches = 0
    b = torch.randn(8, a.shape[1]).bfloat16().T
    outs = [spmm.segment_spmm(plan.lhs_blocks, *args, b, grid_m=plan.grid_m,
                              path=p) for p in (None, "tc", "split")]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert (spmm.segment_spmm.launches, spmm.segment_spmm.tensor_core_launches,
            spmm.segment_spmm.split_launches) == (0, 0, 0)
    want = ref.spmm_ref(plan.lhs_blocks, plan.a_brow, plan.a_bcol,
                        *plan.grid, b.float())
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), **TOL)
