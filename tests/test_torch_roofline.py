"""The port's roofline analysis and the kernels' custom operators, on the
CPU: ``model_flops`` and ``roofline_terms`` against ``repro``'s,
``collective_bytes`` against ``repro``'s HLO parser, ``opcheck`` on every
kernel operator, each fake rule's allocations against the closed form of
its launch's, and :class:`CostCounter` / ``live_pairs`` against direct
counts."""
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES, cell_is_live  # noqa: E402
from repro_torch.core.formats import BSR, quantize_blocks  # noqa: E402
from repro_torch.kernels.flash_attention import (bwd_splits,  # noqa: E402
                                                 choose_path)
from repro_torch.roofline import (Chip, CommRecorder, CostCounter,  # noqa: E402
                                  collective_bytes, live_pairs, model_flops,
                                  roofline_terms)

ROOT = Path(__file__).resolve().parents[1]
OPS = torch.ops.repro_torch


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# --- model_flops, roofline_terms ------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_flops_bit_equal_to_repro(arch):
    for shape in SHAPES:
        if cell_is_live(arch, shape):
            assert model_flops(REGISTRY[arch], SHAPES[shape]) == \
                jroof.model_flops(JAX_REGISTRY[arch], JAX_SHAPES[shape])
    assert model_flops(REGISTRY[arch], SHAPES["train_4k"], n_tokens=77.0) \
        == jroof.model_flops(JAX_REGISTRY[arch], JAX_SHAPES["train_4k"],
                             n_tokens=77.0)


def test_roofline_terms_equal_repro_under_its_constants():
    """The same formula: with ``repro``'s TPU constants in a ``Chip`` the
    port's terms, dominant term and bound are ``repro``'s on a grid."""
    tpu = Chip("repro", peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW,
               link_bw=jroof.ICI_BW, dcn_bw=jroof.DCN_BW, hbm_bytes=0)
    grid = itertools.product((0.0, 1e9, 3.3e17), (1.0, 8e11, 2e15),
                             (0.0, 5e9, 1e13), (1, 256, 512),
                             (0.0, 2e10), (1, 4))
    for flops, nbytes, coll, chips, dcn, links in grid:
        want = jroof.roofline_terms(flops, nbytes, coll, chips,
                                    dcn_bytes=dcn, dcn_links=links)
        got = roofline_terms(flops, nbytes, coll, chips, dcn_bytes=dcn,
                             dcn_links=links, chip=tpu)
        assert got == want


def test_h100_terms():
    t = roofline_terms(989e12 * 8, 3.35e12, 0.0, 8)
    assert t["dominant"] == "compute_s" and t["compute_s"] == 1.0
    assert t["memory_s"] == 1.0 / 8 and t["bound_s"] == 1.0


# --- collectives ------------------------------------------------------------

def test_collective_bytes_of_gloo_all_reduce_equal_repro_parser():
    """``repro``'s psum of a (64, 128) fp32 array sharded over 8 devices
    (``tests/test_roofline.py``) parses as an all-reduce of each device's
    (8, 128) shard; a gloo all-reduce of that shard records the same
    bytes.  The result bytes of an all-reduce do not depend on the number
    of ranks, so one gloo rank stands for the eight."""
    script = textwrap.dedent("""
        import os
        os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
        import json
        import jax, jax.numpy as jnp
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.roofline.analysis import collective_bytes
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((8,), ('d',))
        g = shard_map(lambda x: jax.lax.psum(x, 'd'), mesh=mesh,
                      in_specs=P('d'), out_specs=P())
        c = jax.jit(g).lower(jax.ShapeDtypeStruct((64, 128),
                                                  jnp.float32)).compile()
        print(json.dumps(collective_bytes(c.as_text())))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    import torch.distributed as dist
    from torch.distributed import HashStore
    dist.init_process_group("gloo", store=HashStore(), rank=0, world_size=1)
    try:
        shard = torch.ones(64 // 8, 128)
        with CommRecorder() as rec:
            dist.all_reduce(shard)
    finally:
        dist.destroy_process_group()
    assert collective_bytes(rec.records) == want == {"all-reduce": 4096}


def test_comm_recorder_opcodes_on_a_fake_group():
    """Each collective the sharded runtime calls, at its result's bytes."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4), _fake():
        x = torch.empty(8, 16)
        with CommRecorder() as rec:
            dist.all_gather_into_tensor(torch.empty(32, 16), x)
            dist.reduce_scatter_tensor(torch.empty(2, 16), x)
            dist.all_reduce(x)
    assert rec.records == [("all-gather", 2048), ("reduce-scatter", 128),
                           ("all-reduce", 512)]
    assert collective_bytes(rec.records + [("all-reduce", 4)]) == {
        "all-gather": 2048, "reduce-scatter": 128, "all-reduce": 516}


# --- CostCounter --------------------------------------------------------------

def test_cost_counter_counts_products_and_bytes():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    with CostCounter() as c:
        y = a @ b
        z = torch.relu(y)
        y.T.contiguous()
    assert c.flops == 2 * 16 * 32 * 8
    # mm reads a and b and writes y; relu reads y and writes z; the
    # transpose is a view; the copy reads and writes y's bytes
    assert c.bytes == _nbytes([a, b, y]) + 2 * _nbytes([z]) + 2 * _nbytes([y])


@pytest.mark.parametrize("causal,window,offset,kv_len,q_period", [
    (True, None, 0, 64, None), (True, 16, 0, 64, None),
    (False, None, 0, 50, None), (True, 8, 10, 60, 32), (True, None, 40, 64,
                                                         None)])
def test_live_pairs_is_the_mask_count(causal, window, offset, kv_len,
                                      q_period):
    tq, tk = 64 if q_period else 24, 64
    period = tq if q_period is None else q_period
    pos = offset + np.arange(tq) % period
    k = np.arange(tk)
    m = np.broadcast_to(k[None] < kv_len, (tq, tk))
    if causal:
        m = m & (k[None] <= pos[:, None])
    if window is not None:
        m = m & (k[None] > pos[:, None] - window)
    assert live_pairs(tq, tk, causal=causal, window=window, offset=offset,
                      kv_len=kv_len, q_period=q_period) == int(m.sum())


# --- the kernel operators ------------------------------------------------------

def _spmm_args(quant=None, transpose=False, n=8, b_dtype=torch.float32):
    rng = np.random.default_rng(3)
    w = BSR.random(rng, (128, 192), (32, 32), 0.5)
    plan = api.plan_matmul(w, n, with_grad=True, device="cpu")
    p = plan.grad_plan if transpose else plan
    blocks, scales = plan.lhs_blocks, None
    if quant:
        q = quantize_blocks(blocks, quant)
        blocks, scales = q.payload, q.scales
    k = (plan.grid[0] if transpose else plan.grid[1]) * 32
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return (blocks, scales, p.slot_idx, p.m_idx, p.k_idx, p.seg_start,
            p.seg_write, p.accum_prev, p.valid, b.to(b_dtype),
            p.run_offsets, p.chunk_offsets, p.grid[0], 512, transpose,
            torch.float32, None)


def _attn_args(dtype=torch.float32, window=None, stats=False):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 8, generator=g).to(dtype) for _ in range(3))
    return (q, k, v, True, window, 0, 16, 16, 16, None, dtype, stats, None)


def _attn_bwd_args():
    q, k, v, *rest = _attn_args(stats=True)
    out, st = OPS.flash_attention(q, k, v, *rest)
    dout = torch.randn(out.shape)
    return (q, k, v, out, dout, st, True, None, 0, 16, 16, 16, None, None)


def _lru_args():
    g = torch.Generator().manual_seed(1)
    x, ag, xg = (torch.randn(2, 5, 8, generator=g) for _ in range(3))
    return (x, ag, xg, torch.randn(8, generator=g),
            torch.randn(2, 8, generator=g), 8.0, None)


def _lru_bwd_args():
    x, ag, xg, p, h0, c, _ = _lru_args()
    hs, _ = OPS.rg_lru(x, ag, xg, p, h0, c, None)
    return (x, ag, xg, p, h0, hs, torch.randn(x.shape), torch.randn(2, 8),
            c, None)


def _moe_args(live=False, dtype=torch.float32, transposed=False):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3 * 16, 24, generator=g).to(dtype)
    w = torch.randn(4, 24, 16, generator=g).to(dtype)
    if transposed:          # a strided weight, which the launch copies
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    live_rows = torch.tensor([16, 5, 0], dtype=torch.int32) if live else None
    return (x, w, torch.tensor([0, 2, 2], dtype=torch.int32), live_rows, 16,
            torch.float32)


def _spgemm_args(quant=None, block=64, path=None):
    rng = np.random.default_rng(4)
    a = BSR.random(rng, (192, 128), (block, block), 0.6)
    b = BSR.random(rng, (128, 256), (block, block), 0.6)
    plan = api.plan_matmul(a, b, quantize=quant, device="cpu")
    return (plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx,
            plan.c_idx, plan.seg_start, plan.seg_write, plan.accum_prev,
            plan.valid, plan.lhs_scales, plan.rhs_scales, plan.run_offsets,
            plan.tc_runs, plan.tc_steps, plan.n_out_blocks, torch.float32,
            path)


OPCHECK_CASES = {
    "segment_spmm": (lambda: OPS.segment_spmm, _spmm_args),
    "segment_spmm transpose_lhs": (lambda: OPS.segment_spmm,
                                   lambda: _spmm_args(transpose=True)),
    "segment_spmm int8": (lambda: OPS.segment_spmm,
                          lambda: _spmm_args("int8")),
    # int8 for the rowwise scales: opcheck's schema check multiplies its
    # inputs, which torch's CPU kernels do not do in fp8
    "segment_spmm int8 rowwise": (lambda: OPS.segment_spmm,
                                  lambda: _spmm_args("int8.rowwise")),
    "flash_attention": (lambda: OPS.flash_attention, _attn_args),
    "flash_attention stats window": (
        lambda: OPS.flash_attention,
        lambda: _attn_args(window=4, stats=True)),
    "flash_attention_bwd": (lambda: OPS.flash_attention_bwd,
                            _attn_bwd_args),
    "rg_lru": (lambda: OPS.rg_lru, _lru_args),
    "rg_lru_bwd": (lambda: OPS.rg_lru_bwd, _lru_bwd_args),
    "moe_gemm": (lambda: OPS.moe_gemm, _moe_args),
    "moe_gemm live_rows": (lambda: OPS.moe_gemm,
                           lambda: _moe_args(live=True)),
    "segment_spgemm": (lambda: OPS.segment_spgemm, _spgemm_args),
    "segment_spgemm int8 rowwise": (lambda: OPS.segment_spgemm,
                                    lambda: _spgemm_args("int8.rowwise")),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck(case):
    op, args = OPCHECK_CASES[case]
    torch.library.opcheck(op(), args())


def _fake_cuda_outputs(op, args):
    """``op`` on fake CUDA tensors of ``args``' shapes, strides and dtypes
    (a fake CUDA tensor needs no card)."""
    with _fake():
        return op(*(torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                        device="cuda")
                    if isinstance(a, torch.Tensor) else a for a in args))


def test_spmm_fake_rule_is_the_launch_allocations():
    """On fake CUDA tensors: C, and on the split path (bf16 B at decode
    width, 64×64 blocks) its fp32 partials, one (chunk, N tile) slab of
    64 × tile_n each; none on ``tc`` nor on ``simt``."""
    rng = np.random.default_rng(0)
    w = BSR.random(rng, (256, 128), (64, 64), 0.5)
    plan = api.plan_matmul(w, 4, with_grad=True, device="cpu")
    for n, path in ((4, "split"), (64, "tc")):
        b = torch.randn(128, n).bfloat16()
        args = (plan.lhs_blocks, None, plan.slot_idx, plan.m_idx, plan.k_idx,
                plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid,
                b, plan.run_offsets, plan.chunk_offsets, 4, 512, False,
                torch.bfloat16, None)
        outs = _fake_cuda_outputs(OPS.segment_spmm, args)
        c = 256 * n * 2
        work = (plan.chunk_offsets.shape[0] * 64 * 4 * 4 if path == "split"
                else 0)
        assert [tuple(o.shape) for o in outs][0] == (256, n)
        assert _nbytes(outs) == c + work, path
    args = _spmm_args(n=8)                  # fp32 B: simt
    outs = _fake_cuda_outputs(OPS.segment_spmm, args)
    assert _nbytes(outs) == 128 * 8 * 4


def test_attention_fake_rules_are_the_launch_allocations():
    """Forward: out, the row statistics and ``tc``'s three bf16 parts of
    fp32 q, k and v (bf16 operands need none); backward: dq, dk, dv, each
    row's info, the row ranges' fp32 partials, the bf16 parts of fp32 q,
    k, v and dout, and a copy of a dout that is not in out's dtype."""
    bh, t, d = 2, 256, 64
    q, k, v = (torch.randn(bh, t, d) for _ in range(3))
    args = (q, k, v, True, None, 0, t, 128, 128, None, torch.float32, True,
            None)
    assert choose_path(bh, t, t, d) == "tc"
    outs = _fake_cuda_outputs(OPS.flash_attention, args)
    assert _nbytes(outs) == (bh * t * d * 4 + bh * t * 2 * 4
                             + 3 * 3 * bh * t * d * 2)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    outs = _fake_cuda_outputs(OPS.flash_attention,
                              (qb, kb, vb) + args[3:10] + (torch.bfloat16,
                                                           False, None))
    assert _nbytes(outs) == bh * t * d * 2
    out, st = torch.randn(bh, t, d), torch.randn(bh, t, 2)
    dout = torch.randn(bh, t, d).bfloat16()
    bargs = (q, k, v, out, dout, st, True, None, 0, t, 128, 128, None, None)
    outs = _fake_cuda_outputs(OPS.flash_attention_bwd, bargs)
    n_split = bwd_splits(bh, t, t, d, (torch.float32,) * 4)
    assert n_split > 1
    want = (3 * bh * t * d * 4 + bh * t * d * 4 + bh * t * 4 * 4
            + 2 * n_split * bh * t * d * 4 + 3 * 2 * 2 * bh * t * d * 2)
    assert _nbytes(outs) == want


def test_rg_lru_fake_rules_are_the_launch_allocations():
    """Forward: out and h_T, plus a copy of a strided x and an fp32 copy
    of a bf16 a_param; backward: the five gradients, fp32 hs's copy of a
    bf16 one, and the per-row partials of da_param."""
    b, t, d = 2, 32, 64
    x = torch.randn(b, d, t).transpose(1, 2)          # strided: copied
    ag, xg = torch.randn(b, t, d), torch.randn(b, t, d)
    p, h0 = torch.randn(d).bfloat16(), torch.randn(b, d)
    outs = _fake_cuda_outputs(OPS.rg_lru, (x, ag, xg, p, h0, 8.0, None))
    assert _nbytes(outs) == b * t * d * 4 + b * d * 4 + d * 4 + b * t * d * 4
    x = x.contiguous()
    hs = torch.randn(b, t, d).bfloat16()
    outs = _fake_cuda_outputs(
        OPS.rg_lru_bwd, (x, ag, xg, p.float(), h0, hs, torch.randn(b, t, d),
                         torch.randn(b, d), 8.0, None))
    assert _nbytes(outs) == (3 * b * t * d * 4 + d * 4 + b * d * 4
                             + b * t * d * 4 + b * d * 4)


def test_moe_gemm_fake_rule_is_the_launch_allocations():
    """On fake CUDA tensors, on both kernels: out, and the copies the
    launch makes (a strided weight, int64 expert ids), with or without
    live-row counts; none for row-major operands.  The path: bf16 x and
    w whose widths are multiples of 8 take the tensor cores, the rest the
    SIMT kernel."""
    from repro_torch.kernels.moe_gemm import launch_allocations
    out = 48 * 16 * 4
    for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        args = _moe_args(dtype=dtype)
        outs = _fake_cuda_outputs(OPS.moe_gemm, args)
        assert [tuple(o.shape) for o in outs] == [(48, 16)]
        assert outs[0].dtype == torch.float32 and _nbytes(outs) == out
        with _fake():
            fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                        device="cuda") for a in args[:3]]
            assert launch_allocations(*fake, None, torch.float32)[1] == path
        x, w, ce, live, rows, odt = _moe_args(live=True, dtype=dtype,
                                              transposed=True)
        outs = _fake_cuda_outputs(OPS.moe_gemm,
                                  (x, w, ce.long(), live, rows, odt))
        assert _nbytes(outs) == (out + w.numel() * w.element_size()
                                 + 3 * 4), dtype


def test_spgemm_fake_rule_is_the_launch_allocations():
    """On fake CUDA tensors: the C blocks, and on ``"tc"`` (64×64 tiles,
    every storage mode) its one int32 run counter; nothing more on
    ``"simt"`` (32×32 tiles, or forced)."""
    for quant in (None, "int8", "fp8.rowwise"):
        args = _spgemm_args(quant)
        n_c = args[14]
        c = n_c * 64 * 64 * 4
        outs = _fake_cuda_outputs(OPS.segment_spgemm, args)
        assert tuple(outs[0].shape) == (n_c, 64, 64)
        assert _nbytes(outs) == c + 4, quant
        outs = _fake_cuda_outputs(OPS.segment_spgemm, args[:-1] + ("simt",))
        assert _nbytes(outs) == c, quant
    args = _spgemm_args(block=32)
    outs = _fake_cuda_outputs(OPS.segment_spgemm, args)
    assert _nbytes(outs) == args[14] * 32 * 32 * 4


def test_kernels_without_fake_rules_raise_on_fake_tensors():
    """No kernel entry is left without a fake rule: ``moe_gemm`` and the
    SpGEMM, the last two, trace on fake and meta tensors to the plain
    version's shapes and dtypes (a meta SpGEMM plan's ``plan()`` too)
    instead of raising."""
    from repro_torch.kernels import moe_gemm
    x, w, ce = torch.randn(128, 16), torch.randn(2, 16, 8), \
        torch.zeros(1, dtype=torch.int32)
    want = moe_gemm(x, w, ce)
    with _fake():
        got = moe_gemm(torch.empty(128, 16), torch.empty(2, 16, 8),
                       torch.zeros(1, dtype=torch.int32))
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    rng = np.random.default_rng(0)
    a = BSR.random(rng, (64, 64), (32, 32), 1.0)
    want = api.plan_matmul(a, a, device="cpu")()
    got = api.plan_matmul(a, a, device="meta")()
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
