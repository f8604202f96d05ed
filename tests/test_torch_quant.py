"""The port's quantized serving slice against ``repro``'s, on the CPU.

Same numpy inputs on both sides: the Segment SpMM kernel's int8/fp8 modes
(per-block and rowwise scales, forward and ``transpose_lhs``; the port's
wrapper runs its plain version on CPU tensors, ``repro``'s kernel runs in
interpret mode), quantized SpMM plans leaf for leaf, quantized dx against
``jax.grad``, ``SparseLinear.quantize``, ``Transformer.quantize`` (state
carried over with ``convert.params_from_jax``), the int8 KV cache and
``Engine(quantize=)``.

Tolerances: fp32 on both sides, summed in other orders, so 1e-5 for one
product (as ``tests/test_torch_spmm.py``) and 1e-4 for a model's logits
(as ``tests/test_torch_model.py``), the int8 KV cache's included.  Weight
payloads and scales are compared bit for bit (fp8 through a ``uint8``
view), and so are the int8 KV cache's values.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api.plan import _AUX_FIELDS, _LEAF_FIELDS  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm as jax_spmm  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.sparse_ffn import SparseLinear as JaxSparseLinear  # noqa: E402
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import REGISTRY, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.formats import BSR, QUANT_MODES  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.segment_spmm import segment_spmm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.sparse_ffn import SparseLinear  # noqa: E402
from repro_torch.runtime import Engine, Request  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 1e-4
KNOBS = {"plain": {}, "lanes": {"policy": "gustavson", "n_lanes": 2,
                                "unroll": 2}}
SCHED = ("slot_idx", "m_idx", "k_idx", "seg_start", "seg_write",
         "accum_prev", "valid")
FETCH = ("a_fetch", "b_fetch", "a_slot", "b_slot")


def _np(x):
    """A leaf of either package as numpy; fp8 payloads as their bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _assert_same_plan(got, want, path="plan"):
    for f in _AUX_FIELDS:
        if f in ("fingerprint", "backend"):
            continue      # the digest keys on each package's policy serial
        assert getattr(got, f) == getattr(want, f), f"{path}.{f}"
    for f in _LEAF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f"{path}.{f}"
        if w is None:
            continue
        if f == "grad_plan":
            _assert_same_plan(g, w, path + ".grad_plan")
            continue
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, f"{path}.{f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}.{f}")


def _bsr(seed=0, shape=(256, 192)):
    rng = np.random.default_rng(seed)
    a = BSR.random(rng, shape, (32, 32), 0.4)
    # unit-scale values keep the atol meaningful
    a.blocks = (a.blocks / np.sqrt(shape[1])).astype(np.float32)
    return a


def _jax(a: BSR) -> JaxBSR:
    return JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)


def _leaves(plan, names):
    return [jnp.asarray(_np(getattr(plan, f))) for f in names]


# ---------------------------------------------------------------------------
# the kernel's quantized modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,transpose,knobs", list(itertools.product(
    QUANT_MODES, (False, True), KNOBS)))
def test_quantized_spmm_matches_repro_kernel(mode, transpose, knobs):
    """Forward, and ``transpose_lhs`` on the grad plan against the forward
    payload and scales, as the backward pass runs it."""
    a = _bsr()
    n = 8
    jplan = japi.plan_matmul(_jax(a), n, with_grad=True, quantize=mode,
                             **KNOBS[knobs])
    plan = api.plan_matmul(a, n, with_grad=True, quantize=mode, device="cpu",
                           **KNOBS[knobs])
    np.testing.assert_array_equal(_np(plan.lhs_blocks), _np(jplan.lhs_blocks))
    np.testing.assert_array_equal(_np(plan.lhs_scales), _np(jplan.lhs_scales))
    jsched = jplan.grad_plan if transpose else jplan
    sched = plan.grad_plan if transpose else plan
    k = a.shape[0] if transpose else a.shape[1]
    x = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jax_spmm(
        jplan.lhs_blocks, *_leaves(jsched, SCHED), jnp.asarray(x),
        grid_m=jsched.grid[0], n_lanes=jsched.n_lanes, bn=8,
        unroll=jsched.unroll, transpose_lhs=transpose,
        masked=jsched.has_pads, interpret=True, a_scales=jplan.lhs_scales,
        **dict(zip(FETCH, _leaves(jsched, FETCH)))))
    jgrid = (jplan.grid[1], jplan.grid[0]) if transpose else jplan.grid
    want_ref = np.asarray(jref.spmm_ref(
        jplan.lhs_blocks, jplan.a_brow, jplan.a_bcol, *jplan.grid,
        jnp.asarray(x), transpose_lhs=transpose, scales=jplan.lhs_scales))
    assert want_ref.shape[0] == jgrid[0] * 32

    tx = torch.from_numpy(x)
    live = np.repeat(np.asarray(jsched.row_mask) > 0, 32)
    direct = segment_spmm(
        plan.lhs_blocks, *(getattr(sched, f) for f in SCHED), tx,
        grid_m=sched.grid_m, n_lanes=sched.n_lanes, unroll=sched.unroll,
        transpose_lhs=transpose, a_scales=plan.lhs_scales).numpy()
    np.testing.assert_allclose(direct[live], want[live], **TOL)
    run = sched.with_values(plan.lhs_blocks, lhs_scales=plan.lhs_scales)
    np.testing.assert_allclose(run(tx).numpy(), want_ref, **TOL)
    np.testing.assert_allclose(run(tx, backend="reference").numpy(),
                               want_ref, **TOL)
    np.testing.assert_allclose(
        ref.spmm_ref(plan.lhs_blocks, plan.a_brow, plan.a_bcol, *plan.grid,
                     tx, transpose_lhs=transpose,
                     scales=plan.lhs_scales).numpy(), want_ref, **TOL)


def test_quantized_wrapper_named_errors():
    a = _bsr()
    plan = api.plan_matmul(a, 4, quantize="int8", device="cpu")
    args = [getattr(plan, f) for f in SCHED]
    x = torch.ones(a.shape[1], 4)
    before = segment_spmm.quantized_launches
    with pytest.raises(NotImplementedError, match="needs its scales"):
        segment_spmm(plan.lhs_blocks, *args, x, grid_m=plan.grid_m)
    with pytest.raises(NotImplementedError, match="int8/fp8 payloads only"):
        segment_spmm(plan.lhs_blocks.float(), *args, x, grid_m=plan.grid_m,
                     a_scales=plan.lhs_scales)
    with pytest.raises(NotImplementedError, match="blocks must be one of"):
        segment_spmm(plan.lhs_blocks.half(), *args, x, grid_m=plan.grid_m)
    for bad in (plan.lhs_scales[1:], plan.lhs_scales[:, None]):
        with pytest.raises(ValueError, match="a_scales has shape"):
            segment_spmm(plan.lhs_blocks, *args, x, grid_m=plan.grid_m,
                         a_scales=bad)
    got = segment_spmm(plan.lhs_blocks, *args, x, grid_m=plan.grid_m,
                       a_scales=plan.lhs_scales)
    assert got.shape == (a.shape[0], 4)
    # CPU tensors run the plain version: no kernel launch is counted
    assert segment_spmm.quantized_launches == before


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,knobs", list(itertools.product(QUANT_MODES,
                                                              KNOBS)))
def test_quantized_plan_leaves_match_repro(mode, knobs):
    """Every leaf (payload and scales bit for bit), the static fields, the
    traffic estimate (A bytes re-priced for the payload) and the grad plan
    equal ``repro``'s."""
    a = _bsr(seed=2)
    kw = dict(with_grad=True, quantize=mode, **KNOBS[knobs])
    got = api.plan_matmul(a, 48, device="cpu", **kw)
    want = japi.plan_matmul(_jax(a), 48, **kw)
    _assert_same_plan(got, want)
    fp32 = dict(api.plan_matmul(a, 48, device="cpu", with_grad=True,
                                **KNOBS[knobs]).traffic_items)
    traffic = dict(got.traffic_items)
    assert traffic["a_bytes"] < fp32["a_bytes"] / 3
    assert traffic["b_bytes"] == fp32["b_bytes"]
    assert got.grad_plan.block_dtype == mode


def test_fp32_and_quantized_spmm_plans_never_collide():
    api.clear_plan_cache()
    a = _bsr()
    plans = {q: api.plan_matmul(a, 16, quantize=q, device="cpu")
             for q in (None,) + QUANT_MODES}
    again = api.plan_matmul(a, 16, device="cpu")
    stats = api.plan_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == stats["size"] == 5
    assert stats["by_dtype"] == {"fp32": 1, "int8": 1, "fp8": 1,
                                 "int8.rowwise": 1, "fp8.rowwise": 1}
    assert len({p.fingerprint for p in plans.values()}) == 5
    assert again.lhs_blocks.dtype == torch.float32 and again.lhs_scales is None
    assert plans["fp8"].lhs_blocks.dtype == torch.float8_e4m3fn
    assert tuple(plans["fp8.rowwise"].lhs_scales.shape) == (a.nblocks, 32)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (a.shape[1], 16)).astype(np.float32))
    exact = again(x)
    for q, gate in (("int8", 5e-2), ("fp8", 1e-1)):
        err = float((plans[q](x) - exact).abs().max() / exact.abs().max())
        assert 0 < err < gate, (q, err)


def test_with_values_rejects_mismatched_storage_dtype():
    a = _bsr()
    q8 = api.plan_matmul(a, 4, quantize="int8", with_grad=True, device="cpu")
    fp = api.plan_matmul(a, 4, with_grad=True, device="cpu")
    with pytest.raises(ValueError, match="stores int8 payloads"):
        q8.with_values(q8.lhs_blocks.float())
    with pytest.raises(ValueError, match="stores int8 payloads"):
        q8.with_values(api.plan_matmul(a, 4, quantize="fp8",
                                       device="cpu").lhs_blocks)
    with pytest.raises(ValueError, match="quantized payload dtype"):
        fp.with_values(q8.lhs_blocks)
    x = torch.ones(a.shape[1], 4)
    with pytest.raises(ValueError, match="stores int8 payloads"):
        api.apply_plan(q8, x, blocks=fp.lhs_blocks)
    with pytest.raises(ValueError, match="need their scales"):
        api.apply_plan(q8, x, blocks=q8.lhs_blocks)
    # the grad plan addresses the forward payload and scales
    doubled = q8.with_values(q8.lhs_blocks, lhs_scales=q8.lhs_scales * 2)
    np.testing.assert_allclose(doubled(x).numpy(), 2 * q8(x).numpy(), **TOL)


# ---------------------------------------------------------------------------
# layers and gradients
# ---------------------------------------------------------------------------


def test_sparse_linear_quantize_carries_the_planner_configuration():
    a = _bsr(seed=4)
    kw = dict(policy="gustavson", n_lanes=2, unroll=2, bn_hint=16,
              backend="reference")
    src = api.plan_matmul(a, with_grad=True, device="cpu", **kw)
    layer = SparseLinear(src, a.shape[0], a.shape[1], src.lhs_blocks.clone())
    jsrc = japi.plan_matmul(_jax(a), with_grad=True, **kw)
    jlayer = JaxSparseLinear(plan=jsrc, d_out=a.shape[0], d_in=a.shape[1])
    for mode in ("int8", "fp8.rowwise"):
        q = layer.quantize(mode)
        jq, jparams = jlayer.quantize({"blocks": jsrc.lhs_blocks}, mode)
        for f in ("policy", "n_lanes", "unroll", "backend", "pipeline",
                  "bn_hint"):
            assert getattr(q.plan, f) == getattr(src, f) == getattr(
                jq.plan, f), f
        assert q.plan.block_dtype == mode and q.plan.grad_plan is not None
        np.testing.assert_array_equal(_np(q.blocks), _np(jparams["blocks"]))
        np.testing.assert_array_equal(_np(q.scales), _np(jparams["scales"]))
        # frozen storage: buffers in the state dict, no parameters
        assert list(q.parameters()) == []
        assert set(q.state_dict()) == {"blocks", "scales"}
        x = np.random.default_rng(5).standard_normal(
            (7, a.shape[1])).astype(np.float32)
        want = np.asarray(jq.apply(jparams, jnp.asarray(x)))
        with torch.no_grad():
            np.testing.assert_allclose(q(torch.from_numpy(x)).numpy(), want,
                                       **TOL)


def test_sparse_linear_quantize_raises_on_fold_plans_and_twice():
    a = _bsr()
    fold = api.plan_matmul(a, with_grad=True, fold_len=2, device="cpu")
    assert bool(fold.accum_prev.any())
    with pytest.raises(ValueError, match="fold_len"):
        SparseLinear(fold, a.shape[0], a.shape[1], fold.lhs_blocks).quantize()
    layer = SparseLinear.from_pattern(a, device="cpu")
    q = layer.quantize("int8")
    with pytest.raises(ValueError, match="already quantized"):
        q.quantize("int8")


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_dx_matches_jax_grad(mode):
    """dx through a quantized plan against ``jax.grad`` of ``repro``'s
    ``apply_plan`` on its reference and interpret backends; the payload
    gets no gradient."""
    a = _bsr(seed=6)
    n = 6
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, a.shape[1])).astype(np.float32)   # (N, K)
    ct = rng.standard_normal((a.shape[0], n)).astype(np.float32)
    jplan = japi.plan_matmul(_jax(a), n, with_grad=True, quantize=mode)
    want = {}
    for backend in ("reference", "interpret"):
        def loss(xx, backend=backend):
            y = japi.apply_plan(jplan, xx.T, backend=backend, bn=8)
            return jnp.sum(y * jnp.asarray(ct))
        want[backend] = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    plan = api.plan_matmul(a, n, with_grad=True, quantize=mode, device="cpu")
    for backend in ("cuda", "reference"):
        tx = torch.from_numpy(x).requires_grad_(True)
        y = api.apply_plan(plan, tx.T, blocks=plan.lhs_blocks,
                           scales=plan.lhs_scales, backend=backend)
        (y * torch.from_numpy(ct)).sum().backward()
        for w in want.values():
            np.testing.assert_allclose(tx.grad.numpy(), w, **TOL)
        assert plan.lhs_blocks.grad is None and plan.lhs_scales.grad is None
    # dense: dx = Wqᵀ @ ct with W dequantized
    wq = ref.bsr_to_dense(ref.dequant_blocks_ref(plan.lhs_blocks,
                                                 plan.lhs_scales),
                          plan.a_brow, plan.a_bcol, *plan.grid).numpy()
    np.testing.assert_allclose(tx.grad.numpy(), (wq.T @ ct).T, **TOL)


# ---------------------------------------------------------------------------
# the model, the int8 KV cache and the engine
# ---------------------------------------------------------------------------

MODEL_KNOBS = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32,
                   ffn_density=0.5)


def _pair(**over):
    """``repro``'s reduced granite with a block-sparse FFN and the port's
    model over the same patterns, with the same weights."""
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY["granite-3-8b"]),
                               **MODEL_KNOBS, **over)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    patterns = {p: (np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_brow),
                    np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_bcol))
                for p in ("up", "gate", "down")}
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              **MODEL_KNOBS, **over)
    model = build_model(cfg, device="cpu", ffn_patterns=patterns)
    model.load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), patterns))
    return jcfg, jmodel, jparams, model, patterns


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_transformer_quantize_matches_repro(pair, mode):
    jcfg, jmodel, jparams, model, patterns = pair
    jq, jqparams = jmodel.quantize(jparams, mode)
    qmodel = model.quantize(mode)
    assert qmodel.quantized and not model.quantized
    want_sd = params_from_jax(model.cfg, jax.tree.map(np.asarray, jqparams),
                              patterns)
    got_sd = qmodel.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, w in want_sd.items():
        assert got_sd[k].dtype == w.dtype, k
        np.testing.assert_array_equal(_np(got_sd[k]), _np(w), err_msg=k)
    # everything but the FFN blocks is shared with the source model
    src = model.state_dict()
    for k, t in got_sd.items():
        if ".mlp." not in k:
            assert t.data_ptr() == src[k].data_ptr(), k
    # the layers share one cached schedule per projection
    a, b = qmodel.layers[0].mlp.up.plan, qmodel.layers[1].mlp.up.plan
    assert a.slot_idx is b.slot_idx and a.block_dtype == mode
    # the state carries over: a quantized model loaded from repro's tree
    fresh = model.quantize(mode)
    fresh.load_state_dict(want_sd)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12),
                                               dtype=np.int32)
    with japi.use_backend("reference"):
        want, _ = jq.forward(jqparams, jnp.asarray(tokens))
        jcache = jq.init_cache(2, 32)
        jl, _ = jq.decode_step(jqparams, jcache, jnp.asarray(tokens), 0)
    with torch.no_grad():
        got = qmodel(torch.from_numpy(tokens).long())
        loaded = fresh(torch.from_numpy(tokens).long())
        cache = qmodel.init_cache(2, 32)
        gl, _ = qmodel.decode_step(cache, torch.from_numpy(tokens).long(), 0)
    assert _rel(got, want) <= LOGIT_RTOL
    assert _rel(loaded, want) <= LOGIT_RTOL
    assert _rel(gl, jl) <= LOGIT_RTOL


def test_transformer_quantize_raises_on_dense_and_twice(pair):
    model = pair[3]
    q = model.quantize("int8")
    with pytest.raises(ValueError, match="already quantized"):
        q.quantize("fp8")
    dense = build_model(dataclasses.replace(
        reduced_config(REGISTRY["granite-3-8b"]), dtype="float32"),
        device="cpu")
    with pytest.raises(ValueError, match="block-sparse"):
        dense.quantize("int8")


@pytest.fixture(scope="module")
def kv8_pair():
    return _pair(kv_cache_dtype="int8")


def test_int8_kv_cache_decode_matches_repro(kv8_pair):
    """Chunks of 4 and 8 and single-token steps at per-row positions, with
    int8 weights on top: the logits follow ``repro``'s at every step."""
    jcfg, jmodel, jparams, model, _ = kv8_pair
    jq, jqparams = jmodel.quantize(jparams, "int8")
    qmodel = model.quantize("int8")
    rng = np.random.default_rng(3)
    steps = [(rng.integers(0, jcfg.vocab, (2, 8), dtype=np.int32), 0),
             (rng.integers(0, jcfg.vocab, (2, 4), dtype=np.int32), 8)]
    for i in range(4):
        steps.append((rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32),
                      np.array([12 + i, 10 + i], np.int32)))
    for m_j, p_j, m_t in ((jmodel, jparams, model), (jq, jqparams, qmodel)):
        jcache = m_j.init_cache(2, 32)
        cache = m_t.init_cache(2, 32)
        assert cache["k"].dtype == torch.int8
        assert tuple(cache["k_s"].shape) == (jcfg.n_layers, 2, 32, jcfg.n_kv)
        for tok, pos in steps:
            with japi.use_backend("reference"):
                jl, jcache = m_j.decode_step(p_j, jcache, jnp.asarray(tok),
                                             jnp.asarray(pos))
            tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
            with torch.no_grad():
                gl, cache = m_t.decode_step(cache, torch.from_numpy(tok).long(),
                                            tpos)
            assert _rel(gl, jl) <= LOGIT_RTOL
        jkv = jcache["layers"]["kv"]
        for name in ("k", "v"):
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(jkv[name]))
            np.testing.assert_allclose(cache[name + "_s"].numpy(),
                                       np.asarray(jkv[name + "_s"]), **TOL)


def test_int8_kv_long_query_raises_named_error(kv8_pair):
    model = kv8_pair[3]
    cache = model.init_cache(1, 64)
    with pytest.raises(ValueError, match="decode-sized"):
        model.decode_step(cache, torch.zeros((1, 16), dtype=torch.long), 0)
    assert not cache["k"].any() and not cache["k_s"].any()   # nothing written


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


def _serve(model, prompts, max_new, **kw):
    eng = Engine(model, device="cpu", **kw)
    reqs = eng.generate([Request(prompt=p.copy(), max_new_tokens=max_new)
                         for p in prompts])
    return eng, [r.out_tokens.tolist() for r in reqs]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_engine_matches_repro_and_single_request_oracle(pair, mode):
    """A batched run with slot churn equals serving each request alone on
    the same quantized weights, and ``repro``'s quantized engine."""
    jcfg, jmodel, jparams, model, _ = pair
    prompts = _prompts(jcfg.vocab, (4, 17, 9), seed=11)
    kw = dict(max_len=64, prefill_buckets=(16, 8), quantize=mode)
    alone = [_serve(model, [p], 5, slots=1, **kw)[1][0] for p in prompts]
    eng, got = _serve(model, prompts, 5, slots=2, **kw)
    assert got == alone
    assert eng.quantize == mode and eng.model.quantized
    jeng = JaxEngine(jmodel, jparams, slots=2, backend="reference", **kw)
    want = [r.out_tokens.tolist() for r in jeng.generate(
        [JaxRequest(prompt=p.copy(), max_new_tokens=5) for p in prompts])]
    assert got == want


def test_quantized_greedy_drift_bounded(pair):
    """fp32 vs int8 vs fp8 engines on one mixed-length batch: greedy tokens
    may drift at near-ties, within ``repro``'s bounds."""
    jcfg, _, _, model, _ = pair
    prompts = _prompts(jcfg.vocab, (4, 17, 9, 25, 6), seed=12)
    kw = dict(slots=2, max_len=64, prefill_buckets=(16, 8))
    base = _serve(model, prompts, 6, **kw)[1]
    total = sum(len(t) for t in base)
    for mode, bound in (("int8", 0.25), ("int8.rowwise", 0.25),
                        ("fp8", 0.5)):
        out = _serve(model, prompts, 6, quantize=mode, **kw)[1]
        drift = sum(a != b for x, y in zip(base, out) for a, b in zip(x, y))
        assert drift / total <= bound, (mode, drift, total)


def test_quantized_engine_keeps_the_step_shapes(pair):
    """One decode shape and the fp32 engine's prefill shapes, flat across a
    later wave of new lengths and budgets."""
    jcfg, _, _, model, _ = pair
    kw = dict(slots=2, max_len=64, prefill_buckets=(16,))
    first = _prompts(jcfg.vocab, (5, 20), seed=13)
    fp32_eng, _ = _serve(model, first, 3, **kw)
    eng, _ = _serve(model, first, 3, quantize="int8", **kw)
    warm = dict(eng.compiled_shapes)
    assert warm["decode"] == 1 and warm == fp32_eng.compiled_shapes
    eng.generate([Request(prompt=p, max_new_tokens=m) for p, m in zip(
        _prompts(jcfg.vocab, (3, 21, 13, 30), seed=14), (2, 5, 1, 3))])
    assert eng.compiled_shapes == warm


def test_quantized_engine_composes_with_int8_kv_cache(kv8_pair):
    """int8 weights and an int8 KV cache: prefill chunks of at most 8, and
    the batched run equals the single-request oracle and ``repro``."""
    jcfg, jmodel, jparams, model, _ = kv8_pair
    prompts = _prompts(jcfg.vocab, (4, 17), seed=15)
    kw = dict(max_len=64, quantize="int8")
    alone = [_serve(model, [p], 4, slots=1, **kw)[1][0] for p in prompts]
    eng, got = _serve(model, prompts, 4, slots=2, **kw)
    assert max(eng.prefill_buckets) <= 8
    assert got == alone
    jeng = JaxEngine(jmodel, jparams, slots=2, backend="reference", **kw)
    want = [r.out_tokens.tolist() for r in jeng.generate(
        [JaxRequest(prompt=p.copy(), max_new_tokens=4) for p in prompts])]
    assert got == want
