"""The port's MoE family (Phi-3.5-MoE, and Llama-4 Maverick's interleaved
``("attn", "moe")`` blocks) against ``repro``'s, on shared weights, on the
CPU.

The models are ``reduced_config`` (4 experts, top-2 for Phi-3.5-MoE and
top-1 for Maverick; Maverick's 3 layers are one ``(attn, moe)`` unit and
an ``attn`` tail) with ``repro``'s ``init`` output carried over by
``repro_torch.convert.params_from_jax``.  The JAX side runs its
``"reference"`` backend.  The dispatch is held exactly: the same buffers,
slots and kept tokens.  Tolerances: ≤ 1e-4 relative to the largest
magnitude in fp32 (summation orders differ), ≤ 1e-2 in bf16 (one bf16
rounding of each product and sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (BF16_RTOL, FP32, RTOL, check_loss_and_grads,  # noqa: E402
                             np_tree, pair, rel)
from repro import api as japi  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.configs import REGISTRY, ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import MoE  # noqa: E402
from repro_torch.models.moe import (capacity, dispatch_batched,  # noqa: E402
                                    moe_apply)
from repro_torch.optim import cosine_with_warmup  # noqa: E402
from repro_torch.runtime import (Engine, Request, Trainer,  # noqa: E402
                                 TrainerConfig)

PHI = "phi3.5-moe-42b-a6.6b"
MAVERICK = "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def phi_pair():
    return pair(PHI, **FP32)


@pytest.fixture(scope="module")
def maverick_pair():
    return pair(MAVERICK, **FP32)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["overflow", "ties", "all_one_expert",
                                  "roomy"])
def test_dispatch_is_repro_s_exactly(case):
    """``buf``, ``slot`` and ``keep`` equal ``_dispatch_batched``'s bit for
    bit: overflow past a small capacity, long runs of one expert id (ties
    the sort must keep in token order), every token on one expert, and a
    capacity nothing overflows."""
    rng = np.random.default_rng(0)
    b, t, d, e = 3, 17, 5, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    cap = {"overflow": 3, "ties": 5, "all_one_expert": 4, "roomy": t}[case]
    if case == "ties":
        expert = np.repeat(rng.integers(0, e, (b, 5)), 4, axis=1)[:, :t]
    elif case == "all_one_expert":
        expert = np.full((b, t), 2)
    else:
        expert = rng.integers(0, e, (b, t))
    expert = expert.astype(np.int32)
    wbuf, wslot, wkeep = jmoe._dispatch_batched(
        jnp.asarray(x), jnp.asarray(expert), e, cap)
    buf, slot, keep = dispatch_batched(torch.from_numpy(x),
                                       torch.from_numpy(expert).long(), e,
                                       cap)
    assert buf.shape == wbuf.shape == (b, e, cap, d)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(wbuf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(wkeep))
    if case != "roomy":
        assert not keep.all()          # some token was dropped
    else:
        assert keep.all()


def _moe_pair(d, d_ff, e):
    jp = jmoe.moe_init(jax.random.PRNGKey(5), d, d_ff, e)
    moe = MoE(d, d_ff, e, device="cpu")
    moe.load_state_dict({"router.w": torch.from_numpy(np.array(
        jp["router"]["w"])), **{k: torch.from_numpy(np.array(jp[k]))
                                for k in ("gate", "up", "down")}})
    return jp, moe


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_matches(top_k, dtype, capacity_factor):
    """Output and Switch aux loss; capacity 0.5 drops tokens in every row.
    The kept tokens are the same (the dispatch is exact), the router runs
    in fp32 in both."""
    d, d_ff, e = 32, 48, 4
    jp, moe = _moe_pair(d, d_ff, e)
    x = np.random.default_rng(1).standard_normal((2, 19, d)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x).astype(jdt), top_k=top_k,
                                capacity_factor=capacity_factor)
    with torch.no_grad():
        got, aux = moe_apply(moe, torch.from_numpy(x).to(tdt), top_k=top_k,
                             capacity_factor=capacity_factor)
    assert got.dtype == tdt and aux.dtype == torch.float32
    tol = BF16_RTOL if dtype == "bfloat16" else RTOL
    assert rel(got, want) <= tol
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


def test_layer_kinds_follow_repro_groups(phi_pair, maverick_pair):
    """Phi-3.5-MoE: every layer ``moe``; Maverick: its ``(attn, moe)`` unit
    and the tail, which ``convert`` maps from ``units``/``tail``."""
    assert phi_pair.model.layer_kinds == ("moe", "moe")
    jm = maverick_pair.jmodel
    kinds = [k for (_, ks, n) in jm.groups for _ in range(n) for k in ks]
    assert list(maverick_pair.model.layer_kinds) == kinds == [
        "attn", "moe", "attn"]


@pytest.mark.parametrize("arch", [PHI, MAVERICK])
def test_forward_logits_and_aux_match(arch, phi_pair, maverick_pair):
    p = phi_pair if arch == PHI else maverick_pair
    tokens = np.random.default_rng(2).integers(0, p.jcfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, waux = p.jmodel.forward(p.jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = p.model(torch.from_numpy(tokens).long(), return_aux=True)
    assert rel(got, want) <= RTOL
    assert float(waux) > 0
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("arch,remat", [(PHI, False), (PHI, True),
                                        (MAVERICK, False)])
def test_loss_and_every_gradient_match(arch, remat):
    """``loss + 0.01 · aux`` and every gradient (router, expert stacks,
    attention, norms, embeddings) against ``jax.grad``."""
    p = pair(arch, remat=remat, **FP32)
    batch = JaxDataset(p.jcfg, JaxShapeConfig("tiny", "train", 16, 2),
                       seed=3).batch(0)
    metrics = check_loss_and_grads(p, batch)
    assert metrics["aux"] > 0


def test_decode_steps_match(maverick_pair):
    """A 6-token chunk at a shared position, then single steps at per-row
    positions: every call's logits and the KV cache after."""
    p = maverick_pair
    rng = np.random.default_rng(3)
    b = 2
    jcache = p.jmodel.init_cache(b, 24)
    cache = p.model.init_cache(b, 24)
    assert cache["k"].shape == (3, b, 24, p.cfg.n_kv, p.cfg.hd)
    steps = [(rng.integers(0, p.jcfg.vocab, (b, 6), dtype=np.int32), 0)] + [
        (rng.integers(0, p.jcfg.vocab, (b, 1), dtype=np.int32),
         np.array([6 + s, 6 + 2 * s], np.int32)) for s in range(5)]
    jstep = jax.jit(p.jmodel.decode_step)
    for tok, pos in steps:
        jl, jcache = jstep(p.jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        tp = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
        with torch.no_grad():
            gl, _ = p.model.decode_step(cache, torch.from_numpy(tok).long(),
                                        tp)
        assert rel(gl, jl) <= RTOL
    want = [jcache["units"]["b0"]["kv"], jcache["units"]["b1"]["kv"],
            jcache["tail"]["b0"]["kv"]]
    for i, w in enumerate(want):
        for k in ("k", "v"):
            assert rel(cache[k][i], w[k][0]) <= RTOL, (i, k)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_tokens_match_jax_engine(quantize):
    """Prefill buckets (16, 8): prompts of 21 and 11 tokens end in a
    zero-padded chunk that routes (and may drop) its padding at the
    chunk's capacity, as ``repro``'s does; 3 requests over 2 slots.  With
    ``quantize="int8"`` the Maverick model's dense layers carry a sparse
    FFN, quantized in both."""
    if quantize is None:
        p = pair(PHI, **FP32)
    else:
        p = pair(MAVERICK, dtype="float32", ffn_block_sparse=True,
                 ffn_block=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, p.jcfg.vocab, n, dtype=np.int32)
               for n in (21, 4, 11)]
    kw = dict(slots=2, max_len=40, prefill_buckets=(16, 8),
              quantize=quantize)
    want = [r.out_tokens.tolist() for r in JaxEngine(
        p.jmodel, p.jparams, backend="reference", **kw).generate(
        [JaxRequest(prompt=q.copy(), max_new_tokens=6) for q in prompts])]
    eng = Engine(p.model, device="cpu", **kw)
    assert eng.prefill_buckets == (16, 8)
    got = [r.out_tokens.tolist() for r in eng.generate(
        [Request(prompt=q.copy(), max_new_tokens=6) for q in prompts])]
    assert got == want


def test_trainer_tracks_repro_trainer():
    """3 steps of ``Trainer`` against ``repro.runtime.Trainer`` from the
    same weights: loss (with 0.01 · aux) and pre-clip gradient norm of
    every step within 1e-4, the final weights within the bound of
    ``tests/test_torch_train.py`` (2 · Σ lr, 99.9 % quantile 1e-6)."""
    tc = dict(steps=3, log_every=1, peak_lr=1e-3, warmup=2)
    shape = dict(name="tiny", kind="train", seq_len=16, global_batch=2)
    p = pair(PHI, **FP32)
    jtrainer = JaxTrainer(p.jmodel, p.jcfg, JaxShapeConfig(**shape),
                          JaxTrainerConfig(**tc))
    init = np_tree(jtrainer.state[0])
    with japi.use_backend("reference"):
        want = jtrainer.run()
    final = np_tree(jtrainer.state[0])
    trainer = Trainer(p.model, p.cfg, ShapeConfig(**shape),
                      TrainerConfig(**tc))
    p.model.load_state_dict(params_from_jax(p.cfg, init))
    got = trainer.run()
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=RTOL)
    lr = cosine_with_warmup(tc["peak_lr"], tc["warmup"], tc["steps"])
    atol = 2 * sum(lr(s) for s in range(1, tc["steps"] + 1))
    want_p = params_from_jax(p.cfg, final)
    for k, t in p.model.named_parameters():
        d = np.abs(t.detach().numpy() - want_p[k].numpy())
        assert d.max() <= atol, k
        assert np.quantile(d, 0.999) <= 1e-6, k


def test_capacity_comes_from_the_call_width():
    """cap = ceil(T · factor / E) of the call: a decode step (T = 1) keeps
    every token, a 64-token prefill chunk caps each expert at 5 of
    Phi-3.5-MoE's 16."""
    cfg = REGISTRY[PHI]
    assert capacity(1, cfg.n_experts, cfg.moe_capacity_factor) == 1
    assert capacity(64, cfg.n_experts, cfg.moe_capacity_factor) == 5
    assert capacity(4096, cfg.n_experts, cfg.moe_capacity_factor) == 320
