"""The port's SSM family (RWKV-6, ``rwkv6-1.6b``) against ``repro``'s, on
shared weights, on the CPU.

The models are ``reduced_config(rwkv6-1.6b)`` (2 layers, d_model 64, 4
heads of 16) with ``repro``'s ``init`` output carried over by
``repro_torch.convert.params_from_jax``.  The JAX side runs its
``"reference"`` backend; the wkv recurrence is a ``lax.scan`` there and a
torch loop over T in the port (:func:`repro_torch.kernels.ref.rwkv6_ref`);
neither package has a kernel for it.  Tolerances: ≤ 1e-4 relative to the
largest magnitude in fp32 (summation orders differ), ≤ 1e-2 in bf16 (one
bf16 rounding of each product and sum), 1e-5 for the recurrence alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (BF16_RTOL, FP32, RTOL,  # noqa: E402
                             check_loss_and_grads, pair, rel)
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import RWKVBlock  # noqa: E402
from repro_torch.models.recurrent import (rwkv_block_state,  # noqa: E402
                                          rwkv_channel_mix, rwkv_time_mix,
                                          token_shift)
from repro_torch.runtime import Engine, Request  # noqa: E402

NAME = "rwkv6-1.6b"
# the recurrence alone: the same fp32 operations in the same order
SCAN_RTOL = 1e-5
# a whole bf16 model: the card's gate on bf16 logits
MODEL_BF16_RTOL = 5e-2


@pytest.fixture(scope="module")
def fp32_pair():
    return pair(NAME, **FP32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _block_params(p, i=0):
    """Layer i's ``rwkv`` subtree of ``repro``'s params (numpy)."""
    return jax.tree.map(lambda a: np.asarray(a[i]),
                        p.jparams["layers"]["rwkv"])


# --------------------------------------------------------------------------
# the recurrence
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_ref_matches(with_state):
    rng = np.random.default_rng(0)
    b, t, h, d = 2, 11, 3, 8
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    w = -np.exp(rng.standard_normal((b, t, h, d))).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.1
    s0 = (rng.standard_normal((b, h, d, d)).astype(np.float32)
          if with_state else None)
    want, ws = jref.rwkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              None if s0 is None else jnp.asarray(s0))
    got, gs = ref.rwkv6_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                            None if s0 is None else torch.from_numpy(s0))
    assert got.dtype == gs.dtype == torch.float32
    assert rel(got, want) <= SCAN_RTOL
    assert rel(gs, ws) <= SCAN_RTOL


def test_token_shift_and_state_are_repro_s():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    prev = -np.ones((2, 4), np.float32)
    np.testing.assert_array_equal(
        token_shift(torch.from_numpy(x), torch.from_numpy(prev)).numpy(),
        np.asarray(jrec._token_shift(jnp.asarray(x), jnp.asarray(prev))))
    want = jrec.rwkv_block_state(3, 64, 4, jnp.bfloat16)
    got = rwkv_block_state(3, 64, 4, torch.bfloat16)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


def test_rwkv_block_shapes_match_repro_init():
    """``RWKVBlock`` holds ``rwkv_block_init``'s leaves under the same names
    and shapes; lora is max(32, d // 16) wide (128 at d_model 2048)."""
    want = jrec.rwkv_block_init(jax.random.PRNGKey(0), 2048, 32, 64)
    blk = RWKVBlock(2048, 32, 64, device="meta")
    got = {k: tuple(v.shape) for k, v in blk.state_dict().items()}
    flat = {}
    for k, v in want.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{leaf}": a.shape for leaf, a in v.items()})
        else:
            flat[k] = v.shape
    assert got == flat
    assert got["w_lora_a"] == (2048, 128)


# --------------------------------------------------------------------------
# time mix and channel mix, with state carried across split calls
# --------------------------------------------------------------------------


def _load_block(p):
    blk = RWKVBlock(p.cfg.d_model, p.cfg.n_heads, p.cfg.d_ff, device="cpu")
    blk.load_state_dict(p.model.layers[0].rwkv.state_dict())
    return blk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_across_split_calls(dtype, fp32_pair):
    """T = 13 in one call from a random state against calls over tokens
    [0, 5), [5, 6), [6, 13) that carry the state: the outputs and the
    final state of both packages, and each package's split against its
    whole call."""
    p = fp32_pair
    jp = _block_params(p)
    blk = _load_block(p)
    h = p.cfg.n_heads
    rng = np.random.default_rng(1)
    b, t, d = 2, 13, p.cfg.d_model
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    st = {"shift": rng.standard_normal((b, d)).astype(np.float32),
          "S": rng.standard_normal((b, h, d // h, d // h)).astype(
              np.float32) * 0.1,
          "cm_shift": rng.standard_normal((b, d)).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = BF16_RTOL if dtype == "bfloat16" else RTOL

    def jax_run(lo, hi, s):
        xs = jnp.asarray(x[:, lo:hi]).astype(jdt)
        out, tm = jrec.rwkv_time_mix(jp, xs, h, {"shift": s["shift"],
                                                 "S": s["S"]})
        cm, cm_shift = jrec.rwkv_channel_mix(jp, xs, s["cm_shift"])
        return out, cm, {**tm, "cm_shift": cm_shift}

    def port_run(lo, hi, s):
        xs = _t(x[:, lo:hi], tdt)
        with torch.no_grad():
            out, tm = rwkv_time_mix(blk, xs, s)
            cm, cm_shift = rwkv_channel_mix(blk, xs, s["cm_shift"])
        return out, cm, {**tm, "cm_shift": cm_shift}

    j0 = {"shift": jnp.asarray(st["shift"]).astype(jdt),
          "S": jnp.asarray(st["S"]),
          "cm_shift": jnp.asarray(st["cm_shift"]).astype(jdt)}
    t0 = {"shift": _t(st["shift"], tdt), "S": _t(st["S"]),
          "cm_shift": _t(st["cm_shift"], tdt)}
    whole_j = jax_run(0, t, j0)
    whole_t = port_run(0, t, t0)
    js, ts, parts_j, parts_t = j0, t0, [], []
    for lo, hi in ((0, 5), (5, 6), (6, t)):
        oj, cj, js = jax_run(lo, hi, js)
        ot, ct, ts = port_run(lo, hi, ts)
        parts_j.append((oj, cj))
        parts_t.append((ot, ct))
    for i in range(2):
        split_t = torch.cat([pt[i] for pt in parts_t], dim=1)
        split_j = jnp.concatenate([pj[i] for pj in parts_j], axis=1)
        assert split_t.dtype == tdt
        assert rel(whole_t[i], whole_j[i]) <= tol
        assert rel(split_t, split_j) <= tol
        assert rel(split_t, whole_t[i].float().numpy()) <= tol
    for k in ("shift", "S", "cm_shift"):
        assert rel(whole_t[2][k], whole_j[2][k]) <= tol, k
        assert rel(ts[k], js[k]) <= tol, k
        assert rel(ts[k], whole_t[2][k].float().numpy()) <= tol, k
    assert ts["S"].dtype == torch.float32 and ts["shift"].dtype == tdt


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_forward_logits_match(fp32_pair):
    p = fp32_pair
    tokens = np.random.default_rng(2).integers(0, p.jcfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, waux = p.jmodel.forward(p.jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = p.model(torch.from_numpy(tokens).long(), return_aux=True)
    assert p.model.layer_kinds == ("rwkv", "rwkv")
    assert got.shape == want.shape == (2, 24, p.jcfg.padded_vocab)
    assert rel(got, want) <= RTOL
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match(remat):
    """``jax.grad`` of ``repro``'s loss through the ``lax.scan`` against
    autograd through the port's loop, remat on and off."""
    p = pair(NAME, remat=remat, **FP32)
    batch = JaxDataset(p.jcfg, JaxShapeConfig("tiny", "train", 12, 2),
                       seed=3).batch(0)
    check_loss_and_grads(p, batch)


def test_decode_steps_match_and_equal_forward(fp32_pair):
    """A 4-token chunk, then single steps at per-row positions (the state
    carries no position): the logits of every call against ``repro``'s
    ``decode_step`` and every layer's state after; and the port's one
    forward over the same tokens against its own stepwise decode."""
    p = fp32_pair
    rng = np.random.default_rng(3)
    b = 2
    jcache = p.jmodel.init_cache(b, 16)
    cache = p.model.init_cache(b, 16)
    h, hd = p.cfg.n_heads, p.cfg.d_model // p.cfg.n_heads
    assert cache.keys() == {"shift", "S", "cm_shift"}
    assert cache["S"].shape == (2, b, h, hd, hd)
    assert cache["S"].dtype == torch.float32
    chunk = rng.integers(0, p.jcfg.vocab, (b, 4), dtype=np.int32)
    steps = [(chunk, 0)] + [
        (rng.integers(0, p.jcfg.vocab, (b, 1), dtype=np.int32),
         np.array([4 + s, 9 + s], np.int32)) for s in range(6)]
    jstep = jax.jit(p.jmodel.decode_step)
    for tok, pos in steps:
        jl, jcache = jstep(p.jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        tp = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
        with torch.no_grad():
            gl, same = p.model.decode_step(
                cache, torch.from_numpy(tok).long(), tp)
        assert same is cache
        assert rel(gl, jl) <= RTOL
    for k in ("shift", "S", "cm_shift"):
        assert rel(cache[k], jcache["layers"]["rwkv"][k]) <= RTOL, k

    tokens = torch.from_numpy(np.concatenate([t for t, _ in steps], 1)).long()
    with torch.no_grad():
        whole = p.model(tokens)
        cache = p.model.init_cache(b, 16)
        for i in range(tokens.shape[1]):
            step, _ = p.model.decode_step(cache, tokens[:, i:i + 1], i)
            assert rel(step, whole[:, i].numpy()) <= RTOL, i


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_tokens_match_jax_engine(slots, fp32_pair):
    """Prefill one token a call (``prefill_buckets == (1,)``), a slot that
    serves a second request from a zeroed state, and a request that stops
    on its ``eos_token``."""
    p = fp32_pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, p.jcfg.vocab, n, dtype=np.int32)
               for n in (4, 13, 9)]
    new = (6, 5, 7)

    def jax_run(eos):
        eng = JaxEngine(p.jmodel, p.jparams, slots=slots, max_len=32,
                        backend="reference")
        assert eng.prefill_buckets == (1,)
        return [r.out_tokens.tolist() for r in eng.generate(
            [JaxRequest(prompt=q.copy(), max_new_tokens=n, eos_token=e)
             for q, n, e in zip(prompts, new, eos)])]

    free = jax_run((None, None, None))
    eos = (None, free[1][2], None)
    want = jax_run(eos)
    assert len(want[1]) < new[1]
    eng = Engine(p.model, slots=slots, max_len=32, device="cpu")
    assert eng.prefill_buckets == (1,)
    got = [r.out_tokens.tolist() for r in eng.generate(
        [Request(prompt=q.copy(), max_new_tokens=n, eos_token=e)
         for q, n, e in zip(prompts, new, eos)])]
    assert got == want
    assert eng.compiled_shapes == {"decode": 1, "prefill": 1}


def test_bf16_forward_matches():
    """bf16 activations over fp32 parameters, as the card serves it: the
    mix cast to bf16, the decay and S in fp32.  Tolerance 5e-2, the
    card's gate on bf16 logits (``chip_smoke.LOGIT_RTOL``): each block
    agrees within one bf16 rounding (above), and two layers of residual
    adds compound them (1.8e-2 found)."""
    p = pair(NAME, dtype="bfloat16")
    tokens = np.random.default_rng(4).integers(0, p.jcfg.vocab, (2, 16),
                                               dtype=np.int32)
    want, _ = p.jmodel.forward(p.jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got = p.model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    assert rel(got, np.asarray(want.astype(jnp.float32))) <= MODEL_BF16_RTOL
