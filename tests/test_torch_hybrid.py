"""The port's hybrid family (RecurrentGemma: RG-LRU blocks and local
attention over a ring KV cache) against ``repro``'s, on shared weights, on
the CPU.

The models are ``reduced_config(recurrentgemma-9b)`` in fp32: 4 layers,
one ``(rec, rec, local)`` unit and a one-block tail, ``local_window`` 32.
``repro``'s ``init`` output is carried over with
``repro_torch.convert.params_from_jax``.  The JAX side runs its
``"reference"`` backend (``lax.scan``, ``chunked_attention``); the port
runs its default ``"cuda"`` backend, which on CPU tensors is each kernel's
plain version (``rg_lru_plain``, ``flash_attention_plain`` through
``ops.flash_mha``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402

from repro_torch.configs import REGISTRY, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rg_lru import rg_lru  # noqa: E402
from repro_torch.models import RGLRUBlock, build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.recurrent import rglru_block_state  # noqa: E402
from repro_torch.runtime import Engine, Request  # noqa: E402

# fp32 on both sides; summation orders differ (tests/test_torch_model.py)
RTOL = 1e-4
# the RG-LRU block alone: the same operations in the same order, in fp32
BLOCK_RTOL = 1e-5
# bf16 activations: one bf16 rounding (2**-8) of each product and sum
BF16_RTOL = 1e-2
NAME = "recurrentgemma-9b"
FP32 = dict(dtype="float32")
SPARSE = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _pair(knobs, **extra):
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY[NAME]), **knobs,
                               **extra)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    patterns = None
    if jcfg.ffn_block_sparse:
        patterns = {p: (np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_brow),
                        np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_bcol))
                    for p in ("up", "gate", "down")}
    cfg = dataclasses.replace(reduced_config(REGISTRY[NAME]), **knobs,
                              **extra)
    model = build_model(cfg, device="cpu", ffn_patterns=patterns)
    model.load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), patterns))
    return jcfg, jmodel, jparams, model


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(FP32)


@pytest.fixture(scope="module")
def sparse_pair():
    return _pair(SPARSE)


def _jax_cache_layers(cfg, jcache):
    """``repro``'s cache tree as one dict of numpy arrays per layer, in the
    port's layer order (``units/b{j}`` over units, then ``tail/b{j}``)."""
    p = len(cfg.layer_pattern)
    n_units = cfg.n_layers // p
    out = []
    for i in range(cfg.n_layers):
        u, j = divmod(i, p)
        group, idx = ("units", u) if u < n_units else ("tail", 0)
        sub = jcache[group][f"b{j}"]
        leaves = sub["rec"] if "rec" in sub else sub["kv"]
        out.append({k: np.asarray(v[idx]) for k, v in leaves.items()})
    return out


def _port_cache_layers(model, cache):
    """The port's flat cache as one dict of numpy arrays per layer, under
    the layer's own names (``k``/``v`` whatever group holds them)."""
    return [{name: cache[key][i].float().numpy()
             for name, key in keys.items() if key in cache}
            for keys, i in zip(model._cache_keys, model._cache_index)]


# --------------------------------------------------------------------------
# the RG-LRU block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches(dtype, with_state, t):
    d, b = 64, 2
    jp = jax_recurrent.rglru_block_init(jax.random.PRNGKey(3), d)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.standard_normal((b, 3, d)).astype(np.float32),
                 "h": rng.standard_normal((b, d)).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jstate = None if state is None else {
        "conv": jnp.asarray(state["conv"]).astype(jdt),
        "h": jnp.asarray(state["h"])}
    want, wstate = jax_recurrent.rglru_block_apply(
        jp, jnp.asarray(x).astype(jdt), state=jstate)

    blk = RGLRUBlock(d, device="cpu")
    blk.load_state_dict({
        "conv": _t(jp["conv"]), "a_param": _t(jp["a_param"]),
        **{f"{n}.w": _t(jp[n]["w"]) for n in
           ("in_x", "in_g", "a_gate", "x_gate", "out")}})
    tstate = None if state is None else {
        "conv": _t(state["conv"], tdt), "h": _t(state["h"])}
    before = rg_lru.launches
    with torch.no_grad():
        got, gstate = blk(_t(x, tdt), state=tstate)
    assert rg_lru.launches == before          # CPU tensors: plain version
    assert got.dtype == tdt and gstate["conv"].dtype == tdt
    assert gstate["h"].dtype == torch.float32
    tol = BLOCK_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= tol
    assert _rel(gstate["conv"], np.asarray(
        wstate["conv"].astype(jnp.float32))) <= tol
    assert _rel(gstate["h"], np.asarray(wstate["h"])) <= tol


def test_rglru_block_state_is_repro_state():
    want = jax_recurrent.rglru_block_state(3, 16, jnp.bfloat16)
    got = rglru_block_state(3, 16, torch.bfloat16)
    for k in ("conv", "h"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


def test_gelu_is_jax_default():
    """The tanh form (the two packages' fp32 tanh differ in the far tail
    by ~6e-7); torch's default erf form is ~1e-3 away."""
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = layers.gelu(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.gelu(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


# --------------------------------------------------------------------------
# the ring KV cache
# --------------------------------------------------------------------------


def test_ring_decode_attention_matches():
    """Per-row positions, slots ahead of a row's timeline (an earlier
    occupant's junk), negative slot positions and a multi-token query."""
    rng = np.random.default_rng(5)
    b, tq, h, hkv, d, w = 2, 3, 4, 2, 16, 8
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    ck = rng.standard_normal((b, w, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, w, hkv, d)).astype(np.float32)
    k_pos = np.array([[0, 1, 2, 3, 4, 5, -3, -2],
                      [16, 9, 10, 11, 12, 13, 14, 15]], np.int32)
    pos = np.array([3, 13], np.int32)
    want = jax_layers.ring_decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k_pos),
        jnp.asarray(pos), 6)
    got = layers.ring_decode_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(k_pos).long(), torch.from_numpy(pos).long(), 6)
    assert _rel(got, want) <= BLOCK_RTOL


@pytest.mark.parametrize("pos", [[5, 38], 6])
def test_ring_write_and_attention_match(pos):
    """``Attention(ring=True)`` against ``repro``'s ``attention_apply(
    ring=True)``: 3 new tokens into an 8-slot ring that holds junk, at
    per-row positions whose writes wrap (38 → slots 6, 7, 0) or at a shared
    one; the outputs and the whole ring after the write."""
    rng = np.random.default_rng(6)
    b, t, dm, h, hkv, hd, w = 2, 3, 64, 4, 2, 16, 8
    jp = jax_layers.attention_init(jax.random.PRNGKey(7), dm, h, hkv, hd)
    x = rng.standard_normal((b, t, dm)).astype(np.float32)
    ck = rng.standard_normal((b, w, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, w, hkv, hd)).astype(np.float32)
    pos_np = np.broadcast_to(np.asarray(pos, np.int32), (b,))
    positions = pos_np[:, None] + np.arange(t, dtype=np.int32)
    jpos = jnp.asarray(pos, jnp.int32)
    want, wcache = jax_layers.attention_apply(
        jp, jnp.asarray(x), n_heads=h, n_kv=hkv, head_dim=hd,
        positions=jnp.asarray(positions), window=6,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, cache_pos=jpos,
        ring=True)

    attn = layers.Attention(dm, h, hkv, hd, device="cpu")
    attn.load_state_dict({f"{n}.w": _t(jp[n]["w"])
                          for n in ("wq", "wk", "wv", "wo")})
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), positions=torch.from_numpy(
            positions).long(), cache=cache, cache_pos=tpos, window=6,
            ring=True)
    assert _rel(got, want) <= BLOCK_RTOL
    for k in ("k", "v"):
        assert _rel(cache[k], wcache[k]) <= BLOCK_RTOL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_hybrid_layers_follow_repro_groups(sparse_pair):
    jcfg, jmodel, _, model = sparse_pair
    kinds = [k for (_, ks, n) in jmodel.groups for _ in range(n) for k in ks]
    assert list(model.layer_kinds) == kinds == ["rec", "rec", "local", "rec"]
    # rec layers get a dense SwiGLU even with ffn_block_sparse
    assert [type(blk.mlp).__name__ for blk in model.layers] == [
        "SwiGLU", "SwiGLU", "SparseMLP", "SwiGLU"]


@pytest.mark.parametrize("sparse", [False, True])
def test_hybrid_forward_logits_match(sparse, dense_pair, sparse_pair):
    """T = 80 > local_window = 32: the window mask bites.  The port's local
    attention runs through ``ops.flash_mha`` (its plain version here) and
    ``repro``'s through ``chunked_attention``."""
    jcfg, jmodel, jparams, model = sparse_pair if sparse else dense_pair
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 80),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    before = (rg_lru.launches, flash_attention.launches)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert (rg_lru.launches, flash_attention.launches) == before
    assert got.shape == want.shape == (2, 80, jcfg.padded_vocab)
    assert _rel(got, want) <= RTOL


def test_hybrid_forward_reference_backend_matches(sparse_pair):
    """The ``"reference"`` backend (``repro``'s oracles: ``rg_lru_ref``,
    ``chunked_attention``, dense SpMM) computes the same logits."""
    from repro_torch.api import use_backend
    jcfg, jmodel, jparams, model = sparse_pair
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 48),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad(), use_backend("reference"):
        got = model(torch.from_numpy(tokens).long())
    assert _rel(got, want) <= RTOL


def test_hybrid_decode_steps_match(sparse_pair):
    """A 5-token chunk at a shared position, then single steps at per-row
    positions until both rows' rings have wrapped (W = 32): the logits of
    every call, then every layer's ring, conv and h state."""
    jcfg, jmodel, jparams, model = sparse_pair
    rng = np.random.default_rng(3)
    b, max_len = 2, 48
    jcache = jmodel.init_cache(b, max_len)
    cache = model.init_cache(b, max_len)
    assert cache["k"].shape == (1, b, 32, jcfg.n_kv, jcfg.hd)
    assert cache["conv"].shape == (3, b, 3, jcfg.d_model)
    assert cache["h"].shape == (3, b, jcfg.d_model)
    assert cache["h"].dtype == torch.float32
    chunk = rng.integers(0, jcfg.vocab, (b, 5), dtype=np.int32)
    steps = [(chunk, 0)]
    pos = np.array([5, 5], np.int32)
    for s in range(34):
        tok = rng.integers(0, jcfg.vocab, (b, 1), dtype=np.int32)
        # row 1 repeats one position once, so the rows drift apart
        steps.append((tok, pos.copy()))
        pos = pos + np.array([1, int(s != 3)], np.int32)
    jstep = jax.jit(jmodel.decode_step)
    for tok, p in steps:
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(p))
        with torch.no_grad():
            tp = p if isinstance(p, int) else torch.from_numpy(p).long()
            gl, same = model.decode_step(cache, torch.from_numpy(tok).long(),
                                         tp)
        assert same is cache
        assert _rel(gl, jl) <= RTOL
    want = _jax_cache_layers(jcfg, jcache)
    got = _port_cache_layers(model, cache)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in g:
            assert _rel(g[k], w[k]) <= RTOL, (i, k)


@pytest.mark.parametrize("slots", [1, 2])
def test_hybrid_engine_tokens_match_jax_engine(slots, sparse_pair):
    """Mixed prompt lengths (one longer than the window), prefill one
    token at a time, and a request that stops on its ``eos_token``."""
    jcfg, jmodel, jparams, model = sparse_pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (4, 35, 9)]
    new = (6, 5, 7)

    def jax_run(eos):
        eng = JaxEngine(jmodel, jparams, slots=slots, max_len=48,
                        backend="reference")
        assert eng.prefill_buckets == (1,)
        return [r.out_tokens.tolist() for r in eng.generate(
            [JaxRequest(prompt=p.copy(), max_new_tokens=n, eos_token=e)
             for p, n, e in zip(prompts, new, eos)])]

    free = jax_run((None, None, None))
    eos = (None, free[1][2], None)          # request 1 stops at its 3rd token
    want = jax_run(eos)
    assert len(want[1]) < new[1] and want[1][-1] == eos[1]
    eng = Engine(model, slots=slots, max_len=48, device="cpu")
    assert eng.prefill_buckets == (1,)
    got = [r.out_tokens.tolist() for r in eng.generate(
        [Request(prompt=p.copy(), max_new_tokens=n, eos_token=e)
         for p, n, e in zip(prompts, new, eos)])]
    assert got == want
    assert eng.compiled_shapes == {"decode": 1, "prefill": 1}


def test_local_window_caps_prefill_buckets():
    """No recurrent layer: the buckets are capped at the window, as
    ``repro`` caps them (a config of local layers only)."""
    cfg = dataclasses.replace(reduced_config(REGISTRY[NAME]),
                              layer_pattern=("local",), n_layers=2,
                              local_window=16, **FP32)
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY[NAME]),
                               layer_pattern=("local",), n_layers=2,
                               local_window=16, **FP32)
    jm = jax_build(jcfg)
    want = JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), slots=1, max_len=32,
                     prefill_buckets=(64, 16, 8),
                     backend="reference").prefill_buckets
    got = Engine(build_model(cfg, device="cpu"), slots=1, max_len=32,
                 prefill_buckets=(64, 16, 8), device="cpu").prefill_buckets
    assert got == want == (16, 8)


def test_hybrid_quantize_matches(sparse_pair):
    """``Transformer.quantize("int8")`` quantizes the local blocks' sparse
    FFNs only, as ``repro``'s does: its state equals the conversion of
    ``repro``'s quantized tree, the rec blocks are shared, and the logits
    agree."""
    jcfg, jmodel, jparams, model = sparse_pair
    jq, jqp = jmodel.quantize(jparams, "int8")
    qmodel = model.quantize("int8")
    assert qmodel.quantized and not model.quantized
    conv = params_from_jax(qmodel.cfg, jax.tree.map(np.asarray, jqp), {
        p: (np.asarray(getattr(jq.sparse_mlp, p).plan.a_brow),
            np.asarray(getattr(jq.sparse_mlp, p).plan.a_bcol))
        for p in ("up", "gate", "down")})
    state = qmodel.state_dict()
    assert state.keys() == conv.keys()
    for k in conv:
        assert torch.equal(state[k], conv[k].to(state[k].dtype)), k
    assert state["layers.2.mlp.up.blocks"].dtype == torch.int8
    for i in (0, 1, 3):
        assert qmodel.layers[i] is model.layers[i]
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 40),
                                               dtype=np.int32)
    want, _ = jq.forward(jqp, jnp.asarray(tokens))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(tokens).long())
    assert _rel(got, want) <= RTOL


def test_int8_kv_cache_with_ring_raises_in_both():
    jcfg, jmodel, jparams, model = _pair(FP32, kv_cache_dtype="int8")
    with pytest.raises(ValueError):
        JaxEngine(jmodel, jparams, slots=1, max_len=16,
                  backend="reference").generate(
            [JaxRequest(prompt=np.arange(1, 5, dtype=np.int32),
                        max_new_tokens=2)])
    with pytest.raises(ValueError, match="ring KV cache has no int8 mode"):
        model.init_cache(1, 16)
    with pytest.raises(ValueError, match="ring KV cache has no int8 mode"):
        Engine(model, slots=1, max_len=16, device="cpu")



# --------------------------------------------------------------------------
# local attention beside full attention: one KV cache group per kind
# --------------------------------------------------------------------------

MIXED = dict(layer_pattern=("attn", "local"), n_layers=4)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "sparse"])
def mixed_pair(request):
    return _pair(SPARSE if request.param else FP32, **MIXED)


def test_mixed_forward_logits_match(mixed_pair):
    """T = 80 > local_window = 32: the local layers' window mask bites,
    the full layers see every earlier position."""
    jcfg, jmodel, jparams, model = mixed_pair
    assert model.layer_kinds == ("attn", "local", "attn", "local")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 80),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (2, 80, jcfg.padded_vocab)
    assert _rel(got, want) <= RTOL


def test_mixed_cache_groups_match_repro(mixed_pair):
    """Full-length ``k``/``v`` for the attn layers, window-long rings at
    ``k_local``/``v_local``, each layer's entries shaped as ``repro``'s."""
    jcfg, jmodel, _, model = mixed_pair
    b, max_len = 2, 96
    cache = model.init_cache(b, max_len)
    kv = (jcfg.n_kv, jcfg.hd)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (2, b, max_len, *kv), "v": (2, b, max_len, *kv),
        "k_local": (2, b, 32, *kv), "v_local": (2, b, 32, *kv)}
    want = _jax_cache_layers(jcfg, jmodel.init_cache(b, max_len))
    got = _port_cache_layers(model, cache)
    assert [{k: v.shape for k, v in g.items()} for g in got] == [
        {k: v.shape for k, v in w.items()} for w in want]


@pytest.mark.parametrize("length", [5, 40, 70])
def test_mixed_decode_steps_match(length, mixed_pair):
    """A prompt fed one token a step (past the window at 40 and 70): the
    logits of every step, then every layer's cache rows."""
    jcfg, jmodel, jparams, model = mixed_pair
    max_len = 80
    jcache = jmodel.init_cache(1, max_len)
    cache = model.init_cache(1, max_len)
    prompt = np.random.default_rng(length).integers(
        0, jcfg.vocab, (1, length), dtype=np.int32)
    jstep = jax.jit(jmodel.decode_step)
    for p in range(length):
        tok = prompt[:, p:p + 1]
        pos = np.array([p], np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            gl, _ = model.decode_step(cache, torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos).long())
        assert _rel(gl, jl) <= RTOL, p
    want = _jax_cache_layers(jcfg, jcache)
    got = _port_cache_layers(model, cache)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in g:
            assert _rel(g[k], w[k]) <= RTOL, (i, k)


def test_mixed_engine_tokens_match_jax_engine(mixed_pair):
    """Prompts of 5, 40 and 70 tokens over 2 slots: chunked prefill capped
    at the window, the rings wrapping, the full layers keeping every key."""
    jcfg, jmodel, jparams, model = mixed_pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (5, 40, 70)]
    new = (6, 5, 4)
    jeng = JaxEngine(jmodel, jparams, slots=2, max_len=80,
                     backend="reference")
    want = [r.out_tokens.tolist() for r in jeng.generate(
        [JaxRequest(prompt=p.copy(), max_new_tokens=n)
         for p, n in zip(prompts, new)])]
    eng = Engine(model, slots=2, max_len=80, device="cpu")
    assert eng.prefill_buckets == jeng.prefill_buckets == (16,)
    got = [r.out_tokens.tolist() for r in eng.generate(
        [Request(prompt=p.copy(), max_new_tokens=n)
         for p, n in zip(prompts, new)])]
    assert got == want
