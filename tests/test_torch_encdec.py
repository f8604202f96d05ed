"""The port's vision-language (InternVL2-2B) and encoder-decoder
(Whisper-tiny) families against ``repro``'s, on shared weights, on the
CPU.

The models are ``reduced_config`` (InternVL2: 2 layers, 8 vision
positions; Whisper: 2 encoder and 2 decoder layers, 8 frames), dense or
with the block-sparse FFN (32 blocks), and ``repro``'s ``init`` output
carried over by ``repro_torch.convert.params_from_jax``.  The JAX side
runs its ``"reference"`` backend.  Tolerances: ≤ 1e-4 relative to the
largest magnitude in fp32 (summation orders differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (FP32, RTOL, SPARSE, check_loss_and_grads,  # noqa: E402
                             np_tree, pair, rel)
from repro import api as japi  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import cosine_with_warmup  # noqa: E402
from repro_torch.runtime import (Engine, Request, Trainer,  # noqa: E402
                                 TrainerConfig)

VLM = "internvl2-2b"
WHISPER = "whisper-tiny"
KNOBS = {"dense": FP32, "sparse": SPARSE}


@pytest.fixture(scope="module")
def whisper_pair():
    return pair(WHISPER, **SPARSE)


def _embeds(p, b, n=None, seed=5):
    n = n or p.cfg.n_frontend_tokens
    return np.random.default_rng(seed).standard_normal(
        (b, n, p.cfg.d_model)).astype(np.float32) * 0.1


def _jax_encode(p, enc_embeds):
    """``repro``'s encoder output, as its ``forward`` computes it."""
    e = jlayers.dense_apply(p.jparams["frontend"], jnp.asarray(enc_embeds))
    b, t = e.shape[:2]
    ep = jnp.broadcast_to(jnp.arange(t), (b, t))
    return p.jmodel._run_group(p.jparams["enc"], e, "attn_bidir",
                               positions=ep)[0]


# --------------------------------------------------------------------------
# attention: bidirectional and cross
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bidir", "cross", "self_unmasked"])
def test_attention_modes_match(mode):
    """``causal=False`` self attention with rope (an encoder block),
    cross attention over 11 context rows (no rope, no mask), and the
    unmasked self attention without rope that ``repro``'s cross blocks
    run when decoding without an encoder output."""
    rng = np.random.default_rng(6)
    b, t, dm, h, hkv, hd = 2, 7, 64, 4, 2, 16
    jp = jlayers.attention_init(jax.random.PRNGKey(7), dm, h, hkv, hd)
    x = rng.standard_normal((b, t, dm)).astype(np.float32)
    ctx = rng.standard_normal((b, 11, dm)).astype(np.float32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kw = dict(causal=False, rope_theta=0.0 if mode != "bidir" else 1e4)
    jctx = jnp.asarray(ctx) if mode == "cross" else None
    want, _ = jlayers.attention_apply(
        jp, jnp.asarray(x), n_heads=h, n_kv=hkv, head_dim=hd,
        positions=jnp.asarray(positions), kv_ctx=jctx, chunk=4, **kw)
    attn = layers.Attention(dm, h, hkv, hd, device="cpu")
    attn.load_state_dict({f"{n}.w": torch.from_numpy(np.array(jp[n]["w"]))
                          for n in ("wq", "wk", "wv", "wo")})
    with torch.no_grad():
        got = attn(torch.from_numpy(x),
                   positions=torch.from_numpy(positions).long(),
                   kv_ctx=None if mode != "cross" else torch.from_numpy(ctx),
                   chunk=4, **kw)
        causal = attn(torch.from_numpy(x),
                      positions=torch.from_numpy(positions).long(), chunk=4,
                      rope_theta=kw["rope_theta"])
    assert rel(got, want) <= RTOL
    assert rel(causal, want) > 1e-2         # the mask was dropped


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, WHISPER])
@pytest.mark.parametrize("ffn", ["dense", "sparse"])
def test_forward_logits_match(arch, ffn):
    """InternVL2: 8 vision positions through the frontend before 20 text
    tokens, positions over all 28.  Whisper: the encoder (no final norm)
    over 8 frames through the frontend, the decoder's positions from 0."""
    p = pair(arch, **KNOBS[ffn])
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, p.jcfg.vocab, (2, 20), dtype=np.int32)
    emb = _embeds(p, 2)
    key = "vis_embeds" if arch == VLM else "enc_embeds"
    with japi.use_backend("reference"):
        want, _ = p.jmodel.forward(p.jparams, jnp.asarray(tokens),
                                   **{key: jnp.asarray(emb)})
    with torch.no_grad():
        got, aux = p.model(torch.from_numpy(tokens).long(),
                           **{key: torch.from_numpy(emb)}, return_aux=True)
    t = 28 if arch == VLM else 20
    assert got.shape == want.shape == (2, t, p.jcfg.padded_vocab)
    assert rel(got, want) <= RTOL
    assert float(aux) == 0.0
    if arch == WHISPER:
        assert [b.causal for b in p.model.enc] == [False, False]
        with pytest.raises(ValueError, match="enc_embeds"):
            p.model(torch.from_numpy(tokens).long())


@pytest.mark.parametrize("arch,ffn,remat", [
    (VLM, "dense", False), (VLM, "sparse", True), (WHISPER, "dense", False),
    (WHISPER, "sparse", True)])
def test_loss_and_every_gradient_match(arch, ffn, remat):
    """The pipeline's batch (``vis_embeds`` / ``enc_embeds`` included); the
    loss on the text positions only (the vision prefix trimmed), and every
    gradient (frontend, encoder and decoder blocks, sparse FFN blocks)
    against ``jax.grad``."""
    p = pair(arch, remat=remat, **KNOBS[ffn])
    batch = JaxDataset(p.jcfg, JaxShapeConfig("tiny", "train", 20, 2),
                       seed=3).batch(0)
    if arch == VLM:
        assert batch["tokens"].shape == (2, 20 - p.cfg.n_frontend_tokens)
    check_loss_and_grads(p, batch)


@pytest.mark.parametrize("with_enc", [True, False])
def test_whisper_decode_steps_match(with_enc, whisper_pair):
    """A 5-token chunk, then single steps at per-row positions, with the
    encoder's output (cross attention over 8 frames) and without it (the
    cross blocks then attend over the step's own tokens, unmasked, as
    ``repro``'s do): every call's logits and the KV cache after."""
    p = whisper_pair
    rng = np.random.default_rng(3)
    b = 2
    emb = _embeds(p, b)
    with japi.use_backend("reference"):
        jenc = _jax_encode(p, emb) if with_enc else None
    with torch.no_grad():
        enc = p.model.encode(torch.from_numpy(emb)) if with_enc else None
    if with_enc:
        assert rel(enc, jenc) <= RTOL
    jcache = p.jmodel.init_cache(b, 16)
    cache = p.model.init_cache(b, 16)
    assert set(jcache) == {"dec"}
    steps = [(rng.integers(0, p.jcfg.vocab, (b, 5), dtype=np.int32), 0)] + [
        (rng.integers(0, p.jcfg.vocab, (b, 1), dtype=np.int32),
         np.array([5 + s, 7 + s], np.int32)) for s in range(4)]
    jstep = jax.jit(p.jmodel.decode_step)
    for tok, pos in steps:
        with japi.use_backend("reference"):
            jl, jcache = jstep(p.jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(pos), jenc)
        tp = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
        with torch.no_grad():
            gl, _ = p.model.decode_step(cache, torch.from_numpy(tok).long(),
                                        tp, enc)
        assert rel(gl, jl) <= RTOL
    for k in ("k", "v"):
        assert rel(cache[k], jcache["dec"]["kv"][k]) <= RTOL, k


def test_whisper_engine_raises_in_both(whisper_pair):
    p = whisper_pair
    with pytest.raises(NotImplementedError) as want:
        JaxEngine(p.jmodel, p.jparams, slots=1, max_len=16)
    with pytest.raises(NotImplementedError) as got:
        Engine(p.model, slots=1, max_len=16, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ffn,quantize", [("dense", None),
                                          ("sparse", None),
                                          ("sparse", "int8")])
def test_vlm_engine_tokens_match_jax_engine(ffn, quantize):
    """Text-only serving, as ``repro``'s engine serves a VLM: prefill
    buckets (16, 8), 3 requests over 2 slots."""
    p = pair(VLM, **KNOBS[ffn])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, p.jcfg.vocab, n, dtype=np.int32)
               for n in (19, 3, 8)]
    kw = dict(slots=2, max_len=40, prefill_buckets=(16, 8),
              quantize=quantize)
    want = [r.out_tokens.tolist() for r in JaxEngine(
        p.jmodel, p.jparams, backend="reference", **kw).generate(
        [JaxRequest(prompt=q.copy(), max_new_tokens=6) for q in prompts])]
    got = [r.out_tokens.tolist() for r in Engine(
        p.model, device="cpu", **kw).generate(
        [Request(prompt=q.copy(), max_new_tokens=6) for q in prompts])]
    assert got == want


@pytest.mark.parametrize("arch", [VLM, WHISPER])
@pytest.mark.parametrize("seed,step", [(1234, 0), (7, 13)])
def test_pipeline_embeds_bit_equal(arch, seed, step):
    """``vis_embeds`` (InternVL2, whose text is then ``n_frontend_tokens``
    shorter) and ``enc_embeds`` (Whisper), bit for bit."""
    shape = dict(name="tiny", kind="train", seq_len=24, global_batch=3)
    want = JaxDataset(jax_reduced(JAX_REGISTRY[arch]),
                      JaxShapeConfig(**shape), seed=seed).batch(step)
    got = SyntheticDataset(reduced_config(REGISTRY[arch]),
                           ShapeConfig(**shape), seed=seed).batch(step)
    key = "vis_embeds" if arch == VLM else "enc_embeds"
    assert set(got) == set(want) == {"tokens", "targets", key}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got[key].shape == (3, 8, 64)


def test_whisper_trainer_tracks_repro_trainer():
    """3 steps of ``Trainer`` against ``repro.runtime.Trainer`` on the
    block-sparse Whisper (the pipeline's ``enc_embeds`` reach
    ``loss_fn``): loss and pre-clip gradient norm of every step within
    1e-4, the final weights within the bound of
    ``tests/test_torch_train.py`` (2 · Σ lr, 99.9 % quantile 1e-6)."""
    tc = dict(steps=3, log_every=1, peak_lr=1e-3, warmup=2)
    shape = dict(name="tiny", kind="train", seq_len=16, global_batch=2)
    p = pair(WHISPER, **SPARSE)
    jtrainer = JaxTrainer(p.jmodel, p.jcfg, JaxShapeConfig(**shape),
                          JaxTrainerConfig(**tc))
    init = np_tree(jtrainer.state[0])
    with japi.use_backend("reference"):
        want = jtrainer.run()
    final = np_tree(jtrainer.state[0])
    trainer = Trainer(p.model, p.cfg, ShapeConfig(**shape),
                      TrainerConfig(**tc))
    p.model.load_state_dict(params_from_jax(p.cfg, init, p.patterns))
    got = trainer.run()
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=RTOL)
    lr = cosine_with_warmup(tc["peak_lr"], tc["warmup"], tc["steps"])
    atol = 2 * sum(lr(s) for s in range(1, tc["steps"] + 1))
    want_p = params_from_jax(p.cfg, final, p.patterns)
    for k, t in p.model.named_parameters():
        d = np.abs(t.detach().numpy() - want_p[k].numpy())
        assert d.max() <= atol, k
        assert np.quantile(d, 0.999) <= 1e-6, k
