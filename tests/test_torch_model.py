"""The port's transformer and serving engine against ``repro``'s, on shared
weights, on the CPU.

The JAX model is ``reduced_config(granite-3-8b)`` with an fp32 block-sparse
FFN (``ffn_block=32``); its ``init`` output and shared FFN patterns are
carried over with ``repro_torch.convert.params_from_jax``.  The JAX side
runs its ``"reference"`` backend; the port runs its default ``"cuda"``
backend, which on CPU tensors is the kernel's plain version.
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
from repro.runtime import Engine as JaxEngine  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402

from repro_torch.configs import REGISTRY, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.segment_spmm import segment_spmm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Engine, Request  # noqa: E402

# fp32 on both sides; summation orders differ (plain gather-bmm vs dense)
RTOL = 1e-4
KNOBS = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY["granite-3-8b"]),
                               **KNOBS)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    patterns = {p: (np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_brow),
                    np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_bcol))
                for p in ("up", "gate", "down")}
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              **KNOBS)
    model = build_model(cfg, device="cpu", ffn_patterns=patterns)
    model.load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), patterns))
    return jcfg, jmodel, jparams, model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_forward_logits_match(pair):
    jcfg, jmodel, jparams, model = pair
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 20),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (2, 20, jcfg.padded_vocab)
    assert _rel(got, want) <= RTOL


def test_decode_step_with_cache_matches(pair):
    """A chunked prefill (t > 8) and then a per-row-position decode step,
    both through the KV cache."""
    jcfg, jmodel, jparams, model = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab, (2, 12), dtype=np.int32)
    last = np.array([11, 6], np.int32)
    nxt = rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)
    pos = np.array([12, 7], np.int32)

    jcache = jmodel.init_cache(2, 32)
    jl1, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(prompt), 0,
                                     logit_idx=jnp.asarray(last))
    jl2, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt),
                                jnp.asarray(pos))

    cache = model.init_cache(2, 32)
    with torch.no_grad():
        l1, cache = model.decode_step(cache, torch.from_numpy(prompt).long(),
                                      0, logit_idx=torch.from_numpy(last))
        l2, _ = model.decode_step(cache, torch.from_numpy(nxt).long(),
                                  torch.from_numpy(pos).long())
    assert _rel(l1, jl1) <= RTOL
    assert _rel(l2, jl2) <= RTOL


def test_engine_greedy_tokens_match_jax_engine(pair):
    jcfg, jmodel, jparams, model = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (4, 17, 31)]
    jeng = JaxEngine(jmodel, jparams, slots=2, max_len=64,
                     prefill_buckets=(16, 8), backend="reference")
    want = [r.out_tokens.tolist() for r in jeng.generate(
        [JaxRequest(prompt=p.copy(), max_new_tokens=6) for p in prompts])]
    eng = Engine(model, slots=2, max_len=64, prefill_buckets=(16, 8),
                 device="cpu")
    before = segment_spmm.launches
    got = [r.out_tokens.tolist() for r in eng.generate(
        [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts])]
    assert got == want
    assert segment_spmm.launches == before      # CPU tensors: plain version
    assert eng.compiled_shapes == {"decode": 1, "prefill": 2}
