"""The port's config registry and public names against ``repro``'s, and the
dense variants of the registry (MHA, QKV bias, wide GQA, untied head)
against ``repro``'s models, on the CPU.

Forward logits run at ``reduced_config`` in fp32 with ``repro``'s ``init``
output carried over by ``repro_torch.convert.params_from_jax``; random QKV
biases replace ``init``'s zeros so that a bias the port dropped would
show.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.configs as jax_configs  # noqa: E402
import repro.kernels as jax_kernels  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Request, Server  # noqa: E402

RTOL = 1e-4          # fp32 on both sides (tests/test_torch_model.py)
ARCHS = list(jax_configs.REGISTRY)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_registry_order_and_helpers():
    assert list(configs.REGISTRY) == list(jax_configs.REGISTRY)
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == jax_configs.LONG_CONTEXT_ARCHS


def test_shapes_are_repro_copies():
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_configs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_param_counts_match(arch):
    """``cell_is_live`` over the arch's four shapes (all 40 cells across
    the parametrisation), ``param_count`` and ``active_param_count``."""
    for shape in jax_configs.SHAPES:
        assert configs.cell_is_live(arch, shape) == \
            jax_configs.cell_is_live(arch, shape)
    mine, theirs = configs.get_config(arch), jax_configs.get_config(arch)
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    small = configs.reduced_config(mine)
    assert small.active_param_count() == \
        jax_configs.reduced_config(theirs).active_param_count()


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b", "rwkv6-1.6b",
                                  "internvl2-2b", "whisper-tiny"])
def test_unported_families_raise(arch):
    cfg = configs.reduced_config(configs.get_config(arch))
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


def test_backend_names():
    assert api.available_backends() == api.BACKENDS == ("cuda", "reference")
    assert set(jax_api.available_backends()) >= {"reference"}
    try:
        api.set_default_backend("reference")
        assert api.default_backend() == "reference"
        with api.use_backend("cuda"):
            assert api.default_backend() == "cuda"
        assert api.default_backend() == "reference"
        with pytest.raises(ValueError, match="unknown backend"):
            api.set_default_backend("pallas")
        assert api.default_backend() == "reference"
    finally:
        api.set_default_backend(None)
    assert api.default_backend() == "cuda"
    with pytest.raises(ValueError):                 # repro raises the same
        jax_api.set_default_backend("cuda")


def test_api_exports_repro_names():
    """Every name ``repro.api`` exports (the plan verifier's being
    ``repro_torch.analysis``'), the quantization names being
    ``repro_torch.core``'s."""
    from repro_torch import analysis
    assert set(jax_api.__all__) - set(api.__all__) == set()
    for name in ("verify_plan", "Finding", "VerifyResult",
                 "PlanVerificationError"):
        assert getattr(api, name) is getattr(analysis, name)
    for name in ("QUANT_DTYPES", "QuantizedBlocks", "quantize_blocks",
                 "dequantize_blocks", "quant_error_bound"):
        assert getattr(api, name) is getattr(formats, name)


def test_kernels_package_names():
    """``repro.kernels``' package-level names but ``INTERPRET`` (no
    interpret mode in the port): the ``ops`` objects themselves."""
    assert set(jax_kernels.__all__) - set(kernels.__all__) == {"INTERPRET"}
    for name in ("flash_mha", "moe_apply", "rg_lru_scan", "plan_spmm",
                 "plan_spgemm", "SpmmPlan", "SpgemmPlan"):
        assert getattr(kernels, name) is getattr(ops, name)


def _dense_pair(arch, **knobs):
    knobs = dict(dtype="float32", **knobs)
    jcfg = dataclasses.replace(
        jax_configs.reduced_config(jax_configs.get_config(arch)), **knobs)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(9)
        attn = jparams["layers"]["attn"]
        for name in ("wq", "wk", "wv"):
            b = attn[name]["b"]
            attn[name]["b"] = jnp.asarray(
                rng.standard_normal(b.shape).astype(np.float32) * 0.5)
    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config(arch)), **knobs)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, model


# reduced_config cuts every model to 4 heads over at most 2 KV heads;
# phi3-mini's MHA (n_kv = n_heads) is kept by setting n_kv back to 4
@pytest.mark.parametrize("arch,knobs", [
    ("phi3-mini-3.8b", dict(n_kv=4)),
    ("qwen1.5-4b", {}),
    ("command-r-plus-104b", {}),
    ("granite-3-8b", dict(tie_embeddings=False)),
], ids=["phi3-mini-mha", "qwen1.5-qkv-bias", "command-r-plus",
        "granite-untied"])
def test_dense_variant_forward_matches(arch, knobs):
    jcfg, jmodel, jparams, model = _dense_pair(arch, **knobs)
    assert (model.lm_head is None) == jcfg.tie_embeddings
    if jcfg.qkv_bias:
        assert model.layers[0].attn.wq.b is not None
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 20),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.shape == want.shape
    assert _rel(got, want) <= RTOL


def test_server_tokens_match_jax_server():
    jcfg, jmodel, jparams, model = _dense_pair("qwen1.5-4b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (3, 19, 8)]
    jsrv = JaxServer(jmodel, jparams, batch_slots=2, max_len=48,
                     prefill_buckets=(16, 8), backend="reference")
    want = [r.out_tokens.tolist() for r in jsrv.generate(
        [JaxRequest(prompt=p.copy(), max_new_tokens=5) for p in prompts])]
    srv = Server(model, batch_slots=2, max_len=48, prefill_buckets=(16, 8),
                 device="cpu")
    assert srv.slots == 2 and srv.max_len == 48
    got = [r.out_tokens.tolist() for r in srv.generate(
        [Request(prompt=p.copy(), max_new_tokens=5) for p in prompts])]
    assert got == want
