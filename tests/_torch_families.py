"""Shared helpers of the port's model-family parity tests
(``tests/test_torch_ssm.py``, ``test_torch_moe.py``,
``test_torch_encdec.py``): a ``repro`` model and the port's on the same
weights, and the error measure the tolerances are stated in."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import api as japi
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import reduced_config as jax_reduced
from repro.models import build_model as jax_build

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

# fp32 on both sides; summation orders differ (torch vs XLA reductions)
RTOL = 1e-4
# bf16 activations: one bf16 rounding (2**-8) of each product and sum
BF16_RTOL = 1e-2
FP32 = dict(dtype="float32")
SPARSE = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)


def rel(got, want):
    """Largest deviation relative to the largest magnitude of ``want``."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)
                      if isinstance(want, jax.Array) else want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def patterns_of(jmodel):
    """``{proj: (brow, bcol)}`` of a JAX model's shared FFN plans."""
    if jmodel.sparse_mlp is None:
        return None
    return {p: (np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_brow),
                np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_bcol))
            for p in ("up", "gate", "down")}


@dataclasses.dataclass
class Pair:
    jcfg: object
    jmodel: object
    jparams: dict
    cfg: object
    model: object
    patterns: object


def pair(arch, **knobs) -> Pair:
    """``reduced_config(arch)`` with ``knobs`` in both packages: ``repro``'s
    ``init`` from key 0, carried over to the port's model by
    ``convert.params_from_jax`` (every key used, none left over)."""
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY[arch]), **knobs)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    pats = patterns_of(jmodel)
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
    model = build_model(cfg, device="cpu", ffn_patterns=pats)
    model.load_state_dict(params_from_jax(cfg, np_tree(jparams), pats))
    return Pair(jcfg, jmodel, jparams, cfg, model, pats)


def jax_loss_and_grads(p: Pair, batch):
    """``repro``'s loss, its metrics and the gradients as the port's state
    dict, on the ``"reference"`` backend."""
    with japi.use_backend("reference"):
        (loss, metrics), grads = jax.value_and_grad(
            p.jmodel.loss_fn, has_aux=True)(
                p.jparams, jax.tree.map(jnp.asarray, batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            params_from_jax(p.cfg, np_tree(grads), p.patterns))


def check_loss_and_grads(p: Pair, batch, rtol=RTOL):
    """The port's ``loss_fn`` and every parameter's gradient against
    ``jax.grad`` of ``repro``'s, within ``rtol``."""
    jloss, jmetrics, want = jax_loss_and_grads(p, batch)
    loss, metrics = p.model.loss_fn({k: torch.from_numpy(np.asarray(v))
                                     for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=rtol)
    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"],
                               rtol=rtol)
    np.testing.assert_allclose(float(metrics["aux"]), jmetrics["aux"],
                               rtol=rtol, atol=1e-7)
    named = dict(p.model.named_parameters())
    assert set(named) == set(want)
    for k, t in named.items():
        assert t.grad is not None, k
        assert rel(t.grad, want[k].numpy()) <= rtol, k
    p.model.zero_grad(set_to_none=True)
    return jmetrics
