"""Reading ``repro``'s checkpoints into the port, on the CPU: the leaf layout
of every config against ``jax.tree_util``, and the port's trainer resumed
from a checkpoint that ``repro``'s trainer wrote, against ``repro``'s own
uninterrupted run."""
import dataclasses
import json
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.checkpoint import (JaxCheckpoint, jax_state_layout,  # noqa: E402
                                    restore_jax_checkpoint)
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

from _torch_families import np_tree, patterns_of  # noqa: E402

SPARSE = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)
# the resumed run: its state at the resume step is repro's, bit for bit;
# the two steps after it differ only in summation order (torch vs XLA)
LOSS_RTOL = 1e-3
PARAM_ATOL = 1e-4


def _configs(arch, sparse):
    knobs = SPARSE if sparse else dict(dtype="float32")
    return (dataclasses.replace(jax_reduced(JAX_REGISTRY[arch]), **knobs),
            dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_layout_matches_jax_flatten_order(arch, sparse):
    """Leaf for leaf: the path, the shape, and one port name a layer of a
    stacked leaf."""
    jcfg, cfg = _configs(arch, sparse)
    jmodel = jax_build(jcfg)

    def state():
        params = jmodel.init(jax.random.PRNGKey(0))
        return params, JaxAdamW(lr=jconstant(1e-3)).init(params)

    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(state))[0]
    got = jax_state_layout(cfg, patterns_of(jmodel))
    assert [leaf.path for leaf in got] == \
        [jax.tree_util.keystr(p) for p, _ in leaves]
    assert [leaf.shape for leaf in got] == [tuple(a.shape) for _, a in leaves]
    model = build_model(cfg, device="cpu", ffn_patterns=patterns_of(jmodel))
    names = [n for leaf in got for n in leaf.names]
    n_params = len(list(model.named_parameters()))
    assert len(names) == len(set(names)) == 3 * n_params + 1
    for leaf in got:
        top = leaf.path.partition("['")[2].split("'")[0]
        stacked = top in ("layers", "units", "tail", "enc", "dec")
        assert len(leaf.names) == (leaf.shape[0] if stacked else 1), leaf


def _repro_run(arch, tc, shape, d):
    jcfg, cfg = _configs(arch, sparse=True)
    jmodel = jax_build(jcfg)
    jt = JaxTrainer(jmodel, jcfg, JaxShapeConfig(**shape),
                    JaxTrainerConfig(ckpt_dir=d, ckpt_every=1, **tc))
    with japi.use_backend("reference"):
        out = jt.run()
    return cfg, patterns_of(jmodel), out, np_tree(jt.state[0])


@pytest.mark.parametrize("arch,shape,accum", [
    ("granite-3-8b", dict(seq_len=16, global_batch=4), 2),
    ("recurrentgemma-9b", dict(seq_len=40, global_batch=2), 1)],
    ids=["granite", "hybrid"])
def test_port_resumes_repro_checkpoint(arch, shape, accum):
    """``repro``'s trainer runs 4 steps with a checkpoint after each; the
    port's trainer resumes from its step-2 checkpoint: steps 2 and 3's
    losses within 1e-3 of ``repro``'s uninterrupted run, the final
    parameters within 1e-4."""
    tc = dict(steps=4, log_every=1, accum_steps=accum)
    shape = dict(name="tiny", kind="train", **shape)
    with tempfile.TemporaryDirectory() as d:
        cfg, pats, want, final = _repro_run(arch, tc, shape, d)
        assert JaxCheckpoint(d, cfg, pats).latest_step() == 4
        sd = restore_jax_checkpoint(d, 2, cfg, pats, device="cpu")
    trainer = Trainer(build_model(cfg, device="cpu", ffn_patterns=pats),
                      cfg, ShapeConfig(**shape), TrainerConfig(**tc))
    trainer.load_state_dict(sd)
    trainer.start_step = 2
    assert trainer.opt_state.step == 2
    got = trainer.run()
    assert [h["step"] for h in got["history"]] == [2, 3]
    for g, w in zip(got["history"], want["history"][2:]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    want_p = params_from_jax(cfg, final, pats)
    for k, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_restore_casts_places_and_checks_the_manifest():
    """``JaxCheckpoint.restore`` casts into the state's dtypes (bf16
    moments come back bf16 from the fp32 npz); a checkpoint of another
    model, or one whose manifest disagrees, raises."""
    tc = dict(steps=1, log_every=1)
    shape = dict(name="tiny", kind="train", seq_len=16, global_batch=2)
    with tempfile.TemporaryDirectory() as d:
        cfg, pats, _, final = _repro_run("granite-3-8b", tc, shape, d)
        sd = restore_jax_checkpoint(d, 1, cfg, pats, device="cpu")
        want = params_from_jax(cfg, final, pats)
        for k, t in want.items():
            assert torch.equal(sd[f"params/{k}"], t), k
        assert int(sd["opt/step"]) == 1
        like = {k: (t.to(torch.bfloat16) if k.startswith("opt/m/") else t)
                for k, t in sd.items()}
        got = JaxCheckpoint(d, cfg, pats).restore(1, like)
        for k, t in like.items():
            assert got[k].dtype == t.dtype, k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          t.float().numpy())
        untied = dataclasses.replace(cfg, tie_embeddings=False)
        with pytest.raises(ValueError, match="leaves"):
            restore_jax_checkpoint(d, 1, untied, pats, device="cpu")
        deeper = dataclasses.replace(cfg, n_layers=3)
        with pytest.raises(ValueError, match=r"expected \(3, "):
            restore_jax_checkpoint(d, 1, deeper, pats, device="cpu")
        path = os.path.join(d, "step_00000001", "manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        manifest["shapes"][0] = [1, 2]
        with open(path, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(ValueError, match="leaf_00000"):
            restore_jax_checkpoint(d, 1, cfg, pats, device="cpu")
        shutil.rmtree(os.path.join(d, "step_00000001"))
        assert JaxCheckpoint(d, cfg, pats).all_steps() == []
