"""The port's training slice against ``repro``'s, on the CPU: loss and
gradients of the model, the optimizer, schedules and data, the trainer,
checkpoints and the command line.

The JAX model is ``reduced_config(granite-3-8b)`` with an fp32
block-sparse FFN (``ffn_block=32``); its weights and shared FFN patterns
are carried over with ``repro_torch.convert.params_from_jax``.  The JAX side
runs its ``"reference"`` backend; the port runs its default ``"cuda"``
backend, which on CPU tensors is the kernel's plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import cosine_with_warmup as jcosine  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.api import executor  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.optim import AdamW, constant, cosine_with_warmup  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# fp32 on both sides; summation orders differ (plain gather-bmm vs dense,
# torch vs XLA reductions), and 2 layers of attention and FFN amplify them
RTOL = 1e-4
KNOBS = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)
SHAPE = dict(name="tiny", kind="train", seq_len=16, global_batch=4)


def _rel(got, want):
    """Largest deviation relative to the largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_model(remat=False):
    jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY["granite-3-8b"]),
                               remat=remat, **KNOBS)
    jmodel = jax_build(jcfg)
    patterns = {p: (np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_brow),
                    np.asarray(getattr(jmodel.sparse_mlp, p).plan.a_bcol))
                for p in ("up", "gate", "down")}
    return jcfg, jmodel, patterns


def _port_model(patterns, remat=False):
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              remat=remat, **KNOBS)
    return cfg, build_model(cfg, device="cpu", ffn_patterns=patterns)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --- loss and gradients -------------------------------------------------------


def test_cross_entropy_matches_repro():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                     None if m is None else jnp.asarray(m))
        got = layers.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    zero = layers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets), torch.zeros(2, 5))
    assert float(zero) == 0.0          # an all-zero mask divides by 1


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_repro(remat, monkeypatch):
    jcfg, jmodel, patterns = _jax_model(remat)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = JaxDataset(jcfg, JaxShapeConfig(**SHAPE), seed=3).batch(0)
    with japi.use_backend("reference"):
        (jloss, jaux), jgrads = jax.value_and_grad(
            jmodel.loss_fn, has_aux=True)(
                jparams, jax.tree.map(jnp.asarray, batch))
    cfg, model = _port_model(patterns, remat)
    model.load_state_dict(params_from_jax(cfg, _np_tree(jparams), patterns))
    want = params_from_jax(cfg, _np_tree(jgrads), patterns)

    calls = {"forward": 0, "transpose_lhs": 0}
    spmm = executor.segment_spmm

    def counting(*a, transpose_lhs=False, **kw):
        calls["transpose_lhs" if transpose_lhs else "forward"] += 1
        return spmm(*a, transpose_lhs=transpose_lhs, **kw)

    monkeypatch.setattr(executor, "segment_spmm", counting)
    loss, aux = model.loss_fn({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=RTOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        assert _rel(p.grad.numpy(), want[k].numpy()) <= RTOL, k
    # remat runs each block's forward again in the backward pass: every
    # projection launches twice forward and once transposed (dx)
    proj = 3 * cfg.n_layers
    assert calls == {"forward": proj * (2 if remat else 1),
                     "transpose_lhs": proj}


# --- optimizer, schedules, data ---------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])   # clipping on / off
def test_adamw_matches_repro(state_dtype, clip_norm):
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jopt = JaxAdamW(lr=jcosine(1e-2, 2, 10), clip_norm=clip_norm,
                    state_dtype=getattr(jnp, state_dtype))
    opt = AdamW(lr=cosine_with_warmup(1e-2, 2, 10), clip_norm=clip_norm,
                state_dtype=getattr(torch, state_dtype))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for _ in range(4):
        grads = {k: (rng.standard_normal(s) * 0.7).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jstate, jm = jopt.update({k: jnp.asarray(g)
                                      for k, g in grads.items()}, jstate, jp)
        tm = opt.update({k: torch.from_numpy(g) for k, g in grads.items()},
                        tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            for t, j in ((tstate.m[k], jstate.m[k]), (tstate.v[k],
                                                      jstate.v[k])):
                assert t.dtype == getattr(torch, state_dtype)
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(j, np.float32),
                    rtol=1e-2 if state_dtype == "bfloat16" else 1e-5,
                    atol=1e-7)
    assert tstate.step == int(jstate.step) == 4


def test_grad_clip_reports_the_pre_clip_norm():
    opt = AdamW(lr=constant(0.0), clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    m = opt.update({"x": torch.full((3,), 100.0)}, opt.init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(100.0 * np.sqrt(3))
    assert torch.equal(params["x"], torch.zeros(3))   # lr 0: no move


def test_schedules_match_repro():
    # both in float32; XLA's cos and numpy's may differ in the last bit
    for args in ((1e-3, 10, 100), (3e-4, 0, 50), (1.0, 7, 7)):
        want, got = jcosine(*args), cosine_with_warmup(*args)
        for step in range(0, args[2] + 5):
            assert got(step) == pytest.approx(float(want(jnp.int32(step))),
                                              rel=1e-6, abs=0), (args, step)
    assert constant(0.1)(3) == float(jconstant(0.1)(jnp.int32(3)))


@pytest.mark.parametrize("seed,step", [(1234, 0), (7, 13), (2, 999)])
def test_synthetic_batches_bit_equal(seed, step):
    jcfg = jax_reduced(JAX_REGISTRY["granite-3-8b"])
    cfg = reduced_config(REGISTRY["granite-3-8b"])
    want = JaxDataset(jcfg, JaxShapeConfig(**SHAPE), seed=seed)
    got = SyntheticDataset(cfg, ShapeConfig(**SHAPE), seed=seed)
    w, g = want.batch(step), got.batch(step)
    assert set(w) == set(g) == {"tokens", "targets"}
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k])


def test_param_count_matches_repro():
    for name in REGISTRY:
        assert REGISTRY[name].param_count() == \
            JAX_REGISTRY[name].param_count()
        assert reduced_config(REGISTRY[name]).param_count() == \
            jax_reduced(JAX_REGISTRY[name]).param_count()


# --- trainer ---------------------------------------------------------------------


def _sum_lr(tc):
    lr = cosine_with_warmup(tc["peak_lr"], tc["warmup"], tc["steps"])
    return sum(lr(s) for s in range(1, tc["steps"] + 1))


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_tracks_repro_trainer(accum):
    tc = dict(steps=3, log_every=1, accum_steps=accum, peak_lr=1e-3,
              warmup=2)
    jcfg, jmodel, patterns = _jax_model()
    jtrainer = JaxTrainer(jmodel, jcfg, JaxShapeConfig(**SHAPE),
                          JaxTrainerConfig(**tc))
    init = _np_tree(jtrainer.state[0])
    with japi.use_backend("reference"):
        want = jtrainer.run()
    final = _np_tree(jtrainer.state[0])

    cfg, model = _port_model(patterns)
    trainer = Trainer(model, cfg, ShapeConfig(**SHAPE), TrainerConfig(**tc))
    model.load_state_dict(params_from_jax(cfg, init, patterns))
    got = trainer.run()
    assert [h["step"] for h in got["history"]] == [0, 1, 2]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL)
    # AdamW's first step moves each weight by ~lr·sign(g), so a gradient
    # element near zero, whose sign the two summation orders may disagree
    # on, can move the two copies apart by up to 2·lr a step: the bound is
    # 2·Σ lr over the run.  Away from such elements the copies agree to
    # fp32 noise, which the 99.9 % quantile holds to 1e-6.
    atol = 2 * _sum_lr(tc)
    want_p = params_from_jax(cfg, final, patterns)
    for k, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want_p[k].numpy())
        assert d.max() <= atol, k
        assert np.quantile(d, 0.999) <= 1e-6, k


# --- checkpoint ------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        state = {"params/a": torch.arange(10, dtype=torch.float32),
                 "params/b.c": torch.ones((3, 3), dtype=torch.bfloat16),
                 "opt/step": torch.tensor(5, dtype=torch.int32)}
        for step in (5, 10, 15):
            mgr.save(step, state, wait=True)
        assert mgr.all_steps() == [10, 15]          # gc keeps the last 2
        assert mgr.latest_step() == 15
        restored = mgr.restore(15, state)
        assert set(restored) == set(state)
        for k, t in state.items():
            assert restored[k].dtype == t.dtype
            assert torch.equal(restored[k], t)
        # no stale staging directories (atomic commit), and the layout is
        # repro's: step_<N>/manifest.json + arrays.npz
        assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
        with open(os.path.join(d, "step_00000015", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 15 and manifest["n_leaves"] == 3
        assert manifest["keys"] == list(state)
        assert manifest["dtypes"] == ["float32", "float32", "int32"]
        with pytest.raises(ValueError, match="lacks"):
            mgr.restore(15, {"params/z": torch.zeros(1)})


def test_checkpoint_copies_state_before_returning():
    """The trainer updates its tensors in place right after ``save``; the
    background write must see the values at the call."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = torch.zeros(1000)
        mgr.save(1, {"x": t})
        t.add_(1.0)
        mgr.wait()
        assert torch.equal(mgr.restore(1, {"x": t})["x"], torch.zeros(1000))


class _Crash(Exception):
    pass


def test_crash_resume_matches_uninterrupted_bit_for_bit():
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              **KNOBS)
    shape = ShapeConfig(**SHAPE)
    tc = dict(steps=6, ckpt_every=3, log_every=1, accum_steps=2,
              peak_lr=1e-3, warmup=2)

    def trainer(d):
        return Trainer(build_model(cfg, device="cpu"), cfg, shape,
                       TrainerConfig(ckpt_dir=d, **tc))

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t_ref = trainer(d1)
        ref = t_ref.run()

        t1 = trainer(d2)

        def boom(step):
            if step == 3:          # after the step-3 checkpoint
                t1.ckpt.wait()
                raise _Crash()

        with pytest.raises(_Crash):
            t1.run(failure_hook=boom)
        t2 = trainer(d2)
        assert t2.start_step == 3 and t2.opt_state.step == 3
        out = t2.run()
        assert out["final_loss"] == ref["final_loss"]
        assert [h["loss"] for h in out["history"]] == \
            [h["loss"] for h in ref["history"][3:]]
        for (k, p), q in zip(t2.model.named_parameters(),
                             t_ref.model.parameters()):
            assert torch.equal(p, q), k
        for k in t2.opt_state.m:
            assert torch.equal(t2.opt_state.m[k], t_ref.opt_state.m[k]), k
            assert torch.equal(t2.opt_state.v[k], t_ref.opt_state.v[k]), k


def test_train_cli_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--sparse-ffn", "--steps", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        check=True, timeout=300).stdout.splitlines()
    assert out[0].startswith("step      0  loss ")
    last = json.loads(out[-1])
    assert np.isfinite(last["final_loss"])
    assert last["params"] == reduced_config(
        REGISTRY["granite-3-8b"]).param_count()
