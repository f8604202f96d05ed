"""Tensor parallelism on the ``model`` axis against one process and against
``repro``, on the CPU.

Each split module runs on gloo ranks (one process a rank, each launch
bounded by its own timeout, as ``tests/test_torch_distributed.py`` runs
them) over a (1, 2) and a (1, 4) mesh; its output and every gradient
(gathered to full tensors) are held against the same module unsplit in
this process and against ``repro``'s function on the same numpy
parameters.  Then the whole step: ``Trainer(mesh=)`` on reduced granite
(dense and sparse FFN) and the reduced hybrid against ``repro``'s
``Trainer(mesh=)`` on fake XLA devices and the single-process trainer;
decode on a (1, 2) mesh; the per-rank FLOPs of the step; checkpoints
saved under TP restored by one process and elastic restore onto a smaller
``model`` axis.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro.models import recurrent as jrecurrent  # noqa: E402

from repro_torch.sharding.tensor_parallel import TP  # noqa: E402

from test_torch_distributed import _gloo, _jax, _src  # noqa: E402

# the split module against the unsplit one: the same products, summed in
# another order by the all-reduces (measured worst 2.4e-7)
TP_RTOL = 1e-5
# against repro's jnp functions (as tests/_torch_families.py's RTOL)
REPRO_RTOL = 1e-4

# every module case: its constructor, its numpy parameters (port names),
# its inputs and its call, run alike on the ranks and in this process
CASES_SRC = """
import math
import numpy as np
import torch
from repro_torch.models import layers
from repro_torch.models.recurrent import RGLRUBlock

D, V = 64, 512
SEEDS = {"attn": 1, "attn_bias": 2, "attn_mqa_local": 3, "attn_cross": 4,
         "swiglu": 5, "vocab": 6, "rglru": 7}


def module_case(name):
    rng = np.random.default_rng(SEEDS[name])

    def w(*shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if name.startswith("attn"):
        kv = {"attn_mqa_local": 1}.get(name, 2)
        bias = name == "attn_bias"
        mod = layers.Attention(D, 4, kv, 16, qkv_bias=bias, device="cpu")
        state = {"wq.w": w(D, 64), "wk.w": w(D, 16 * kv),
                 "wv.w": w(D, 16 * kv), "wo.w": w(64, D)}
        if bias:
            state.update({"wq.b": w(64, scale=0.1), "wk.b": w(32, scale=0.1),
                          "wv.b": w(32, scale=0.1)})
        t = 20 if name == "attn_mqa_local" else 12
        x = w(2, t, D, scale=1.0)
        kw = dict(positions=torch.arange(t).expand(2, t))
        if name == "attn_mqa_local":
            kw["window"] = 8
        if name == "attn_cross":
            kw.update(causal=False, rope_theta=0.0,
                      kv_ctx=torch.from_numpy(w(2, 7, D, scale=1.0)))
        inputs = {"x": x}
    elif name == "swiglu":
        mod = layers.SwiGLU(D, 128, device="cpu")
        state = {"up.w": w(D, 128), "gate.w": w(D, 128), "down.w": w(128, D)}
        inputs, kw = {"x": w(2, 12, D, scale=1.0)}, {}
    elif name == "vocab":
        mod = layers.Embedding(V, D, device="cpu")
        state = {"table": w(V, D, scale=0.5)}
        inputs = {"x": w(2, 12, D, scale=1.0),
                  "tokens": rng.integers(0, V, (2, 12)),
                  "targets": rng.integers(0, V, (2, 12)),
                  "mask": (rng.random((2, 12)) < 0.7).astype(np.float32)}
        kw = {}
    else:
        mod = RGLRUBlock(D, device="cpu")
        state = {"conv": w(4, D, scale=0.2),
                 "a_param": rng.uniform(0.5, 2.0, D).astype(np.float32),
                 **{f"{n}.w": w(D, D) for n in
                    ("in_x", "in_g", "a_gate", "x_gate", "out")}}
        inputs, kw = {"x": w(2, 20, D, scale=1.0)}, {}
    ct = rng.standard_normal((2, inputs["x"].shape[1], D)).astype(np.float32)
    return mod, state, inputs, kw, ct


def run_case(name, mod, inputs, kw, ct, ce=None):
    \"\"\"The module's outputs and a scalar of them to differentiate;
    ``ce``: the cross entropy over (logits, targets, mask).\"\"\"
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    ctt = torch.from_numpy(ct)
    if name == "vocab":
        emb = mod(torch.from_numpy(inputs["tokens"]))
        logits = mod.head(x)
        tg = torch.from_numpy(inputs["targets"])
        ce_all = ce(logits, tg, None)
        ce_mask = ce(logits, tg, torch.from_numpy(inputs["mask"]))
        outs = {"embed": emb, "ce": ce_all, "ce_mask": ce_mask}
        loss = (emb * ctt).sum() + ce_all + 2.0 * ce_mask
        return outs, loss, x, logits
    if name == "rglru":
        out, state = mod(x)
        outs = {"out": out}
    else:
        out = mod(x, **kw)
        outs = {"out": out}
    return outs, (out * ctt).sum(), x, None
"""

MODULE_CASES = ("attn", "attn_bias", "attn_mqa_local", "attn_cross",
                "swiglu", "vocab", "rglru")
TP_WORLDS = (2, 4)


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tp_modules():
    """Every module case on gloo ranks over a (1, 2) and a (1, 4) mesh:
    each rank's outputs, full gradients (its slices all-gathered) and the
    local shapes of its split parameters."""
    runs = {}
    for world in TP_WORLDS:
        with tempfile.TemporaryDirectory() as out:
            runs[world] = _gloo(_src(CASES_SRC, """
            from repro_torch.launch.mesh import make_mesh
            from repro_torch.sharding.tensor_parallel import (
                gather_full, local, tp_group, vocab_cross_entropy)
            mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
            tp = tp_group(mesh)
            assert (tp.rank, tp.size) == (RANK, WORLD)
            res = {}
            for name in SEEDS:
                mod, state, inputs, kw, ct = module_case(name)
                mod.tensor_parallel_(tp)
                split = {f"{m}.{p}" if m else p: spec
                         for m, sub in mod.named_modules()
                         for p, spec in getattr(sub, "tp_local", {}).items()}
                with torch.no_grad():
                    for k, p in mod.named_parameters():
                        full = torch.from_numpy(state[k])
                        p.copy_(local(full, split[k][0], tp) if k in split
                                else full)
                outs, loss, x, _ = run_case(
                    name, mod, inputs, kw, ct,
                    ce=lambda lg, tg, m: vocab_cross_entropy(lg, tg, m, tp))
                loss.backward()
                grads = {"x": x.grad}
                for k, p in mod.named_parameters():
                    g = p.grad
                    grads[k] = (gather_full(g, split[k][0], tp) if k in split
                                else g)
                res[name] = {
                    "outs": {k: v.detach().tolist() for k, v in outs.items()},
                    "grads": {k: g.tolist() for k, g in grads.items()},
                    "local": {k: [list(p.shape), split[k][0]]
                              for k, p in mod.named_parameters()
                              if k in split}}
            emit(res)
            """), world, out, timeout=240)
    return runs


def _single(name):
    """The case in this process, unsplit: outputs and gradients."""
    ns = {}
    exec(CASES_SRC, ns)
    from repro_torch.models import layers
    mod, state, inputs, kw, ct = ns["module_case"](name)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    outs, loss, x, _ = ns["run_case"](name, mod, inputs, kw, ct,
                                      ce=layers.cross_entropy)
    loss.backward()
    grads = {"x": x.grad, **{k: p.grad for k, p in mod.named_parameters()}}
    return ({k: _np(v) for k, v in outs.items()},
            {k: _np(v) for k, v in grads.items()}, state, inputs, kw, ct)


def _jax_case(name, state, inputs, kw, ct):
    """``repro``'s function on the same parameters: outputs and gradients
    under the port's names."""
    ctj = jnp.asarray(ct)

    def nest(flat):
        tree = {}
        for k, v in flat.items():
            *path, leaf = k.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}{k}"
            out.update(flat(v, key + ".") if isinstance(v, dict)
                       else {key: np.asarray(v)})
        return out

    p = nest({k: jnp.asarray(v) for k, v in state.items()})
    x = jnp.asarray(inputs["x"])
    if name.startswith("attn"):
        kwj = dict(n_heads=4, n_kv={"attn_mqa_local": 1}.get(name, 2),
                   head_dim=16, positions=jnp.asarray(kw["positions"].numpy()),
                   causal=kw.get("causal", True), window=kw.get("window"),
                   rope_theta=kw.get("rope_theta", 10000.0))
        if "kv_ctx" in kw:
            kwj["kv_ctx"] = jnp.asarray(kw["kv_ctx"].numpy())

        def f(p, x):
            out = jlayers.attention_apply(p, x, **kwj)[0]
            return jnp.sum(out * ctj), {"out": out}
    elif name == "swiglu":
        def f(p, x):
            out = jlayers.swiglu_apply(p, x)
            return jnp.sum(out * ctj), {"out": out}
    elif name == "rglru":
        def f(p, x):
            out = jrecurrent.rglru_block_apply(p, x)[0]
            return jnp.sum(out * ctj), {"out": out}
    else:
        tokens = jnp.asarray(inputs["tokens"])
        targets = jnp.asarray(inputs["targets"])
        mask = jnp.asarray(inputs["mask"])

        def f(p, x):
            emb = jlayers.embedding_apply(p, tokens)
            logits = jlayers.lm_head_apply(p, x)
            ce_all = jlayers.cross_entropy(logits, targets)
            ce_mask = jlayers.cross_entropy(logits, targets, mask)
            return (jnp.sum(emb * ctj) + ce_all + 2.0 * ce_mask,
                    {"embed": emb, "ce": ce_all, "ce_mask": ce_mask})
    (_, outs), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(p, x)
    return ({k: np.asarray(v) for k, v in outs.items()},
            {"x": np.asarray(gx), **flat(gp)})


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("name", MODULE_CASES)
def test_split_module_matches_single_process_and_repro(name, world,
                                                       tp_modules):
    """The module split over ``world`` model ranks: every rank's outputs
    and every gradient (x's and each parameter's, its slices gathered)
    against the unsplit module within ``TP_RTOL`` and against ``repro``'s
    function within ``REPRO_RTOL``.  Granite's GQA (4 heads, 2 KV) splits
    its KV heads at 2 ranks and gathers them at 4 (a KV head then serves
    two ranks); the hybrid's MQA local block gathers its one KV head."""
    outs, grads, state, inputs, kw, ct = _single(name)
    jouts, jgrads = _jax_case(name, state, inputs, kw, ct)
    assert set(jgrads) == set(grads)
    for r, got in enumerate(tp_modules[world]):
        res = got[name]
        assert set(res["grads"]) == set(grads), r
        for k, want in outs.items():
            assert _rel(res["outs"][k], want) <= TP_RTOL, (r, k)
            assert _rel(res["outs"][k], jouts[k]) <= REPRO_RTOL, (r, k)
        for k, want in grads.items():
            assert _rel(res["grads"][k], want) <= TP_RTOL, (r, k)
            assert _rel(res["grads"][k], jgrads[k]) <= REPRO_RTOL, (r, k)


@pytest.mark.parametrize("world", TP_WORLDS)
def test_split_parameters_hold_one_share(world, tp_modules):
    """Each split parameter holds 1/tp of its full tensor along its split
    dim: attention ``wq`` columns and ``wo`` rows, ``wk``/``wv`` columns
    where ``model`` divides them, the SwiGLU's hidden units, the RG-LRU's
    four column-parallel projections and ``out``'s rows, the table's
    vocabulary rows; the others stay whole."""
    want = {"attn": {"wq.w": 1, "wk.w": 1, "wv.w": 1, "wo.w": 0},
            "attn_mqa_local": {"wq.w": 1, "wk.w": 1, "wv.w": 1, "wo.w": 0},
            "swiglu": {"up.w": 1, "gate.w": 1, "down.w": 0},
            "vocab": {"table": 0},
            "rglru": {"in_x.w": 1, "in_g.w": 1, "a_gate.w": 1,
                      "x_gate.w": 1, "out.w": 0}}
    ns = {}
    exec(CASES_SRC, ns)
    for name, dims in want.items():
        _, state, *_ = ns["module_case"](name)
        for r, got in enumerate(tp_modules[world]):
            loc = got[name]["local"]
            assert set(loc) == set(dims), (name, r)
            for k, dim in dims.items():
                shape, d = loc[k]
                full = list(state[k].shape)
                full[dim] //= world
                assert d == dim and shape == full, (name, k, r)


def test_tp_span_and_errors():
    """``TP.span`` splits evenly or raises; an attention whose heads do
    not split, or whose rank's heads read KV groups unevenly, raises."""
    from repro_torch.models import layers
    from repro_torch.sharding.tensor_parallel import TensorParallelError
    assert TP(1, 4).span(64) == (16, 32)
    with pytest.raises(TensorParallelError):
        TP(0, 3).span(64)
    with pytest.raises(TensorParallelError, match="query heads"):
        layers.Attention(64, 6, 2, 8, device="cpu").tensor_parallel_(
            TP(0, 4))
    # 6 heads in KV groups of 3 over 2 ranks: 3 a rank, whole groups
    a = layers.Attention(48, 6, 2, 8, device="cpu")
    a.tensor_parallel_(TP(1, 2))
    assert (a.n_heads, a.n_kv, a.kv_span) == (3, 1, (1, 2))
    # 6 heads in KV groups of 3 over 3 ranks: 2 a rank straddle a group
    with pytest.raises(TensorParallelError, match="unevenly"):
        layers.Attention(48, 6, 2, 8, device="cpu").tensor_parallel_(
            TP(0, 3))


# --- the whole step: Trainer(mesh=) against repro's and one process --------

STEP_KNOBS = {"dense": ("granite-3-8b", dict(dtype="float32", remat=True)),
              "sparse": ("granite-3-8b", dict(dtype="float32",
                                              ffn_block_sparse=True,
                                              ffn_block=32)),
              "hybrid": ("recurrentgemma-9b", dict(dtype="float32"))}
# the later steps' loss and norm (relative) and the final parameters (the
# 99.9 % quantile), where tests/test_torch_distributed.py's TRAIN_RTOL and
# PARAM_TOL do not hold: measured, the dense model's steps 1-2 within
# 1.3e-5 of repro's (the one-process trainer is 1.1e-5 from it), the
# hybrid's within 5.3e-5 of repro's and 5.8e-5 of one process (which is
# 9.2e-5 from repro) and its parameters within 6.7e-5 of either; its
# recurrence carries each early difference through every later position
STEP_TOL = {"dense": (3e-5, 2e-5), "hybrid": (2e-4, 1e-4)}
# (model, mesh sizes): the (2, 2) mesh of the sparse model is
# tests/test_torch_distributed.py's
STEP_RUNS = (("dense", (1, 4)), ("dense", (2, 2)), ("sparse", (1, 4)),
             ("hybrid", (1, 4)), ("hybrid", (2, 2)))


def _run_id(model, sizes):
    return f"{model}-{sizes[0]}x{sizes[1]}"


@pytest.fixture(scope="module")
def repro_tp(tmp_path_factory):
    """``repro``'s ``Trainer(mesh=)`` on 4 fake XLA devices for every run
    of ``STEP_RUNS`` (reference backend): the initial and final states
    under the port's names, the FFN patterns, each history, and the hybrid
    (1, 4) run's checkpoint in ``repro``'s layout."""
    from test_torch_distributed import TRAIN, TRAIN_SHAPE
    out = tmp_path_factory.mktemp("repro_tp")
    res = _jax(f"""
    import dataclasses, json, os, sys
    import jax, numpy as np
    from repro import api
    from repro.configs import REGISTRY as JR, reduced_config as jreduced
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.models import build_model
    from repro.runtime import Trainer, TrainerConfig
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.convert import params_from_jax
    sys.path.insert(0, "tests")
    from _torch_families import patterns_of

    OUT = {str(out)!r}
    res = {{}}
    for model_name, sizes in {STEP_RUNS!r}:
        arch, knobs = {STEP_KNOBS!r}[model_name]
        rid = f"{{model_name}}-{{sizes[0]}}x{{sizes[1]}}"
        jcfg = dataclasses.replace(jreduced(JR[arch]), **knobs)
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        model = build_model(jcfg)
        mesh = make_mesh(sizes, ("data", "model"))
        ckpt = (os.path.join(OUT, "ckpt-" + rid) if rid == "hybrid-1x4"
                else None)
        t = Trainer(model, jcfg, ShapeConfig(**{TRAIN_SHAPE!r}),
                    TrainerConfig(ckpt_dir=ckpt, **{TRAIN!r}), mesh=mesh)
        pats = patterns_of(model)
        init = jax.tree.map(np.array, t.state[0])
        with api.use_backend("reference"), mesh_context(mesh):
            res[rid] = t.run()["history"]
        for name, tree in (("init", init), ("final", t.state[0])):
            np.savez(f"{{OUT}}/{{name}}-{{rid}}.npz", **{{
                k: v.numpy() for k, v in params_from_jax(
                    cfg, jax.tree.map(np.asarray, tree), pats).items()}})
        if pats is not None:
            np.savez(f"{{OUT}}/patterns-{{rid}}.npz", **{{
                f"{{p}}_{{i}}": a for p, v in pats.items()
                for i, a in enumerate(v)}})
    print(json.dumps(res))
    """, devices=4, timeout=600)
    return out, res


STEP_SETUP = """
import dataclasses
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.runtime import Trainer, TrainerConfig


def load_pats(path):
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return {p: (z[p + "_0"], z[p + "_1"]) for p in ("up", "gate", "down")}


def trainer(arch, knobs, mesh, pats, **kw):
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
    return Trainer(build_model(cfg, device="cpu", ffn_patterns=pats), cfg,
                   ShapeConfig(**TRAIN_SHAPE), TrainerConfig(**kw, **TRAIN),
                   mesh=mesh)
"""


@pytest.mark.parametrize("model,sizes", STEP_RUNS,
                         ids=[_run_id(*r) for r in STEP_RUNS])
def test_tp_trainer_matches_repro_and_single_process(model, sizes, repro_tp):
    """``Trainer(mesh=)`` on four gloo ranks, tensor parallel over
    ``model`` (4 ranks, or 2 beside 2 dp ranks), from ``repro``'s initial
    parameters, 3 steps of accum 2: every step's loss and gradient norm,
    and the final parameters (written by the checkpoint, gathered by rank
    0), against ``repro``'s ``Trainer(mesh=)`` on the same mesh of fake
    XLA devices and against the single-process trainer, with
    ``tests/test_torch_distributed.py``'s tolerances (``STEP_TOL``'s for
    the later steps of the dense and hybrid models).  On the ranks: the
    split model's local shapes and the kinds of collective the run
    makes."""
    from test_torch_distributed import (PARAM_TOL, TRAIN, TRAIN_RTOL,
                                        TRAIN_SHAPE, _sum_lr)
    jdir, jres = repro_tp
    rid = _run_id(model, sizes)
    arch, knobs = STEP_KNOBS[model]
    pat_path = os.path.join(jdir, f"patterns-{rid}.npz")
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src(f"""
        TRAIN, TRAIN_SHAPE = {TRAIN!r}, {TRAIN_SHAPE!r}
        """, STEP_SETUP, f"""
        from repro_torch.roofline import CommRecorder
        mesh = make_mesh({sizes!r}, ("data", "model"), device="cpu")
        t = trainer({arch!r}, {knobs!r}, mesh, load_pats({pat_path!r}),
                    ckpt_dir=os.path.join(OUT, "ckpt"))
        init = np.load({os.path.join(str(jdir), f"init-{rid}.npz")!r})
        t.model.load_state_dict({{k: torch.from_numpy(init[k])
                                  for k in init.files}})
        assert t.model.tp.size == {sizes[1]} and not t.model.tp_gathered
        split = t.model.tp_local_params()
        assert "embed.table" in split and "layers.0.norm1.scale" not in split
        for k, (dim, full) in split.items():
            shape = list(full)
            shape[dim] //= {sizes[1]}
            assert list(t.model.get_parameter(k).shape) == shape, k
        with CommRecorder() as comm:
            hist = t.run()["history"]
        emit({{"hist": hist, "comm": sorted(set(op for op, _ in
                                                 comm.records))}})
        """), 4, out)
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
        from repro_torch.models import build_model
        from repro_torch.runtime import Trainer, TrainerConfig
        pats = None
        if os.path.exists(pat_path):
            z = np.load(pat_path)
            pats = {p: (z[p + "_0"], z[p + "_1"])
                    for p in ("up", "gate", "down")}
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        one = Trainer(build_model(cfg, device="cpu", ffn_patterns=pats), cfg,
                      ShapeConfig(**TRAIN_SHAPE), TrainerConfig(**TRAIN))
        init = dict(np.load(os.path.join(jdir, f"init-{rid}.npz")))
        one.model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in init.items()})
        alone = one.run()["history"]
        state = CheckpointManager(os.path.join(out, "ckpt")).restore(
            3, one.state_dict())
    final = dict(np.load(os.path.join(jdir, f"final-{rid}.npz")))
    same = [[(h["step"], h["loss"], h["grad_norm"]) for h in r["hist"]]
            for r in got]
    assert all(r == same[0] for r in same)
    # the step's collectives: the split blocks' all-reduces and all-gathers
    # (the gathered KV projections and the RG-LRU's xb gather reduce-scatter
    # their gradients), and on a (2, 2) mesh the FSDP gathers and reduces
    comm = set(got[0]["comm"])
    assert {"all-reduce", "all-gather"} <= comm, comm
    if sizes[0] > 1 or model == "hybrid" or sizes[1] > 2:
        assert "reduce-scatter" in comm, comm
    # step 0 is a function of the initial state alone; later steps also
    # carry AdamW's lr·sign(g) moves of near-zero gradient elements, which
    # two summation orders may take apart (tests/test_torch_distributed.py)
    rtol, ptol = STEP_TOL.get(model, (TRAIN_RTOL, PARAM_TOL))
    for g, w, a in zip(got[0]["hist"], jres[rid], alone):
        assert g["step"] == w["step"] == a["step"]
        for key in ("loss", "grad_norm"):
            tol = TRAIN_RTOL if g["step"] == 0 else rtol
            np.testing.assert_allclose(g[key], w[key], rtol=tol)
            np.testing.assert_allclose(g[key], a[key], rtol=tol)
    atol = 2 * _sum_lr(TRAIN)
    alone_p = dict(one.model.named_parameters())
    moved = []
    for k, w in final.items():
        g = state[f"params/{k}"].numpy()
        for ref in (w, alone_p[k].detach().numpy()):
            d = np.abs(g - ref)
            assert d.max() <= atol, k
            assert np.quantile(d, 0.999) <= ptol, (k, d.max())
        moved.append(np.abs(w - init[k]).ravel())
    assert np.median(np.concatenate(moved)) > 10 * PARAM_TOL


# --- checkpoints, elastic restore, decode, FLOPs ------------------------------


@pytest.fixture(scope="module")
def tp_checkpoint(tmp_path_factory):
    """One step of reduced granite (dense FFN) on a (1, 4) mesh with a
    checkpoint; rank 0 also writes the trainer's full parameters
    (``Trainer.params``, each split one all-gathered) to ``full.npz``."""
    from test_torch_distributed import TRAIN, TRAIN_SHAPE
    out = str(tmp_path_factory.mktemp("tp_ckpt"))
    arch, knobs = STEP_KNOBS["dense"]
    _gloo(_src(f"""
    TRAIN, TRAIN_SHAPE = {TRAIN!r}, dict({TRAIN_SHAPE!r})
    TRAIN["steps"] = 1
    """, STEP_SETUP, f"""
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    t = trainer({arch!r}, {knobs!r}, mesh, None,
                ckpt_dir=os.path.join(OUT, "ckpt"))
    t.run()
    full = {{k: p.detach().numpy() for k, p in t.params.items()}}
    if RANK == 0:
        np.savez(os.path.join(OUT, "full.npz"), **full)
    """), 4, out)
    return out


def test_tp_checkpoint_restores_in_one_process(tp_checkpoint):
    """A checkpoint written under TP (1, 4) holds the full tensors: one
    process restores it, and its parameters and moments equal the split
    trainer's gathered parameters bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    from test_torch_distributed import TRAIN_SHAPE
    arch, knobs = STEP_KNOBS["dense"]
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
    one = Trainer(build_model(cfg, device="cpu"), cfg,
                  ShapeConfig(**TRAIN_SHAPE), TrainerConfig(steps=1))
    ckpt = CheckpointManager(os.path.join(tp_checkpoint, "ckpt"))
    assert ckpt.all_steps() == [1]
    one.load_state_dict(ckpt.restore(1, one.state_dict()))
    full = np.load(os.path.join(tp_checkpoint, "full.npz"))
    assert set(full.files) == set(one.params)
    for k, p in one.params.items():
        assert np.array_equal(p.detach().numpy(), full[k]), k
    assert one.opt_state.step == 1
    assert all(float(v.abs().max()) > 0 for v in one.opt_state.v.values())


def test_tp_elastic_restore_decode_and_flops(tp_checkpoint, repro_tp):
    """On a (1, 2) mesh (two gloo ranks): the (1, 4) checkpoint restored
    onto the smaller ``model`` axis (``restore_onto_mesh``), and ``repro``'s
    hybrid checkpoint (``restore_jax_checkpoint`` and ``JaxCheckpoint``),
    each rank's shards and gathered parameters equal to the arrays bit for
    bit; ``decode_step`` of granite (GQA, one KV head a rank) and of the
    hybrid (its ring cache wrapping past the window) from the seeded
    ``init`` (the split model draws the same values), every step's logits
    and greedy tokens against one process; ``CostCounter``'s FLOPs of one
    rank's dense-FFN training step within 10 % of one process's over 2,
    and its collectives exactly, the remat recompute's among them."""
    from test_torch_distributed import TRAIN, TRAIN_SHAPE
    jdir, _ = repro_tp
    darch, dknobs = STEP_KNOBS["dense"]
    harch, hknobs = STEP_KNOBS["hybrid"]
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src(f"""
        TRAIN, TRAIN_SHAPE = {TRAIN!r}, {TRAIN_SHAPE!r}
        """, STEP_SETUP, DECODE_SRC, f"""
        from repro_torch.checkpoint import (CheckpointManager, JaxCheckpoint,
                                            restore_jax_checkpoint)
        from repro_torch.optim import AdamW, constant
        from repro_torch.roofline import CommRecorder, CostCounter
        from repro_torch.runtime import make_train_step
        from repro_torch.runtime.elastic import restore_onto_mesh
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        res = {{}}
        # the (1, 4) checkpoint onto (1, 2)
        t = trainer({darch!r}, {dknobs!r}, mesh, None)
        with np.load(os.path.join({tp_checkpoint!r}, "ckpt", "step_00000001",
                                  "arrays.npz")) as f:
            arrays = {{k: f[k] for k in f.files}}
        sd = restore_onto_mesh(CheckpointManager(os.path.join(
            {tp_checkpoint!r}, "ckpt")), 1, t.state_dict(), mesh)
        t.load_state_dict(sd)
        n = 0
        for k, d in sd.items():
            w = torch.from_numpy(arrays[k])
            sh = t._step_fn.shardings.get(k.split("/")[-1])
            assert torch.equal(d.to_local(), sh.shard(w) if sh else w), k
            n += 1
        for k, p in t.params.items():
            assert np.array_equal(p.detach().numpy(), arrays["params/" + k]), k
        for k, (dim, _) in t.model.tp_local_params().items():
            w = torch.from_numpy(arrays["params/" + k])
            assert torch.equal(t.model.get_parameter(k).detach(),
                               w.narrow(dim, RANK * w.shape[dim] // 2,
                                        w.shape[dim] // 2)), k
        res["elastic"] = n
        # repro's checkpoint of the hybrid onto (1, 2)
        ht = trainer({harch!r}, {hknobs!r}, mesh, None)
        jpath = os.path.join({str(jdir)!r}, "ckpt-hybrid-1x4")
        step = JaxCheckpoint(jpath, ht.model_cfg, None).latest_step()
        full = restore_jax_checkpoint(jpath, step, ht.model_cfg, None,
                                      device="cpu")
        for load in (full, restore_onto_mesh(JaxCheckpoint(
                jpath, ht.model_cfg, None), step, ht.state_dict(), mesh)):
            ht.load_state_dict(load)
            for k, p in ht.params.items():
                assert torch.equal(p.detach(), torch.as_tensor(
                    np.asarray(full["params/" + k]))), k
        res["jax_step"] = step
        # decode from the seeded init
        for name, (arch, knobs) in (("granite", ({darch!r}, {dknobs!r})),
                                    ("hybrid", ({harch!r}, {hknobs!r}))):
            cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
            model = build_model(cfg, device="cpu", mesh=mesh)
            res[name] = greedy(model)
            res[name + "_cache"] = {{k: list(v.shape) for k, v in
                                    model.init_cache(2, 8).items()}}
        # one rank's FLOPs of a dense-FFN step
        cfg = dataclasses.replace(reduced_config(REGISTRY[{darch!r}]),
                                  **{dknobs!r})
        model = build_model(cfg, device="cpu", mesh=mesh)
        model.init(torch.Generator().manual_seed(0))
        opt = AdamW(lr=constant(1e-3))
        step_fn = make_train_step(model, opt, 2, mesh=mesh)
        state = opt.init(step_fn.master)
        batch = flops_batch(cfg)
        with CostCounter() as cost, CommRecorder() as comm:
            step_fn(state, batch)
        res["flops"] = cost.flops
        res["ops"] = [op for op, _ in comm.records]
        emit(res)
        """), 2, out)
    ns = {}
    exec(DECODE_SRC, ns)
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.roofline import CostCounter
    from repro_torch.runtime import make_train_step
    for r in got:
        assert r["elastic"] > 0 and r["jax_step"] == 3
    for name, (arch, knobs) in (("granite", STEP_KNOBS["dense"]),
                                ("hybrid", STEP_KNOBS["hybrid"])):
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        want = ns["greedy"](build_model(cfg, device="cpu"))
        for r, g in enumerate(got):
            assert g[name]["tokens"] == want["tokens"], (name, r)
            assert _rel(g[name]["logits"], want["logits"]) <= TP_RTOL, \
                (name, r)
        # the cache holds each rank's KV heads (granite: 2 KV heads over 2
        # ranks; the hybrid's one KV head on both) and RG-LRU channels
        cache = got[0][name + "_cache"]
        for key in ("k", "v"):
            assert cache[key][3] == 1, (name, cache)
        if name == "hybrid":
            assert cache["h"][-1] == cfg.d_model // 2
            assert cache["conv"][-1] == cfg.d_model // 2
    cfg = dataclasses.replace(reduced_config(REGISTRY[darch]), **dknobs)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=constant(1e-3))
    step_fn = make_train_step(model, opt, 2)
    state = opt.init(step_fn.master)
    with CostCounter() as cost:
        step_fn(state, ns["flops_batch"](cfg))
    for g in got:
        assert abs(g["flops"] / (cost.flops / 2) - 1) <= 0.10, \
            (g["flops"], cost.flops)
    # the step's collectives, each microbatch (2 layers, remat): the
    # embedding's sum; a layer's 2 forward all-reduces (attention and
    # SwiGLU outputs), the remat recompute's 1 (torch's non-reentrant
    # checkpoint stops at the last tensor the backward needs, so the
    # SwiGLU's all-reduce, whose output nothing saves, does not run
    # again) and 2 backward (their inputs' copy-in); the head's copy-in
    # and the cross entropy's max, sum and target logit; then the clip
    # norm's one.  KV heads split at 2 ranks: no gather, and no dp axis to
    # gather or reduce over.
    layers = cfg.n_layers
    per_micro = 1 + layers * (2 + 1 + 2) + 1 + 3
    assert cfg.remat and layers == 2
    for g in got:
        assert g["ops"] == ["all-reduce"] * (2 * per_micro + 1), g["ops"]


# greedy decode from the seeded init, and the FLOPs test's batch, alike on
# the ranks and in this process
DECODE_SRC = """
import numpy as np
import torch


def greedy(model, prompt_len=20, steps=20):
    model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    cfg = model.cfg
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt_len)))
    cache = model.init_cache(2, prompt_len + steps)
    logits, tokens = [], []
    with torch.no_grad():
        if model.recurrent:
            for i in range(prompt_len):
                out, _ = model.decode_step(cache, prompt[:, i:i + 1], i)
        else:
            out, _ = model.decode_step(cache, prompt, 0)
        for i in range(steps):
            tok = out.argmax(-1)
            logits.append(out.tolist())
            tokens.append(tok.tolist())
            out, _ = model.decode_step(cache, tok[:, None], prompt_len + i)
    return {"logits": logits, "tokens": tokens}


def flops_batch(cfg):
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)))
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}
"""
