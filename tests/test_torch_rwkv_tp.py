"""RWKV-6 split over the ``model`` axis (the time mix by heads, the channel
mix by hidden units, the wkv state by heads) against one process and
against ``repro``, on the CPU.

One module fixture runs ``repro`` (a subprocess on 4 fake XLA devices:
``Trainer(mesh=)`` on (1, 4) and (2, 2), and its jitted ``decode_step``
over a cache placed by ``cache_pspec`` on (1, 4)) beside the port's gloo
ranks (one process a rank, bounded by its own timeout, as
``tests/test_torch_tp.py`` runs them):

* the split ``RWKVBlock`` (time mix, then channel mix over its residual)
  on (1, 2) and (1, 4): outputs, the new state and every gradient
  (parameters, input, input state; each split one gathered) against the
  unsplit block in this process and against ``repro``'s
  ``rwkv_time_mix`` / ``rwkv_channel_mix`` on the same numpy parameters;
* the split ``ln_x`` alone, beside two wrong versions of its statistic's
  gradient (a missing sum, a double sum) that the test must catch;
* ``Trainer(mesh=)`` on reduced RWKV-6 over (1, 4) and (2, 2) against
  ``repro``'s and the single-process trainer; a ``seq_shard`` gradient
  and trainer on (1, 4);
* decode on (1, 4): greedy tokens and logits against one process and
  ``repro``, each rank's S of H / 4 heads.

Both packages start from ``repro``'s ``init`` (key 0), carried over by
``convert.params_from_jax``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import recurrent as jrecurrent  # noqa: E402

from repro_torch.configs import REGISTRY, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding.tensor_parallel import (TP,  # noqa: E402
                                                  TensorParallelError)

from _torch_families import np_tree  # noqa: E402
from test_torch_distributed import (PARAM_TOL, ROOT, TRAIN,  # noqa: E402
                                    TRAIN_RTOL, TRAIN_SHAPE, _gloo, _src,
                                    _sum_lr)

ARCH = "rwkv6-1.6b"
KNOBS = dict(dtype="float32")
# split against unsplit: the same products, summed in another order by the
# all-reduces (measured worst: the block's gradients 6.7e-7)
SPLIT_RTOL = 1e-5
# against repro's jnp functions (as tests/_torch_families.py's RTOL)
REPRO_RTOL = 1e-4
# the trainer's later steps (loss and norm relative) and its final
# parameters (the 99.9 % quantile): tests/test_torch_distributed.py's
# TRAIN_RTOL and PARAM_TOL hold (measured over the three runs: steps 1-2
# within 3.6e-6 of repro's and 4.3e-6 of one process, which is 7.6e-6
# from repro; the parameters within 4.8e-6 of repro's and 6.4e-6 of one
# process's), unlike the hybrid's (test_torch_tp.py's STEP_TOL)
STEP_TOL = (TRAIN_RTOL, PARAM_TOL)
BLOCK_WORLDS = (2, 4)
STEP_MESHES = ((1, 4), (2, 2))
WORLD = 4
MAX_LEN = 24
PROMPT, STEPS = 8, 8

# the block case, alike on the ranks and in this process: reduced RWKV-6's
# widths (D 64, 4 heads of 16, d_ff 128, lora 32); the lora weights and
# w_bias drawn wide enough that the decay's gradient is not negligible
BLOCK_SRC = """
import math
import numpy as np
import torch
from repro_torch.models.recurrent import (RWKVBlock, rwkv_channel_mix,
                                          rwkv_time_mix)

D, H, HD, FF, LORA = 64, 4, 16, 128, 32


def block_case():
    rng = np.random.default_rng(21)

    def w(*shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    state = {"mix": rng.uniform(0, 1, (5, D)).astype(np.float32),
             "wr.w": w(D, D), "wk.w": w(D, D), "wv.w": w(D, D),
             "wg.w": w(D, D), "wo.w": w(D, D),
             "w_lora_a": w(D, LORA, scale=0.3),
             "w_lora_b": w(LORA, D, scale=0.3),
             "w_bias": rng.uniform(-3, 0, D).astype(np.float32),
             "u": w(H, HD, scale=0.3),
             "ln_x.scale": (1 + w(D, scale=0.1)),
             "cm_mix": rng.uniform(0, 1, (2, D)).astype(np.float32),
             "cm_k.w": w(D, FF), "cm_v.w": w(FF, D)}
    inputs = {"x": w(2, 12, D, scale=1.0), "shift": w(2, D, scale=1.0),
              "S": w(2, H, HD, HD, scale=0.3),
              "cm_shift": w(2, D, scale=1.0)}
    cts = {"tm": w(2, 12, D, scale=1.0), "cm": w(2, 12, D, scale=1.0),
           "S": w(2, H, HD, HD, scale=1.0)}
    return state, inputs, cts


def run_block(block, inputs, cts, heads=lambda t: t):
    \"\"\"The time mix, then the channel mix over its residual; ``heads``
    takes this rank's heads of a full (B, H, ...) tensor.  Returns the
    outputs, a scalar to differentiate and the input leaves.\"\"\"
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in inputs.items()}
    s0 = heads(leaves["S"])
    tm, st = rwkv_time_mix(block, leaves["x"],
                           {"shift": leaves["shift"], "S": s0})
    y = leaves["x"] + tm
    cm, cm_shift = rwkv_channel_mix(block, y, leaves["cm_shift"])
    loss = ((tm * torch.from_numpy(cts["tm"])).sum()
            + (cm * torch.from_numpy(cts["cm"])).sum()
            + (st["S"] * heads(torch.from_numpy(cts["S"]))).sum())
    outs = {"tm": tm, "cm": cm, "S": st["S"], "shift": st["shift"],
            "cm_shift": cm_shift}
    return outs, loss, leaves
"""

# the split block, the split ln_x and its two wrong statistics on the ranks
BLOCK_RANKS_SRC = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers
from repro_torch.sharding.tensor_parallel import (copy_in, gather_full,
                                                  local, reduce_out,
                                                  reduce_stat, tp_group)
mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
tp = tp_group(mesh)
assert (tp.rank, tp.size) == (RANK, WORLD)
res = {}
state, inputs, cts = block_case()
block = RWKVBlock(D, H, FF, device="cpu")
block.tensor_parallel_(tp)
split = {f"{m}.{p}" if m else p: spec
         for m, sub in block.named_modules()
         for p, spec in getattr(sub, "tp_local", {}).items()}
with torch.no_grad():
    for k, p in block.named_parameters():
        full = torch.from_numpy(state[k])
        p.copy_(local(full, split[k][0], tp) if k in split else full)
outs, loss, leaves = run_block(block, inputs, cts,
                               heads=lambda t: local(t, 1, tp))
loss.backward()
outs["S"] = gather_full(outs["S"], 1, tp)
grads = {k: v.grad for k, v in leaves.items()}
# the input state's gradient: this rank's heads (the rest is zero here)
grads["S"] = gather_full(local(grads["S"], 1, tp).contiguous(), 1, tp)
for k, p in block.named_parameters():
    grads[k] = gather_full(p.grad, split[k][0], tp) if k in split else p.grad
res["block"] = {
    "outs": {k: v.detach().tolist() for k, v in outs.items()},
    "grads": {k: g.tolist() for k, g in grads.items()},
    "local": {k: [list(p.shape), split[k][0]]
              for k, p in block.named_parameters() if k in split}}

# ln_x alone: this rank's channels of x and of the cotangent
rng = np.random.default_rng(22)
xn = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))
ctn = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))
scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(D))
                         .astype(np.float32))
norm = layers.RMSNorm(D, device="cpu")
with torch.no_grad():
    norm.scale.copy_(scale)


def wrong(x, stat):
    xf = x.float()
    var = stat((xf * xf).sum(dim=-1, keepdim=True)) / D
    return xf * torch.rsqrt(var + 1e-6) * local(scale, 0, tp)


res["ln_x"] = {}
for name, fn in (
        ("split", lambda x: norm(x, tp=tp)),
        ("missing_sum", lambda x: wrong(x, lambda s: reduce_out(s, tp))),
        ("double_sum", lambda x: wrong(
            x, lambda s: reduce_stat(copy_in(s, tp), tp)))):
    x = local(xn, 2, tp).clone().requires_grad_()
    norm.scale.grad = None
    y = fn(x)
    (y * local(ctn, 2, tp)).sum().backward()
    res["ln_x"][name] = {
        "y": gather_full(y.detach(), 2, tp).tolist(),
        "dx": gather_full(x.grad, 2, tp).tolist()}
    if name == "split":
        res["ln_x"][name]["dscale"] = norm.scale.grad.tolist()
"""

# the model runs on the ranks and in this process
MODEL_SRC = """
import dataclasses
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
from repro_torch.models import build_model
from repro_torch.runtime import Trainer, TrainerConfig


def cfg_of(**kw):
    return dataclasses.replace(reduced_config(REGISTRY[ARCH]), **KNOBS, **kw)


def load(path):
    z = np.load(path)
    return {k: torch.from_numpy(z[k]) for k in z.files}


def grad_batch():
    rng = np.random.default_rng(12)
    t = rng.integers(0, 512, (4, 33))
    return {"tokens": torch.from_numpy(t[:, :-1]),
            "targets": torch.from_numpy(t[:, 1:])}


def decode(model):
    \"\"\"A prefill of PROMPT tokens in one call, then STEPS greedy steps:
    every call's logits and tokens, and the cache's shapes.\"\"\"
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, 512, (2, PROMPT)))
    cache = model.init_cache(2, MAX_LEN)
    logits, tokens = [], []
    with torch.no_grad():
        out, _ = model.decode_step(cache, prompt, 0)
        for i in range(STEPS):
            tok = out.argmax(-1)
            logits.append(out.tolist())
            tokens.append(tok.tolist())
            out, _ = model.decode_step(cache, tok[:, None], PROMPT + i)
    return {"logits": logits, "tokens": tokens,
            "cache": {k: list(v.shape) for k, v in cache.items()}}


def trainer(cfg, init, mesh=None):
    t = Trainer(build_model(cfg, device="cpu"), cfg,
                ShapeConfig(**TRAIN_SHAPE), TrainerConfig(**TRAIN),
                mesh=mesh)
    t.model.load_state_dict(init)
    return t
"""

MODEL_RANKS_SRC = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.tensor_parallel import gather_full
init = load(os.path.join(OUT, "init.npz"))
# the split model: its shapes, its decode and a seq_shard gradient
model = build_model(cfg_of(), device="cpu", mesh=mesh)
model.load_state_dict(init)
split = model.tp_local_params()
res["gathered"] = sorted(model.tp_gathered)
res["local"] = {k: [list(model.get_parameter(k).shape), list(full), dim]
                for k, (dim, full) in split.items()}
res["decode"] = decode(model)
res["S_bytes"] = model.init_cache(2, MAX_LEN)["S"].nbytes
batch = grad_batch()
for seq in (False, True):
    model = build_model(cfg_of(seq_shard=seq), device="cpu", mesh=mesh)
    model.load_state_dict(init)
    rows = []
    for blk in model.layers:
        blk.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[1]))
    loss, _ = model.loss_fn(batch)
    loss.backward()
    grads = {k: (gather_full(p.grad, split[k][0], model.tp)
                 if k in split else p.grad)
             for k, p in model.named_parameters()}
    if RANK == 0:
        np.savez(os.path.join(OUT, f"grads-seq{int(seq)}.npz"),
                 **{k: g.numpy() for k, g in grads.items()})
    res[f"seq{int(seq)}"] = {"loss": loss.item(), "rows": rows,
                             "split": model.seq_parallel(32).size}
# heads that do not split (2 over 4): the layers run whole, seq_shard too
model = build_model(cfg_of(n_heads=2, seq_shard=True), device="cpu",
                    mesh=mesh)
model.init(torch.Generator().manual_seed(3))
rows = []
for blk in model.layers:
    blk.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[1]))
loss, _ = model.loss_fn(batch)
loss.backward()
whole = model.tp_local_params()
grads = {k: (gather_full(p.grad, whole[k][0], model.tp) if k in whole
             else p.grad) for k, p in model.named_parameters()}
if RANK == 0:
    np.savez(os.path.join(OUT, "grads-whole.npz"),
             **{k: g.numpy() for k, g in grads.items()})
res["whole"] = {"loss": loss.item(), "rows": rows,
                "gathered": sorted(model.tp_gathered)}
# the trainers: (1, 4), (2, 2), and (1, 4) with seq_shard
for name, sizes, seq in (("1x4", (1, 4), False), ("2x2", (2, 2), False),
                         ("1x4-seq", (1, 4), True)):
    m = mesh if sizes == (1, 4) else make_mesh(sizes, ("data", "model"),
                                               device="cpu")
    t = trainer(cfg_of(seq_shard=seq), init, m)
    assert t.model.tp.size == sizes[1] and not t.model.tp_gathered
    hist = t.run()["history"]
    final = {k: p.detach().numpy() for k, p in t.params.items()}
    if RANK == 0:
        np.savez(os.path.join(OUT, f"final-{name}.npz"), **final)
    res["train-" + name] = hist
emit(res)
"""


def _jax_src(out):
    """``repro`` on 4 fake devices: ``Trainer(mesh=)`` over each of
    ``STEP_MESHES`` (its history, initial and final parameters under the
    port's names), and the decode script through its jitted
    ``decode_step`` over a ``cache_pspec``-placed cache on (1, 4)."""
    return _src(f"""
    import dataclasses, json
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from repro import api
    from repro.configs import REGISTRY as JR, reduced_config as jreduced
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.models import build_model
    from repro.runtime import Trainer, TrainerConfig
    from repro.sharding import rules
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.convert import params_from_jax

    OUT = {out!r}
    jcfg = dataclasses.replace(jreduced(JR[{ARCH!r}]), **{KNOBS!r})
    cfg = dataclasses.replace(reduced_config(REGISTRY[{ARCH!r}]),
                              **{KNOBS!r})
    res = {{}}
    for sizes in {STEP_MESHES!r}:
        rid = f"{{sizes[0]}}x{{sizes[1]}}"
        model = build_model(jcfg)
        mesh = make_mesh(sizes, ("data", "model"))
        t = Trainer(model, jcfg, ShapeConfig(**{TRAIN_SHAPE!r}),
                    TrainerConfig(**{TRAIN!r}), mesh=mesh)
        init = jax.tree.map(np.array, t.state[0])
        with api.use_backend("reference"), mesh_context(mesh):
            res["train-" + rid] = t.run()["history"]
        for name, tree in (("init", init), ("final", t.state[0])):
            np.savez(f"{{OUT}}/repro-{{name}}-{{rid}}.npz", **{{
                k: v.numpy() for k, v in params_from_jax(
                    cfg, jax.tree.map(np.asarray, tree), None).items()}})
        res["spec-" + rid] = str(t.state[0]["layers"]["rwkv"]["wr"][
            "w"].sharding.spec)
    model = build_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = make_mesh((1, 4), ("data", "model"))
    cache = model.init_cache(2, {MAX_LEN})
    placed = jax.tree.map(lambda a: NamedSharding(mesh, rules.sanitize_pspec(
        mesh, rules.cache_pspec(mesh, a), a.shape)), cache)
    cache = jax.device_put(cache, placed)
    step = jax.jit(model.decode_step)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 512, (2, {PROMPT})).astype(np.int32)
    logits = []
    with mesh_context(mesh):
        out, cache = step(params, cache, jnp.asarray(prompt),
                          jnp.asarray(0, jnp.int32))
        for i in range({STEPS}):
            tok = np.asarray(out).argmax(-1).astype(np.int32)
            logits.append(np.asarray(out).tolist())
            out, cache = step(params, cache, jnp.asarray(tok[:, None]),
                              jnp.asarray({PROMPT} + i, jnp.int32))
    res["decode"] = logits
    res["S_spec"] = str(placed["layers"]["rwkv"]["S"].spec)
    print(json.dumps(res))
    """)


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced(JAX_REGISTRY[ARCH]), **KNOBS,
                                **kw),
            dataclasses.replace(reduced_config(REGISTRY[ARCH]), **KNOBS,
                                **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _consts():
    return _src(f"""
    ARCH, KNOBS = {ARCH!r}, {KNOBS!r}
    MAX_LEN, PROMPT, STEPS = {MAX_LEN}, {PROMPT}, {STEPS}
    TRAIN, TRAIN_SHAPE = {TRAIN!r}, {TRAIN_SHAPE!r}
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``repro``'s initial parameters written for the ranks, then
    ``repro`` (a subprocess on 4 fake XLA devices) and the port (the block
    on 2 gloo ranks, then the block and the model on 4) side by side.
    Returns ``(out dir, repro's results, {world: the ranks' results})``."""
    out = str(tmp_path_factory.mktemp("rwkv_tp"))
    jcfg, cfg = _cfgs()
    state = params_from_jax(cfg, np_tree(jax_build(jcfg).init(
        jax.random.PRNGKey(0))), None)
    np.savez(os.path.join(out, "init.npz"),
             **{k: v.numpy() for k, v in state.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    jproc = subprocess.Popen(
        [sys.executable, "-c", "import os\nos.environ['XLA_FLAGS'] = "
         "'--xla_force_host_platform_device_count=4'\n" + _jax_src(out)],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = {}
    try:
        ranks[2] = _gloo(_src(BLOCK_SRC, BLOCK_RANKS_SRC, "emit(res)\n"),
                         2, out, timeout=240)
        ranks[4] = _gloo(_src(_consts(), BLOCK_SRC, BLOCK_RANKS_SRC,
                              MODEL_SRC, MODEL_RANKS_SRC), WORLD, out,
                         timeout=300)
        jout, jerr = jproc.communicate(timeout=300)
        assert jproc.returncode == 0, f"STDOUT:\n{jout}\nSTDERR:\n{jerr}"
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    return out, json.loads(jout.strip().splitlines()[-1]), ranks


def _ns():
    ns = {}
    exec(_src(_consts(), BLOCK_SRC, MODEL_SRC), ns)
    return ns


def _single_block():
    """The block case unsplit in this process: outputs and gradients."""
    ns = _ns()
    state, inputs, cts = ns["block_case"]()
    block = ns["RWKVBlock"](ns["D"], ns["H"], ns["FF"], device="cpu")
    block.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    outs, loss, leaves = ns["run_block"](block, inputs, cts)
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items()}
    grads.update({k: p.grad for k, p in block.named_parameters()})
    np_ = {k: v.detach().numpy() for k, v in outs.items()}
    return np_, {k: g.numpy() for k, g in grads.items()}, state, inputs, cts


def _jax_block(state, inputs, cts, n_heads):
    """``repro``'s time mix and channel mix on the same parameters:
    outputs and gradients under the port's names."""
    def nest(flat):
        tree = {}
        for k, v in flat.items():
            *path, leaf = k.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {f"{prefix}{k}": np.asarray(v)})
        return out

    def f(p, leaves):
        tm, st = jrecurrent.rwkv_time_mix(
            p, leaves["x"], n_heads,
            {"shift": leaves["shift"], "S": leaves["S"]})
        cm, cm_shift = jrecurrent.rwkv_channel_mix(p, leaves["x"] + tm,
                                                   leaves["cm_shift"])
        loss = (jnp.sum(tm * cts["tm"]) + jnp.sum(cm * cts["cm"])
                + jnp.sum(st["S"] * cts["S"]))
        return loss, {"tm": tm, "cm": cm, "S": st["S"],
                      "shift": st["shift"], "cm_shift": cm_shift}

    leaves = {k: jnp.asarray(v) for k, v in inputs.items()}
    (_, outs), (gp, gl) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(nest(state),
                                                           leaves)
    grads = flat(gp)
    grads.update({k: np.asarray(v) for k, v in gl.items()})
    return {k: np.asarray(v) for k, v in outs.items()}, grads


@pytest.mark.parametrize("world", BLOCK_WORLDS)
def test_split_block_matches_single_process_and_repro(world, runs):
    """The block split over ``world`` model ranks (1 or 2 heads and 32 or
    64 hidden units a rank): the time mix's and channel mix's outputs, the
    new state and every gradient (each parameter's, the input's and the
    input state's; split ones gathered) on every rank against the unsplit
    block within ``SPLIT_RTOL`` and ``repro``'s functions within
    ``REPRO_RTOL``.  A gradient summed over ``model`` twice or not at all
    (``mix``, ``cm_mix``, ``w_lora_a``, ``u``, ``w_bias``, ``ln_x.scale``,
    the input and the shift states) is off by far more."""
    _, _, ranks = runs
    outs, grads, state, inputs, cts = _single_block()
    jouts, jgrads = _jax_block(state, inputs, cts, 4)
    assert set(jgrads) == set(grads) and set(jouts) == set(outs)
    for r, got in enumerate(ranks[world]):
        res = got["block"]
        assert set(res["grads"]) == set(grads), r
        for k, want in outs.items():
            assert _rel(res["outs"][k], want) <= SPLIT_RTOL, (r, k)
            assert _rel(res["outs"][k], jouts[k]) <= REPRO_RTOL, (r, k)
        for k, want in grads.items():
            assert _rel(res["grads"][k], want) <= SPLIT_RTOL, (r, k)
            assert _rel(res["grads"][k], jgrads[k]) <= REPRO_RTOL, (r, k)


@pytest.mark.parametrize("world", BLOCK_WORLDS)
def test_split_block_holds_one_share(world, runs):
    """A rank holds 1/tp of ``wr``/``wk``/``wv``/``wg``/``cm_k``'s columns,
    ``wo``/``cm_v``'s rows and ``w_lora_b``'s D columns (``repro``'s rule
    puts them on ``model``); every other parameter stays whole."""
    want = {"wr.w": 1, "wk.w": 1, "wv.w": 1, "wg.w": 1, "cm_k.w": 1,
            "wo.w": 0, "cm_v.w": 0, "w_lora_b": 1}
    _, _, ranks = runs
    state = _ns()["block_case"]()[0]
    for r, got in enumerate(ranks[world]):
        loc = got["block"]["local"]
        assert set(loc) == set(want), r
        for k, dim in want.items():
            shape, d = loc[k]
            full = list(state[k].shape)
            full[dim] //= world
            assert d == dim and shape == full, (k, r)


def test_split_ln_x_sums_its_statistic_once(runs):
    """``RMSNorm(tp=)`` over 4 ranks' channels: the output, the input's
    gradient and the scale's against the unsplit norm within
    ``SPLIT_RTOL``.  The same norm with the sum of squares' gradient not
    summed over the ranks (``reduce_out``) or summed twice
    (``reduce_stat`` of ``copy_in``) has the same output but an input
    gradient off by more than 1 %: the test sees either fault."""
    from repro_torch.models import layers
    _, _, ranks = runs
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(64))
                             .astype(np.float32))
    norm = layers.RMSNorm(64, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(scale)
    x.requires_grad_()
    y = norm(x)
    (y * ct).sum().backward()
    for r, got in enumerate(ranks[WORLD]):
        res = got["ln_x"]
        for name in res:
            assert _rel(res[name]["y"], y.detach().numpy()) <= SPLIT_RTOL
        ok = res["split"]
        assert _rel(ok["dx"], x.grad.numpy()) <= SPLIT_RTOL, r
        assert _rel(ok["dscale"], norm.scale.grad.numpy()) <= SPLIT_RTOL, r
        for name in ("missing_sum", "double_sum"):
            assert _rel(res[name]["dx"], x.grad.numpy()) > 1e-2, (r, name)


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "1x4-seq"])
def test_split_trainer_matches_repro_and_single_process(mesh, runs):
    """``Trainer(mesh=)`` of reduced RWKV-6 (2 layers, fp32) on four gloo
    ranks, split over ``model`` (4 ranks, or 2 beside 2 dp ranks; and
    (1, 4) with ``seq_shard``), from ``repro``'s initial parameters, 3
    steps of accum 2: every step's loss and gradient norm, and the final
    parameters (gathered), against ``repro``'s ``Trainer(mesh=)`` on the
    same mesh of fake XLA devices ((1, 4)'s for ``seq_shard``, which
    changes no arithmetic) and against the single-process trainer: step 0
    within ``TRAIN_RTOL``, later steps and the parameters within
    ``STEP_TOL``; the final parameters moved.  ``repro`` held ``wr`` on ``(data, model)``."""
    out, jres, ranks = runs
    rid = mesh.split("-")[0]
    jinit = dict(np.load(os.path.join(out, f"repro-init-{rid}.npz")))
    init = dict(np.load(os.path.join(out, "init.npz")))
    assert sorted(jinit) == sorted(init)
    for k in init:
        assert np.array_equal(jinit[k], init[k]), k
    assert "'model'" in jres["spec-" + rid]
    ns = _ns()
    one = ns["trainer"](ns["cfg_of"](), {k: torch.from_numpy(v)
                                         for k, v in init.items()})
    alone = one.run()["history"]
    rtol, ptol = STEP_TOL
    hists = [got["train-" + mesh] for got in ranks[WORLD]]
    same = [[(h["step"], h["loss"], h["grad_norm"]) for h in hist]
            for hist in hists]
    assert all(s == same[0] for s in same)
    for g, w, a in zip(hists[0], jres["train-" + rid], alone):
        assert g["step"] == w["step"] == a["step"]
        tol = TRAIN_RTOL if g["step"] == 0 else rtol
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol)
            np.testing.assert_allclose(g[key], a[key], rtol=tol)
    final = dict(np.load(os.path.join(out, f"final-{mesh}.npz")))
    jfinal = dict(np.load(os.path.join(out, f"repro-final-{rid}.npz")))
    alone_p = {k: p.detach().numpy() for k, p in one.params.items()}
    atol = 2 * _sum_lr(TRAIN)
    moved = []
    for k, w in jfinal.items():
        for ref in (w, alone_p[k]):
            d = np.abs(final[k] - ref)
            assert d.max() <= atol, k
            assert np.quantile(d, 0.999) <= ptol, (k, d.max())
        moved.append(np.abs(w - init[k]).ravel())
    assert np.median(np.concatenate(moved)) > 10 * PARAM_TOL


def test_split_model_holds_one_share_and_names_no_rwkv(runs):
    """The (1, 4) model of reduced RWKV-6: ``tp_gathered`` is empty, each
    split parameter holds 1/4 of its full tensor along one dim (the
    block's seven projections, ``w_lora_b``'s columns and the vocabulary
    rows), and a rank's S holds H / 4 heads: its bytes exactly 1/4 of one
    process's."""
    _, _, ranks = runs
    ns = _ns()
    cfg = ns["cfg_of"]()
    whole = build_model(cfg, device="cpu").init_cache(2, MAX_LEN)
    per_layer = {"wr.w", "wk.w", "wv.w", "wg.w", "wo.w", "cm_k.w", "cm_v.w",
                 "w_lora_b"}
    want = {f"layers.{i}.rwkv.{k}" for i in range(cfg.n_layers)
            for k in per_layer} | {"embed.table"}
    for r, got in enumerate(ranks[WORLD]):
        assert got["gathered"] == [], r
        assert set(got["local"]) == want, r
        for k, (shape, full, dim) in got["local"].items():
            want_shape = list(full)
            want_shape[dim] //= WORLD
            assert shape == want_shape, (r, k)
        cache = got["decode"]["cache"]
        assert sorted(cache) == sorted(whole) == ["S", "cm_shift", "shift"]
        s = list(whole["S"].shape)
        s[2] //= WORLD
        assert cache["S"] == s and s[2] == cfg.n_heads // WORLD, r
        assert cache["shift"] == list(whole["shift"].shape), r
        assert 4 * got["S_bytes"] == whole["S"].nbytes, r


def test_split_decode_matches_single_process_and_repro(runs):
    """A prefill of 8 tokens in one call and 8 greedy steps on the (1, 4)
    model: the same greedy tokens as one process and as ``repro``'s
    ``decode_step`` over a cache whose S ``cache_pspec`` splits by heads
    on ``model``, every call's logits within ``SPLIT_RTOL`` of one process
    and ``REPRO_RTOL`` of ``repro``."""
    out, jres, ranks = runs
    ns = _ns()
    model = build_model(ns["cfg_of"](), device="cpu")
    model.load_state_dict(ns["load"](os.path.join(out, "init.npz")))
    want = ns["decode"](model)
    jlog = jres["decode"]
    assert "'model'" in jres["S_spec"].split(",")[2], jres["S_spec"]
    jtok = [np.asarray(lg).argmax(-1).tolist() for lg in jlog]
    assert want["tokens"] == jtok
    for r, got in enumerate(ranks[WORLD]):
        g = got["decode"]
        assert g["tokens"] == want["tokens"], r
        for i, (gl, wl, jl) in enumerate(zip(g["logits"], want["logits"],
                                             jlog)):
            assert _rel(gl, wl) <= SPLIT_RTOL, (r, i)
            assert _rel(gl, jl) <= REPRO_RTOL, (r, i)


def test_seq_shard_gradients_match_unsplit(runs):
    """One batch's loss and every parameter's gradient on the (1, 4)
    model with ``seq_shard`` (each block's input 8 of 32 rows) against the
    same split model without it and against one process, within
    ``SPLIT_RTOL``."""
    out, _, ranks = runs
    ns = _ns()
    model = build_model(ns["cfg_of"](), device="cpu")
    model.load_state_dict(ns["load"](os.path.join(out, "init.npz")))
    loss, _ = model.loss_fn(ns["grad_batch"]())
    loss.backward()
    seq = dict(np.load(os.path.join(out, "grads-seq1.npz")))
    base = dict(np.load(os.path.join(out, "grads-seq0.npz")))
    assert sorted(seq) == sorted(base) == sorted(
        k for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        assert _rel(seq[k], base[k]) <= SPLIT_RTOL, k
        assert _rel(seq[k], p.grad.numpy()) <= SPLIT_RTOL, k
    n = model.cfg.n_layers
    for got in ranks[WORLD]:
        s, b = got["seq1"], got["seq0"]
        for res in (s, b):
            np.testing.assert_allclose(res["loss"], loss.item(),
                                       rtol=SPLIT_RTOL)
        assert s["split"] == WORLD and b["split"] == 1
        assert s["rows"] == [32 // WORLD] * n and b["rows"] == [32] * n


def test_unsplit_layers_under_seq_shard_match_one_process(runs):
    """2 heads over 4 ranks: both RWKV layers run whole on every rank
    (named in ``tp_gathered``) while ``seq_shard`` hands each block 8 of
    32 rows; the loss and every gradient equal one process's within
    ``SPLIT_RTOL``."""
    out, _, ranks = runs
    ns = _ns()
    model = build_model(ns["cfg_of"](n_heads=2), device="cpu")
    model.init(torch.Generator().manual_seed(3))
    loss, _ = model.loss_fn(ns["grad_batch"]())
    loss.backward()
    got = dict(np.load(os.path.join(out, "grads-whole.npz")))
    assert sorted(got) == sorted(k for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        assert _rel(got[k], p.grad.numpy()) <= SPLIT_RTOL, k
    n = model.cfg.n_layers
    for r in ranks[WORLD]:
        w = r["whole"]
        np.testing.assert_allclose(w["loss"], loss.item(), rtol=SPLIT_RTOL)
        assert w["gathered"] == [f"layers.{i}.rwkv" for i in range(n)]
        assert w["rows"] == [32 // WORLD] * n


def test_unsplittable_heads_raise_and_are_named():
    """4 heads over 3 ranks: the block raises ``TensorParallelError``, as
    it does for a d_ff that does not split, and the model names each RWKV
    layer in ``tp_gathered`` with the error's words, computing it whole;
    its cache keeps all H heads."""
    from repro_torch.models.recurrent import RWKVBlock
    with pytest.raises(TensorParallelError, match="3 model ranks"):
        RWKVBlock(64, 4, 128, device="cpu").tensor_parallel_(TP(0, 3))
    with pytest.raises(TensorParallelError, match="90 does not split"):
        RWKVBlock(64, 4, 90, device="cpu").tensor_parallel_(TP(0, 4))
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu").shard_(tp=TP(1, 3))
    for i in range(cfg.n_layers):
        why = model.tp_gathered[f"layers.{i}.rwkv"]
        assert "4 does not split over 3 model ranks" in why
        assert model.layers[i].rwkv.wr.w.shape == (64, 64)
    assert model.init_cache(2, 8)["S"].shape[2] == cfg.n_heads
