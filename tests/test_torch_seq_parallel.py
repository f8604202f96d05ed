"""Sequence parallelism on the ``model`` axis against one process and
against ``repro``, on the CPU.

Two halves, each on two gloo ranks over a (1, 2) mesh (one process a
rank, bounded by its own timeout, as ``tests/test_torch_tp.py`` runs
them), with ``repro`` on two fake XLA devices in a subprocess that runs
beside the ranks:

* decode over a KV cache split on time, for an attention whose heads do
  not split over the ranks (3 heads, and 3 query heads on 1 KV head): a
  chunk inside the first shard, a chunk across the shard edge (the chunked
  path, or two int8 chunks), single steps, then per-row positions, one row
  across the edge.  Every call's logits against the unsplit model in this
  process and against ``repro``'s jitted ``decode_step`` over a cache
  placed by ``cache_pspec`` (its T axis sharded on ``model``); each rank's
  cache shapes;
* ``cfg.seq_shard`` in training: the gradient of one batch (every
  parameter, loss) and three ``Trainer(mesh=)`` steps with the residual
  stream split on T, against the same on the mesh without it and against
  ``repro``'s gradient and ``Trainer(mesh=)`` with ``seq_shard=True``, for
  a dense, a sparse-FFN and the hybrid (RG-LRU) model; the residual
  between blocks holds T / tp rows.

Both packages start from ``repro``'s ``init`` (key 0), carried over by
``convert.params_from_jax``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

from repro_torch.configs import REGISTRY, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

from _torch_families import np_tree, patterns_of  # noqa: E402
from test_torch_distributed import (ROOT, TRAIN, TRAIN_RTOL,  # noqa: E402
                                    TRAIN_SHAPE, _gloo, _src)
from test_torch_tp import STEP_TOL  # noqa: E402

# split against unsplit: the same products, summed in another order by
# the all-reduces (measured worst: decode logits 9.0e-7, gradients 5.0e-7,
# Trainer losses and norms 7.6e-8)
SPLIT_RTOL = 1e-5
# against repro's jitted functions (as tests/_torch_families.py's RTOL;
# measured worst: decode 1.4e-6, gradients 2.5e-6, the hybrid's step-1
# norm 2.5e-5 under test_torch_tp.py's later-step tolerance)
REPRO_RTOL = 1e-4
WORLD = 2
MAX_LEN = 24                     # 12 positions a rank

DECODE_CASES = {
    "gathered": ("qwen1.5-4b", dict(dtype="float32", n_heads=3, n_kv=3,
                                    head_dim=16)),
    "gathered_int8": ("qwen1.5-4b", dict(dtype="float32", n_heads=3,
                                         n_kv=3, head_dim=16,
                                         kv_cache_dtype="int8")),
    "gqa": ("granite-3-8b", dict(dtype="float32", n_heads=3, n_kv=1,
                                 head_dim=16)),
}
STEP_CASES = {
    "dense": ("granite-3-8b", dict(dtype="float32", remat=True)),
    "sparse": ("granite-3-8b", dict(dtype="float32", ffn_block_sparse=True,
                                    ffn_block=32)),
    "hybrid": ("recurrentgemma-9b", dict(dtype="float32")),
}

# the decode calls, alike in every process: (tokens (2, t), position)
SCRIPT_SRC = """
import numpy as np


def decode_script(int8):
    rng = np.random.default_rng(5)

    def tok(t):
        return rng.integers(0, 512, (2, t)).astype(np.int32)
    if int8:       # the int8 path takes at most 8 queries: 7..13 crosses 12
        steps = [(tok(7), 0), (tok(7), 7)]
    else:          # t = 9 takes the chunked path over 5..13
        steps = [(tok(5), 0), (tok(9), 5)]
    for p in range(14, 18):
        steps.append((tok(1), p))
    # per-row positions: row 1 writes 11 and 12, across the edge
    steps.append((tok(2), np.array([18, 11], np.int32)))
    steps.append((tok(1), np.array([20, 13], np.int32)))
    return steps


def grad_batch():
    rng = np.random.default_rng(12)
    t = rng.integers(0, 512, (4, 33)).astype(np.int32)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}
"""

PORT_SRC = """
import dataclasses
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.sharding.tensor_parallel import gather_full


def load(path):
    z = np.load(path)
    return {k: torch.from_numpy(z[k]) for k in z.files}


def load_pats(path):
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return {p: (z[p + "_0"], z[p + "_1"]) for p in ("up", "gate", "down")}


def port_decode(model):
    out = []
    cache = model.init_cache(2, MAX_LEN)
    with torch.no_grad():
        for tok, pos in decode_script(model.cfg.kv_cache_dtype == "int8"):
            p = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
            logits, _ = model.decode_step(cache, torch.from_numpy(tok).long(),
                                          p)
            out.append(logits.tolist())
    return out, {k: list(v.shape) for k, v in cache.items()}
"""


def _cfgs(arch, knobs):
    return (dataclasses.replace(jax_reduced(JAX_REGISTRY[arch]), **knobs),
            dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_src(out, decode, steps):
    """``repro`` on 2 fake devices: each of the ``decode`` cases through
    its jitted ``decode_step`` over a ``cache_pspec``-placed cache; each of
    the ``steps`` cases' gradient of ``grad_batch`` and ``Trainer(mesh=)``
    history with ``seq_shard=True`` (reference backend)."""
    decode = {k: DECODE_CASES[k] for k in decode}
    steps = {k: STEP_CASES[k] for k in steps}
    return _src(SCRIPT_SRC, f"""
    import dataclasses, json
    import jax, jax.numpy as jnp
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

    OUT, MAX_LEN = {out!r}, {MAX_LEN}
    mesh = make_mesh((1, 2), ("data", "model"))
    res = {{"decode": {{}}, "train": {{}}}}
    for name, (arch, knobs) in {decode!r}.items():
        jcfg = dataclasses.replace(jreduced(JR[arch]), **knobs)
        model = build_model(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        cache = model.init_cache(2, MAX_LEN)
        placed = jax.tree.map(lambda a: NamedSharding(mesh, rules.sanitize_pspec(
            mesh, rules.cache_pspec(mesh, a), a.shape)), cache)
        cache = jax.device_put(cache, placed)
        step = jax.jit(model.decode_step)
        logits = []
        with mesh_context(mesh):
            for tok, pos in decode_script(jcfg.kv_cache_dtype == "int8"):
                lg, cache = step(params, cache, jnp.asarray(tok),
                                 jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg).tolist())
        res["decode"][name] = {{"logits": logits, "k_spec": str(
            placed["layers"]["kv"]["k"].spec)}}
    for name, (arch, knobs) in {steps!r}.items():
        jcfg = dataclasses.replace(jreduced(JR[arch]), seq_shard=True,
                                   **knobs)
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        model = build_model(jcfg)
        t = Trainer(model, jcfg, ShapeConfig(**{TRAIN_SHAPE!r}),
                    TrainerConfig(**{TRAIN!r}), mesh=mesh)
        batch = {{k: jnp.asarray(v) for k, v in grad_batch().items()}}
        pats = None
        if model.sparse_mlp is not None:
            pats = {{p: (np.asarray(getattr(model.sparse_mlp, p).plan.a_brow),
                         np.asarray(getattr(model.sparse_mlp, p).plan.a_bcol))
                    for p in ("up", "gate", "down")}}
        with api.use_backend("reference"), mesh_context(mesh):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                model.loss_fn, has_aux=True))(t.state[0], batch)
            hist = t.run()["history"]
        for tag, tree in (("grads", grads), ("final", t.state[0])):
            np.savez(f"{{OUT}}/repro-{{tag}}-{{name}}.npz", **{{
                k: v.numpy() for k, v in params_from_jax(
                    cfg, jax.tree.map(np.asarray, tree), pats).items()}})
        res["train"][name] = {{"loss": float(loss), "hist": hist}}
    print(json.dumps(res))
    """)


def _port_src():
    """The port on the ranks: each decode case split, and each step
    case's gradient and ``Trainer`` run with and without ``seq_shard``."""
    return _src(f"""
    MAX_LEN = {MAX_LEN}
    TRAIN, TRAIN_SHAPE = {TRAIN!r}, {TRAIN_SHAPE!r}
    """, SCRIPT_SRC, PORT_SRC, f"""
    mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
    res = {{"decode": {{}}, "train": {{}}}}
    for name, (arch, knobs) in {DECODE_CASES!r}.items():
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        model = build_model(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(load(os.path.join(OUT, f"init-{{name}}.npz")))
        logits, shapes = port_decode(model)
        res["decode"][name] = {{
            "logits": logits, "cache": shapes,
            "gathered": sorted(model.tp_gathered),
            "odd": {{k: list(v.shape)
                     for k, v in model.init_cache(2, MAX_LEN + 1).items()}}}}
    for name, (arch, knobs) in {STEP_CASES!r}.items():
        init = load(os.path.join(OUT, f"init-{{name}}.npz"))
        pats = load_pats(os.path.join(OUT, f"patterns-{{name}}.npz"))
        batch = {{k: torch.from_numpy(v).long()
                  for k, v in grad_batch().items()}}
        got = {{}}
        for seq in (True, False):
            cfg = dataclasses.replace(reduced_config(REGISTRY[arch]),
                                      seq_shard=seq, **knobs)
            model = build_model(cfg, device="cpu", mesh=mesh,
                                ffn_patterns=pats)
            model.load_state_dict(init)
            rows = []
            for blk in model.layers:
                blk.register_forward_pre_hook(
                    lambda m, a: rows.append(a[0].shape[1]))
            loss, _ = model.loss_fn(batch)
            loss.backward()
            split = model.tp_local_params()
            grads = {{k: (gather_full(p.grad, split[k][0], model.tp)
                          if k in split else p.grad)
                      for k, p in model.named_parameters()}}
            if RANK == 0:
                np.savez(os.path.join(OUT, f"grads-{{name}}-{{seq}}.npz"),
                         **{{k: g.numpy() for k, g in grads.items()}})
            t = Trainer(build_model(cfg, device="cpu", ffn_patterns=pats),
                        cfg, ShapeConfig(**TRAIN_SHAPE),
                        TrainerConfig(**TRAIN), mesh=mesh)
            t.model.load_state_dict(init)
            hist = t.run()["history"]
            final = {{k: p.detach().numpy() for k, p in t.params.items()}}
            if RANK == 0:
                np.savez(os.path.join(OUT, f"final-{{name}}-{{seq}}.npz"),
                         **final)
            got[str(seq)] = {{"loss": float(loss), "rows": rows,
                              "hist": hist,
                              "seq": model.seq_parallel(32).size}}
        res["train"][name] = got
    emit(res)
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``repro``'s initial parameters written for the ranks, then
    ``repro`` (a subprocess on 2 fake XLA devices) and the port (2 gloo
    ranks) run side by side.  Returns ``(out dir, repro's results, the
    ranks' results)``."""
    out = str(tmp_path_factory.mktemp("seq"))
    for name, (arch, knobs) in {**DECODE_CASES, **STEP_CASES}.items():
        jcfg, cfg = _cfgs(arch, knobs)
        jmodel = jax_build(jcfg)
        pats = patterns_of(jmodel)
        state = params_from_jax(cfg, np_tree(jmodel.init(
            jax.random.PRNGKey(0))), pats)
        np.savez(os.path.join(out, f"init-{name}.npz"),
                 **{k: v.numpy() for k, v in state.items()})
        if pats is not None:
            np.savez(os.path.join(out, f"patterns-{name}.npz"), **{
                f"{p}_{i}": a for p, v in pats.items()
                for i, a in enumerate(v)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    # two halves of repro's work side by side (its trainer compiles take
    # most of the time)
    jprocs = [subprocess.Popen(
        [sys.executable, "-c", "import os\nos.environ['XLA_FLAGS'] = "
         "'--xla_force_host_platform_device_count=2'\n"
         + _jax_src(out, *part)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ((DECODE_CASES, ("dense",)),
                     ((), ("sparse", "hybrid")))]
    jres = {"decode": {}, "train": {}}
    try:
        ranks = _gloo(_port_src(), WORLD, out, timeout=240)
        for p in jprocs:
            jout, jerr = p.communicate(timeout=240)
            assert p.returncode == 0, f"STDOUT:\n{jout}\nSTDERR:\n{jerr}"
            for k, v in json.loads(jout.strip().splitlines()[-1]).items():
                jres[k].update(v)
    finally:
        for p in jprocs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out, jres, ranks


def _single_decode(name, out):
    """The decode case unsplit in this process."""
    arch, knobs = DECODE_CASES[name]
    ns = {"MAX_LEN": MAX_LEN, "np": np, "torch": torch, "os": os}
    exec(SCRIPT_SRC + PORT_SRC, ns)
    _, cfg = _cfgs(arch, knobs)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ns["load"](os.path.join(out, f"init-{name}.npz")))
    return ns["port_decode"](model)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_split_cache_decode_matches_one_process_and_repro(name, runs):
    """Every call's logits on both ranks against the unsplit model (within
    ``SPLIT_RTOL``) and ``repro``'s sharded ``decode_step`` (within
    ``REPRO_RTOL``): t = 5 inside rank 0's shard, t = 9 over the edge at
    12 (chunked; int8: two chunks of 7), four single steps, per-row
    positions with one row across the edge.  ``repro`` held the cache's
    time axis on ``model``."""
    out, jres, ranks = runs
    want, _ = _single_decode(name, out)
    jlog = jres["decode"][name]["logits"]
    assert "'model'" in jres["decode"][name]["k_spec"].split(",")[2]
    for r, got in enumerate(ranks):
        g = got["decode"][name]
        assert len(g["logits"]) == len(want) == len(jlog)
        for i, (gl, wl, jl) in enumerate(zip(g["logits"], want, jlog)):
            assert _rel(gl, wl) <= SPLIT_RTOL, (r, i)
            assert _rel(gl, jl) <= REPRO_RTOL, (r, i)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_split_cache_holds_one_share_of_the_timeline(name, runs):
    """Each rank's KV cache (and an int8 cache's scales) holds
    ``MAX_LEN / tp`` positions of every head, its bytes exactly 1/tp of
    the unsplit cache's; a length tp does not divide stays whole.  The
    attention is the one the model names gathered."""
    out, _, ranks = runs
    _, whole = _single_decode(name, out)
    for r, got in enumerate(ranks):
        g = got["decode"][name]
        assert g["gathered"] == ["layers.0.attn", "layers.1.attn"], r
        assert sorted(g["cache"]) == sorted(whole)
        for k, shape in whole.items():
            want = list(shape)
            want[2] //= WORLD
            assert g["cache"][k] == want, (r, k)
            assert g["odd"][k][2] == MAX_LEN + 1, (r, k)
    assert sorted(whole) == (["k", "k_s", "v", "v_s"] if "int8" in name
                             else ["k", "v"])


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_seq_shard_gradients_match_unsplit_and_repro(name, runs):
    """One batch's loss and every parameter's gradient with the residual
    stream split on T, against the same model on the mesh without
    ``seq_shard`` (``SPLIT_RTOL``) and ``repro``'s gradient under its
    mesh with ``seq_shard=True`` (``REPRO_RTOL``); each block's input
    held T / tp rows (T without ``seq_shard``)."""
    out, jres, ranks = runs
    seq = dict(np.load(os.path.join(out, f"grads-{name}-True.npz")))
    base = dict(np.load(os.path.join(out, f"grads-{name}-False.npz")))
    jgrads = dict(np.load(os.path.join(out, f"repro-grads-{name}.npz")))
    assert sorted(seq) == sorted(base) == sorted(jgrads)
    for k in seq:
        assert _rel(seq[k], base[k]) <= SPLIT_RTOL, k
        assert _rel(seq[k], jgrads[k]) <= REPRO_RTOL, k
    jloss = jres["train"][name]["loss"]
    n_layers = _cfgs(*STEP_CASES[name])[1].n_layers
    for got in ranks:
        s, b = got["train"][name]["True"], got["train"][name]["False"]
        np.testing.assert_allclose(s["loss"], b["loss"], rtol=SPLIT_RTOL)
        np.testing.assert_allclose(s["loss"], jloss, rtol=REPRO_RTOL)
        # the residual between blocks: T / tp rows, T without seq_shard
        assert s["seq"] == WORLD and b["seq"] == 1
        assert len(s["rows"]) >= n_layers and len(b["rows"]) >= n_layers
        assert s["rows"] == [32 // WORLD] * len(s["rows"])
        assert b["rows"] == [32] * len(b["rows"])


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_seq_shard_trainer_matches_unsplit_and_repro(name, runs):
    """Three ``Trainer(mesh=)`` steps (accum 2) with ``seq_shard``: every
    step's loss and gradient norm against the trainer on the mesh without
    it and ``repro``'s ``Trainer(mesh=)`` with ``seq_shard=True``, step 0
    within ``TRAIN_RTOL`` of both, later steps within
    ``tests/test_torch_tp.py``'s step tolerances; the final parameters
    (gathered) likewise, the same on both ranks."""
    from test_torch_distributed import PARAM_TOL, _sum_lr
    out, jres, ranks = runs
    jhist = jres["train"][name]["hist"]
    rtol, ptol = STEP_TOL.get(name, (TRAIN_RTOL, PARAM_TOL))
    for got in ranks:
        s, b = got["train"][name]["True"], got["train"][name]["False"]
        assert [(h["loss"], h["grad_norm"]) for h in s["hist"]] == [
            (h["loss"], h["grad_norm"])
            for h in ranks[0]["train"][name]["True"]["hist"]]
        for hs, hb, hj in zip(s["hist"], b["hist"], jhist):
            assert hs["step"] == hb["step"] == hj["step"]
            tol = TRAIN_RTOL if hs["step"] == 0 else rtol
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(hs[key], hb[key], rtol=tol)
                np.testing.assert_allclose(hs[key], hj[key], rtol=tol)
    seq = dict(np.load(os.path.join(out, f"final-{name}-True.npz")))
    base = dict(np.load(os.path.join(out, f"final-{name}-False.npz")))
    jfinal = dict(np.load(os.path.join(out, f"repro-final-{name}.npz")))
    atol = 2 * _sum_lr(TRAIN)
    for k, w in jfinal.items():
        for ref in (w, base[k]):
            d = np.abs(seq[k] - ref)
            assert d.max() <= atol, k
            assert np.quantile(d, 0.999) <= ptol, (k, d.max())


def test_seq_collectives_and_one_rank():
    """The new collectives at one rank (no mesh) are the identity; a
    model at one rank or without ``seq_shard`` never splits T."""
    from repro_torch.sharding.tensor_parallel import (NO_TP, reduce_scatter,
                                                      seq_enter, seq_exit,
                                                      split)
    x = torch.randn(2, 6, 4)
    for f in (lambda t: reduce_scatter(t, 1, NO_TP),
              lambda t: split(t, 1, NO_TP),
              lambda t: seq_enter(t, NO_TP, NO_TP),
              lambda t: seq_exit(t, NO_TP, NO_TP)):
        assert f(x) is x
    _, cfg = _cfgs("granite-3-8b", dict(seq_shard=True))
    model = build_model(cfg, device="cpu")
    assert not model.seq_parallel(32).on
    assert not model.kv_split_on_time(32)
