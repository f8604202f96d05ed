"""Decode over KV caches split on time over the ranks that share their KV
heads (the model's KV group, ``Transformer.kv_tp``), full-attention caches
and rings alike, against one process and against ``repro``, on the CPU.

Four gloo ranks over a (1, 4) mesh (one process a rank, bounded by its own
timeout, as ``tests/test_torch_tp.py`` runs them), with ``repro`` on four
fake XLA devices in two subprocesses that run beside the ranks, its cache
placed by ``sanitize_pspec(mesh, cache_pspec(mesh, leaf), leaf.shape)``
(axis 2 of every 5-d leaf on ``model``):

* reduced granite, 4 query heads on 2 KV heads: each rank runs one query
  head, so ranks {0, 1} and {2, 3} share a KV head and split its 32
  positions 16 a rank (groups of 2), with an fp32 and an int8 cache;
* reduced RecurrentGemma, 4 query heads on 1 KV head, ``local_window`` 32:
  the ring's 32 slots split 8 a rank over all four ranks (a group of 4);
* the mixed ``("attn", "local")`` pattern on 2 KV heads: the full cache
  and the ring both split over groups of 2.

Each case decodes a chunk across a shard edge (the chunked path, or an
int8 chunk; a chunk that wraps the ring and lands on every rank), single
steps, then per-row positions with one row across a shard edge.  Every
call's logits against the unsplit model in this process and against
``repro``'s jitted ``decode_step``; each rank's cache shapes and bytes.

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

from _torch_families import np_tree  # noqa: E402
from test_torch_distributed import ROOT, _gloo, _src  # noqa: E402

# split against unsplit: the same products, summed in another order by
# the group's all-reduces (measured worst over every call and rank:
# 1.47e-6)
SPLIT_RTOL = 1e-5
# against repro's jitted decode_step on its sharded mesh (measured worst:
# 1.46e-6)
REPRO_RTOL = 1e-4
WORLD = 4
WINDOW = 32                      # the reduced configs' local_window

# name → (arch, knobs, the cache's length, the KV group's size)
CASES = {
    "granite": ("granite-3-8b", dict(dtype="float32"), 32, 2),
    "granite_int8": ("granite-3-8b", dict(dtype="float32",
                                          kv_cache_dtype="int8"), 32, 2),
    "ring": ("recurrentgemma-9b", dict(dtype="float32"), 64, 4),
    "mixed": ("recurrentgemma-9b", dict(dtype="float32", n_kv=2, n_layers=4,
                                        layer_pattern=("attn", "local")),
              64, 2),
}

# the decode calls, alike in every process: (tokens (2, t), position)
SCRIPT_SRC = """
import numpy as np


def decode_script(kind):
    rng = np.random.default_rng(7)

    def tok(t):
        return rng.integers(0, 512, (2, t)).astype(np.int32)
    if kind == "int8":     # at most 8 queries: 14..20 crosses 16
        steps = [(tok(7), 0), (tok(7), 7), (tok(7), 14)]
    elif kind == "full":   # t = 13 takes the chunked path over 5..17
        steps = [(tok(5), 0), (tok(13), 5)]
    else:                  # rings of 32: 5..13 crosses slot 8, 14..43 wraps
        steps = [(tok(5), 0), (tok(9), 5), (tok(30), 14)]
    pos = steps[-1][1] + steps[-1][0].shape[1]
    for p in range(pos, pos + 4):
        steps.append((tok(1), p))
    pos += 4
    # per-row positions: row 0 goes on, row 1 writes across an edge of its
    # group's shares (positions or ring slots 15 and 16; ring slots 7 and 8
    # where four ranks split the ring)
    edge = 7 if kind == "ring" else 15
    steps.append((tok(2), np.array([pos, edge], np.int32)))
    steps.append((tok(1), np.array([pos + 2, edge + 2], np.int32)))
    return steps


def script_kind(cfg):
    if cfg.kv_cache_dtype == "int8":
        return "int8"
    if "local" in cfg.layer_pattern:
        return "mixed" if "attn" in cfg.layer_pattern else "ring"
    return "full"
"""

PORT_SRC = """
import dataclasses
import os

import numpy as np
import torch
from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.models import build_model


def load(path):
    z = np.load(path)
    return {k: torch.from_numpy(z[k]) for k in z.files}


def port_decode(model, max_len):
    out = []
    cache = model.init_cache(2, max_len)
    with torch.no_grad():
        for tok, pos in decode_script(script_kind(model.cfg)):
            p = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
            logits, _ = model.decode_step(cache, torch.from_numpy(tok).long(),
                                          p)
            out.append(logits.tolist())
    return out, {k: [list(v.shape), v.numel() * v.element_size()]
                 for k, v in cache.items()}
"""


def _cfgs(arch, knobs):
    return (dataclasses.replace(jax_reduced(JAX_REGISTRY[arch]), **knobs),
            dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_src(names):
    """``repro`` on 4 fake devices: each case's jitted ``decode_step`` over
    a ``cache_pspec``-placed cache on (1, 4); its logits and the specs of
    the cache's 5-d leaves."""
    cases = {k: CASES[k][:3] for k in names}
    return _src(SCRIPT_SRC, f"""
    import dataclasses, json
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import REGISTRY as JR, reduced_config as jreduced
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.models import build_model
    from repro.sharding import rules

    mesh = make_mesh((1, {WORLD}), ("data", "model"))
    res = {{}}
    for name, (arch, knobs, max_len) in {cases!r}.items():
        jcfg = dataclasses.replace(jreduced(JR[arch]), **knobs)
        model = build_model(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        cache = model.init_cache(2, max_len)
        placed = jax.tree.map(lambda a: NamedSharding(mesh, rules.sanitize_pspec(
            mesh, rules.cache_pspec(mesh, a), a.shape)), cache)
        cache = jax.device_put(cache, placed)
        step = jax.jit(model.decode_step)
        logits = []
        with mesh_context(mesh):
            for tok, pos in decode_script(script_kind(jcfg)):
                lg, cache = step(params, cache, jnp.asarray(tok),
                                 jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg).tolist())
        specs = [str(s.spec) for s, a in zip(jax.tree.leaves(placed),
                                             jax.tree.leaves(cache))
                 if a.ndim == 5]
        res[name] = {{"logits": logits, "specs": specs}}
    print(json.dumps(res))
    """)


def _port_src():
    """The port on the ranks: each case split over the (1, 4) mesh."""
    return _src(SCRIPT_SRC, PORT_SRC, f"""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
    res = {{}}
    for name, (arch, knobs, max_len, _) in {CASES!r}.items():
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        model = build_model(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(load(os.path.join(OUT, f"init-{{name}}.npz")))
        logits, cache = port_decode(model, max_len)
        kv = model.kv_tp
        res[name] = {{
            "logits": logits, "cache": cache, "kv": [kv.rank, kv.size],
            "split": model.kv_split_on_time(max_len),
            "odd": {{k: list(v.shape) for k, v in
                     model.init_cache(2, max_len + 1).items()}}}}
    emit(res)
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``repro``'s initial parameters written for the ranks, then
    ``repro`` (two subprocesses on 4 fake XLA devices, full caches and
    rings) and the port (4 gloo ranks) side by side.  Returns ``(out dir,
    repro's results, the ranks' results)``."""
    out = str(tmp_path_factory.mktemp("kv_group"))
    for name, (arch, knobs, _, _) in CASES.items():
        jcfg, cfg = _cfgs(arch, knobs)
        state = params_from_jax(cfg, np_tree(jax_build(jcfg).init(
            jax.random.PRNGKey(0))), None)
        np.savez(os.path.join(out, f"init-{name}.npz"),
                 **{k: v.numpy() for k, v in state.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    jprocs = [subprocess.Popen(
        [sys.executable, "-c", "import os\nos.environ['XLA_FLAGS'] = "
         f"'--xla_force_host_platform_device_count={WORLD}'\n"
         + _jax_src(part)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in (("granite", "granite_int8"), ("ring", "mixed"))]
    jres = {}
    try:
        ranks = _gloo(_port_src(), WORLD, out, timeout=240)
        for p in jprocs:
            jout, jerr = p.communicate(timeout=240)
            assert p.returncode == 0, f"STDOUT:\n{jout}\nSTDERR:\n{jerr}"
            jres.update(json.loads(jout.strip().splitlines()[-1]))
    finally:
        for p in jprocs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out, jres, ranks


def _single_decode(name, out):
    """The case unsplit in this process."""
    arch, knobs, max_len, _ = CASES[name]
    ns = {}
    exec(SCRIPT_SRC + PORT_SRC, ns)
    _, cfg = _cfgs(arch, knobs)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ns["load"](os.path.join(out, f"init-{name}.npz")))
    return ns["port_decode"](model, max_len)


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_split_decode_matches_one_process_and_repro(name, runs):
    """Every call's logits on every rank against the unsplit model (within
    ``SPLIT_RTOL``) and ``repro``'s sharded ``decode_step`` (within
    ``REPRO_RTOL``): a chunk across a shard edge, a ring chunk that wraps,
    single steps, per-row positions with one row across an edge.
    ``repro`` held axis 2 of every 5-d cache leaf on ``model``."""
    out, jres, ranks = runs
    want, _ = _single_decode(name, out)
    jlog = jres[name]["logits"]
    assert jres[name]["specs"] and all(
        "'model'" in s.split(",")[2] for s in jres[name]["specs"])
    for r, got in enumerate(ranks):
        g = got[name]
        assert len(g["logits"]) == len(want) == len(jlog)
        for i, (gl, wl, jl) in enumerate(zip(g["logits"], want, jlog)):
            assert _rel(gl, wl) <= SPLIT_RTOL, (r, i)
            assert _rel(gl, jl) <= REPRO_RTOL, (r, i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_split_cache_holds_repro_share(name, runs):
    """Each rank is rank ``r mod g`` of its KV group of g; each KV entry
    (values, int8 scales, rings) holds 1/g of the timeline (ring slots) of
    the KV heads its query heads read, so its bytes are exactly 1/4 of the
    unsplit cache's, ``repro``'s ``cache_pspec`` share on (1, 4).  A
    full-attention cache of a length the group does not divide stays whole;
    a ring of that length keeps its window's slots, split."""
    out, _, ranks = runs
    _, whole = _single_decode(name, out)
    _, _, max_len, g = CASES[name]
    kv_keys = [k for k in whole if k.split("_")[0] in ("k", "v")]
    assert len(kv_keys) == {"granite_int8": 4, "mixed": 4}.get(name, 2)
    for r, got in enumerate(ranks):
        c = got[name]
        assert c["kv"] == [r % g, g] and c["split"], r
        assert sorted(c["cache"]) == sorted(whole)
        for k in kv_keys:
            (shape, nbytes), (wshape, wbytes) = c["cache"][k], whole[k]
            assert shape[2] * g == wshape[2], (r, k)
            assert nbytes * WORLD == wbytes, (r, k)
            ring = name == "ring" or k.endswith("_local")
            assert c["odd"][k][2] == (WINDOW // g if ring else max_len + 1), \
                (r, k)


def test_kv_group_sizes_and_one_rank():
    """``tp_subgroup`` and the KV group's size without a process group: a
    whole attention's group is all of ``model``, one of a KV head shared by
    ``rep / mine`` ranks is that many, one rank that owns its KV heads has
    none; at one rank nothing splits."""
    from repro_torch.sharding.tensor_parallel import (NO_TP, TP,
                                                      TensorParallelError,
                                                      tp_subgroup)
    tp = TP(5, 8)
    assert tp_subgroup(tp, 8) is tp and tp_subgroup(tp, 1) is NO_TP
    assert tp_subgroup(tp, 2) == TP(1, 2) and tp_subgroup(tp, 4) == TP(1, 4)
    with pytest.raises(TensorParallelError):
        tp_subgroup(tp, 3)
    sizes = {}
    for name, (arch, knobs) in {
            "granite 4/2 on 4": ("granite-3-8b", {}),
            "granite 4/4 on 4": ("granite-3-8b", dict(n_kv=4)),
            "qwen 3 heads on 4": ("qwen1.5-4b", dict(n_heads=3, n_kv=3)),
            "hybrid 4/1 on 4": ("recurrentgemma-9b", {})}.items():
        _, cfg = _cfgs(arch, knobs)
        model = build_model(cfg, device="meta").shard_(tp=TP(1, 4))
        sizes[name] = (model.kv_tp.rank, model.kv_tp.size)
    assert sizes == {"granite 4/2 on 4": (1, 2), "granite 4/4 on 4": (0, 1),
                     "qwen 3 heads on 4": (1, 4), "hybrid 4/1 on 4": (1, 4)}
    _, cfg = _cfgs("recurrentgemma-9b", {})
    model = build_model(cfg, device="cpu")
    assert model.kv_tp is NO_TP and not model.kv_split_on_time(32)
