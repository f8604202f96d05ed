"""The port's sharded runtime against ``repro``'s, on the CPU.

The port runs one process a rank over gloo (each launch bounded by its own
timeout); ``repro`` runs in one subprocess on fake XLA devices, as
``tests/test_distributed.py`` runs it.  Held against each other: the
spec tables of every config, data shards, the sharded ``Trainer`` on a
(2, 2) and a (2, 2, 1) mesh against ``repro``'s on the same mesh and
against the single-process trainer, the compressed DP step,
the 4-stage pipeline, elastic restore onto a smaller mesh and
``rescale_accum``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.runtime.elastic import rescale_accum as jax_rescale  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.checkpoint import jax_state_layout  # noqa: E402
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.elastic import rescale_accum  # noqa: E402
from repro_torch.sharding import (batch_pspecs, cache_pspec,  # noqa: E402
                                  param_pspec, sanitize_pspec)

from _torch_families import patterns_of  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPARSE = dict(dtype="float32", ffn_block_sparse=True, ffn_block=32)
# the sharded trainer against repro's and against one process: the same
# arithmetic but for the summation order of the reduce-scatter and of the
# global norm.  Loss and gradient norm relative (measured: at most 4.4e-7;
# an unchanged state is off by 6.4e-4 and 0.107 or more); parameters
# absolute, the 99.9 % quantile of each tensor's differences (measured: at
# most 2.6e-6; the parameters move by a median 1.0e-2)
TRAIN_RTOL = 1e-5
PARAM_TOL = 2e-5
# repro's shard_map collectives and gloo's sum the ranks in other orders
COMPRESS_TOL = 1e-4
PIPE_TOL = 1e-5

HEADER = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group(
    "gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"], rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=120))


def emit(obj):
    with open(os.path.join(OUT, f"r{RANK}.json"), "w") as f:
        json.dump(obj, f)
"""
# every rank waits for the others (rank 0 hosts the store that a late
# rank may still need), then leaves without the interpreter's teardown:
# gloo's C++ objects, still referenced from Python (meshes, groups in
# closures), can abort a process as they are destroyed at exit
# ("terminate called without an active exception") after its work and
# checks are done
FOOTER = """
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def _src(*parts: str) -> str:
    """Source pieces, each dedented, one after the other."""
    return "".join(textwrap.dedent(p) for p in parts)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo(body: str, world: int, out: str, timeout: int = 240):
    """Run ``body`` on ``world`` gloo ranks (one process each, all killed
    at ``timeout`` seconds); returns each rank's ``emit``ted object."""
    script = HEADER + _src(body) + FOOTER
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OUT=out,
               WORLD_SIZE=str(world), PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(env, RANK=str(r)), cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    runs = []
    try:
        for p in procs:
            runs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, runs)):
        assert p.returncode == 0, f"rank {r}:\nSTDOUT:\n{o}\nSTDERR:\n{e}"
    got = []
    for r in range(world):
        path = os.path.join(out, f"r{r}.json")
        got.append(json.load(open(path)) if os.path.exists(path) else None)
    return got


def _jax(body: str, devices: int, timeout: int = 240):
    """``repro`` in a subprocess on ``devices`` fake XLA devices; returns
    the JSON object its last line prints."""
    script = ("import os\nos.environ['XLA_FLAGS'] = "
              f"'--xla_force_host_platform_device_count={devices}'\n"
              + _src(body))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=str(ROOT))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


# --- spec tables, data shards, rescale_accum (one process) ------------------

MESHES = [(("data", "model"), (4, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (3, 1)), (("pod", "data", "model"), (2, 4, 2))]


def _meshes(axes, sizes):
    """The same mesh as the port's rules read it (``mesh_dim_names``,
    ``shape``) and as ``repro``'s do (``axis_names``, ``shape[axis]``)."""
    return (types.SimpleNamespace(mesh_dim_names=axes, shape=sizes),
            types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, sizes))))


def _entries(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_spec_table_matches_repro(arch):
    """Every parameter of the reduced config (dense and sparse FFN): the
    port's spec of each per-layer tensor is ``repro``'s spec of the stacked
    leaf without its stack axis, raw and sanitized on four meshes and two
    FSDP axes; the batch specs and the decode cache's specs too."""
    for knobs in (dict(dtype="float32"), SPARSE):
        jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY[arch]), **knobs)
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        jmodel = jax_build(jcfg)
        leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0))))[0]
        pats = patterns_of(jmodel)
        model = build_model(cfg, device="cpu", ffn_patterns=pats)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        layout = jax_state_layout(cfg, pats)[:len(leaves)]
        n_checked = 0
        for (path, leaf), entry in zip(leaves, layout):
            assert "[0]" + jax.tree_util.keystr(path) == entry.path
            stack = len(leaf.shape) - len(shapes[entry.names[0][7:]])
            for name in entry.names:
                shape = shapes[name[len("params/"):]]
                for fsdp in ("data", ("data", "pod")):
                    want = jrules.param_pspec(path, leaf, dp=fsdp)
                    got = param_pspec(name, shape, dp=fsdp)
                    w = _entries(want, leaf.ndim)
                    assert w[:stack] == (None,) * stack, (path, want)
                    assert _entries(got, len(shape)) == w[stack:], \
                        (name, got, want)
                    for axes, sizes in MESHES:
                        pm, jm = _meshes(axes, sizes)
                        ws = jrules.sanitize_pspec(jm, want, leaf.shape)
                        gs = sanitize_pspec(pm, got, shape)
                        assert _entries(gs, len(shape)) == \
                            _entries(ws, leaf.ndim)[stack:], (name, sizes)
                n_checked += 1
        assert n_checked == len(shapes)
        batch = SyntheticDataset(cfg, ShapeConfig("t", "train", seq_len=8,
                                                  global_batch=4)).batch(0)
        cache = model.init_cache(4, 1024) if cfg.family != "enc_dec" else {}
        for axes, sizes in MESHES:
            pm, jm = _meshes(axes, sizes)
            want = jrules.batch_pspecs(jm, batch)
            assert {k: tuple(v) for k, v in batch_pspecs(pm, batch).items()} \
                == {k: tuple(v) for k, v in want.items()}
            for k, t in cache.items():
                assert tuple(cache_pspec(pm, t)) == tuple(
                    jrules.cache_pspec(jm, np.empty(t.shape, np.int8))), k


@pytest.mark.parametrize("arch", ["granite-3-8b", "internvl2-2b",
                                  "whisper-tiny"])
def test_data_shards_bit_equal_to_repro(arch):
    """``batch(step, shard=)`` over a slice, a strided slice and row
    indices: bit for bit ``repro``'s, and the same rows of the full
    batch."""
    shape = dict(name="t", kind="train", seq_len=16, global_batch=8)
    want = JaxDataset(jax_reduced(JAX_REGISTRY[arch]),
                      JaxShapeConfig(**shape), seed=5)
    got = SyntheticDataset(reduced_config(REGISTRY[arch]),
                           ShapeConfig(**shape), seed=5)
    full = got.batch(3)
    for shard in (slice(2, 6), slice(None, None, 3), np.array([5, 0, 3])):
        w, g = want.batch(3, shard=shard), got.batch(3, shard=shard)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], full[k][shard])


def test_rescale_accum_table_matches_repro():
    for gb in (64, 96, 128, 256):
        for od in (1, 4, 8, 16):
            for nd in (1, 2, 3, 5, 6, 8, 10):
                for oa in (1, 2, 4):
                    got = rescale_accum(gb, od, nd, oa)
                    assert got == jax_rescale(gb, od, nd, oa)
                    assert got[1] >= gb


# --- the sharded trainer (gloo) against repro's on fake devices ------------

# warmup 0 and a rate at which the state moves far beyond the tolerances
# below: the guards in the test hold each tolerance against what an
# unchanged state would give (the loss and gradient norm at steps 1-2 of
# the initial parameters, and how far the parameters moved)
TRAIN = dict(steps=3, log_every=1, accum_steps=2, peak_lr=1e-2, warmup=0)
TRAIN_SHAPE = dict(name="t", kind="train", seq_len=32, global_batch=8)
TRAIN_MESHES = {"data-model": ((2, 2), ("data", "model")),
                "pod-data-model": ((2, 2, 1), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def repro_sharded(tmp_path_factory):
    """``repro``'s ``Trainer(mesh=)`` on 4 fake XLA devices over each mesh
    of ``TRAIN_MESHES`` (reduced granite, sparse FFN, accum 2, reference
    backend), as ``tests/test_distributed.py`` runs it.  Writes the initial
    and each final state under the port's names (``init.npz``,
    ``final-<mesh>.npz``) and the FFN patterns; returns the directory,
    each mesh's history and the unchanged-state reading."""
    out = tmp_path_factory.mktemp("repro_sharded")
    res = _jax(f"""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
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
    jcfg = dataclasses.replace(jreduced(JR["granite-3-8b"]), **{SPARSE!r})
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              **{SPARSE!r})
    shape = ShapeConfig(**{TRAIN_SHAPE!r})
    tc = TrainerConfig(**{TRAIN!r})

    def save(name, tree, pats):
        np.savez(f"{{OUT}}/{{name}}.npz", **{{
            k: v.numpy() for k, v in params_from_jax(
                cfg, jax.tree.map(np.asarray, tree), pats).items()}})

    res = {{}}
    for name, (sizes, axes) in {TRAIN_MESHES!r}.items():
        model = build_model(jcfg)
        mesh = make_mesh(sizes, axes)
        t = Trainer(model, jcfg, shape, tc, mesh=mesh)
        pats = patterns_of(model)
        init = jax.tree.map(np.array, t.state[0])   # the step donates it
        with api.use_backend("reference"), mesh_context(mesh):
            res[name] = t.run()["history"]
        save("final-" + name, t.state[0], pats)
    save("init", init, pats)
    np.savez(f"{{OUT}}/patterns.npz", **{{
        f"{{p}}_{{i}}": a for p, v in pats.items() for i, a in enumerate(v)}})
    # what an unchanged state would log at steps 1-2: the loss and the
    # pre-clip gradient norm of the initial parameters on those batches
    res["unchanged"] = []
    n = tc.accum_steps
    for step in (1, 2):
        b = t.data.batch(step)
        rows = shape.global_batch // n
        losses, grads = [], []
        with api.use_backend("reference"):
            for i in range(n):
                mb = {{k: jnp.asarray(v[i * rows:(i + 1) * rows])
                      for k, v in b.items()}}
                (loss, _), g = jax.value_and_grad(model.loss_fn,
                                                  has_aux=True)(init, mb)
                losses.append(float(loss))
                grads.append(g)
        g = jax.tree.map(lambda *x: sum(x) / n, *grads)
        norm = float(jnp.sqrt(sum(jnp.sum(x.astype(jnp.float32) ** 2)
                                  for x in jax.tree.leaves(g))))
        res["unchanged"].append({{"step": step, "loss": sum(losses) / n,
                                 "grad_norm": norm}})
    print(json.dumps(res))
    """, devices=4, timeout=300)
    return out, res


def _sum_lr(tc):
    from repro_torch.optim import cosine_with_warmup
    lr = cosine_with_warmup(tc["peak_lr"], tc["warmup"], tc["steps"])
    return sum(lr(s) for s in range(1, tc["steps"] + 1))


@pytest.mark.parametrize("mesh_name", sorted(TRAIN_MESHES),
                         ids=sorted(TRAIN_MESHES))
def test_sharded_trainer_matches_single_process(mesh_name, repro_sharded):
    """``Trainer(mesh=)`` on four gloo ranks, a (2, 2) data × model mesh
    and a (2, 2, 1) pod × data × model one (four dp ranks; the ``pod``
    axis replicates the FSDP shards, so its gradients are all-reduced),
    from ``repro``'s initial parameters (reduced granite, sparse FFN,
    accum 2): every step's loss and gradient norm, and the final
    parameters as its checkpoint holds them (gathered, written by rank 0),
    against ``repro``'s ``Trainer(mesh=)`` on the same mesh of fake XLA
    devices and against the one-process trainer.  Also on the ranks: the
    state's DTensor shards, a new trainer on the mesh resuming the
    checkpoint bit for bit, the mesh errors, and ``constrain`` /
    ``act_constrain`` on DTensors and plain tensors."""
    jdir, jres = repro_sharded
    sizes, axes = TRAIN_MESHES[mesh_name]
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(f"""
        import dataclasses
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
        from repro_torch.launch.mesh import (MeshSizeError, make_mesh,
            make_production_mesh, mesh_context)
        from repro_torch.models import build_model
        from repro_torch.runtime import Trainer, TrainerConfig
        from repro_torch.sharding import P, act_constrain, constrain

        z = np.load(os.path.join({str(jdir)!r}, "patterns.npz"))
        pats = {{p: (z[p + "_0"], z[p + "_1"]) for p in ("up", "gate", "down")}}
        init = np.load(os.path.join({str(jdir)!r}, "init.npz"))
        cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                                  **{SPARSE!r})
        mesh = make_mesh({sizes!r}, {axes!r}, device="cpu")
        tc = TrainerConfig(ckpt_dir=os.path.join(OUT, "ckpt"), ckpt_every=2,
                           **{TRAIN!r})

        def trainer():
            return Trainer(build_model(cfg, device="cpu", ffn_patterns=pats),
                           cfg, ShapeConfig(**{TRAIN_SHAPE!r}), tc, mesh=mesh)

        t = trainer()
        # into the parameters, which the master shards are views of
        t.model.load_state_dict({{k: torch.from_numpy(init[k])
                                 for k in init.files}})
        hist = t.run()["history"]
        sd = t.state_dict()
        tab = sd["params/embed.table"]
        assert isinstance(tab, DTensor) and tuple(tab.shape) == (512, 64)
        assert tab.to_local().numel() == 512 * 64 // {sizes[-1] * sizes[-2]}
        assert torch.equal(tab.full_tensor(), t.params["embed.table"])
        blocks = sd["params/layers.0.mlp.up.blocks"]
        assert blocks.to_local().shape == blocks.shape
        # a new trainer on the same mesh resumes from the checkpoint
        t2 = trainer()
        assert t2.start_step == 3 and t2.opt_state.step == 3
        for k, p in t.params.items():
            assert torch.equal(t2.params[k], p), k
            assert torch.equal(t2.opt_state.m[k], t.opt_state.m[k]), k
            assert torch.equal(t2.opt_state.v[k], t.opt_state.v[k]), k
        for bad in (lambda: make_mesh((3, 2), ("data", "model"), "cpu"),
                    lambda: make_production_mesh(device="cpu")):
            try:
                bad()
                raise AssertionError("no MeshSizeError")
            except MeshSizeError:
                pass
        x = torch.arange(8.0 * 4 * 6).reshape(8, 4, 6)
        assert constrain(x, mesh, P("data")) is x
        d = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
        with mesh_context(mesh):
            assert act_constrain(x, "hidden") is x
            h = act_constrain(d, "logits")
            s = act_constrain(d, "seq")
        assert act_constrain(d, "hidden") is d
        dp = (Shard(0),) * (mesh.ndim - 1)
        assert h.placements == dp + (Shard(2),)
        assert s.placements == dp + (Shard(1),)
        assert torch.equal(h.full_tensor(), x)
        emit(hist)
        """, 4, out)
        from repro_torch.checkpoint import CheckpointManager
        saved = CheckpointManager(os.path.join(out, "ckpt"))
        assert saved.all_steps() == [2, 3]
        z = np.load(os.path.join(jdir, "patterns.npz"))
        pats = {p: (z[p + "_0"], z[p + "_1"]) for p in ("up", "gate", "down")}
        cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                                  **SPARSE)
        one = Trainer(build_model(cfg, device="cpu", ffn_patterns=pats), cfg,
                      ShapeConfig(**TRAIN_SHAPE), TrainerConfig(**TRAIN))
        init = dict(np.load(os.path.join(jdir, "init.npz")))
        one.model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in init.items()})
        alone = one.run()["history"]
        state = saved.restore(3, one.state_dict())
    assert int(state["opt/step"]) == 3
    final = dict(np.load(os.path.join(jdir, f"final-{mesh_name}.npz")))
    # every rank reports the same metrics (its own host times aside)
    same = [[(h["step"], h["loss"], h["grad_norm"]) for h in r] for r in got]
    assert all(r == same[0] for r in same)
    want = jres[mesh_name]
    for g, w, a in zip(got[0], want, alone):
        assert g["step"] == w["step"] == a["step"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=TRAIN_RTOL)
            np.testing.assert_allclose(g[key], a[key], rtol=TRAIN_RTOL)
    for w, u in zip(want[1:], jres["unchanged"]):
        # an update that never reached the parameters would fail here
        assert w["step"] == u["step"]
        for key in ("loss", "grad_norm"):
            assert abs(w[key] - u[key]) > 10 * TRAIN_RTOL * abs(w[key]), \
                (key, w, u)
    # AdamW's first step moves each weight by ~lr·sign(g): a gradient
    # element near zero, whose sign two summation orders may disagree on,
    # can move two copies apart by up to 2·lr a step (the bound 2·Σ lr);
    # the 99.9 % quantile holds the rest to PARAM_TOL
    atol = 2 * _sum_lr(TRAIN)
    alone_p = dict(one.model.named_parameters())
    moved = []
    for k, w in final.items():
        g = state[f"params/{k}"].numpy()
        for ref in (w, alone_p[k].detach().numpy()):
            d = np.abs(g - ref)
            assert d.max() <= atol, k
            assert np.quantile(d, 0.999) <= PARAM_TOL, (k, d.max())
        moved.append(np.abs(w - init[k]).ravel())
    assert np.median(np.concatenate(moved)) > 10 * PARAM_TOL


# --- compressed DP, pipeline (gloo vs repro on fake devices) ----------------

COMPRESS_STEPS = 20


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressed_dp_step_matches_repro(method):
    """``make_compressed_dp_step`` on 4 ranks against ``repro``'s on 4
    devices (``tests/test_distributed.py``'s least-squares problem): every
    step's loss, the final weights and each rank's error-feedback residual
    within 1e-4."""
    data = """
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(16).astype(np.float32)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((64, 16)).astype(np.float32)
          for _ in range(%d)]
    """ % COMPRESS_STEPS
    want = _jax(_src("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.optim import AdamW, constant
    from repro.runtime.compression import (init_error_fb,
                                           make_compressed_dp_step)
    """, data, """
    mesh = make_mesh((4,), ("data",))

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)

    opt = AdamW(lr=constant(0.05), weight_decay=0.0)
    params = {"w": jnp.zeros(16)}
    state = (params, opt.init(params), init_error_fb(params, 4))
    step = make_compressed_dp_step(loss_fn, opt, mesh, method=%r)
    losses = []
    with mesh_context(mesh):
        for x in xs:
            state, loss = step(state, (jnp.asarray(x),
                                       jnp.asarray(x @ w_true)))
            losses.append(float(loss))
    print(json.dumps({"loss": losses, "w": np.asarray(state[0]["w"]).tolist(),
                      "ef": np.asarray(state[2]["w"]).tolist()}))
    """ % method), devices=4)
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim import AdamW, constant
        from repro_torch.runtime.compression import (init_error_fb,
            make_compressed_dp_step)
        """, data, """
        mesh = make_mesh((4,), ("data",), device="cpu")

        def loss_fn(params, batch):
            x, y = batch
            return torch.mean((x @ params["w"] - y) ** 2)

        opt = AdamW(lr=constant(0.05), weight_decay=0.0)
        params = {"w": torch.zeros(16)}
        state = (params, opt.init(params), init_error_fb(params))
        step = make_compressed_dp_step(loss_fn, opt, mesh, method=%r)
        losses = []
        for x in xs:
            state, loss = step(state, (torch.from_numpy(x),
                                       torch.from_numpy(x @ w_true)))
            losses.append(float(loss))
        emit({"loss": losses, "w": state[0]["w"].tolist(),
              "ef": state[2]["w"].tolist()})
        """ % method), 4, out)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=COMPRESS_TOL)
        np.testing.assert_allclose(g["w"], want["w"], rtol=0,
                                   atol=COMPRESS_TOL)
        np.testing.assert_allclose(g["ef"], want["ef"][r], rtol=0,
                                   atol=COMPRESS_TOL)
    assert want["loss"][-1] < want["loss"][0] * 0.5     # it trains


def test_pipeline_forward_matches_sequential_and_repro():
    """4 stages of 2 layers (``split_layers_into_stages`` of 8 stacked
    layers), 6 microbatches: every rank's output equals the sequential
    product and ``repro``'s ``pipeline_forward`` on 4 devices within
    1e-5."""
    data = """
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((8, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 3, 8)).astype(np.float32)
    """
    want = _jax(_src("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.runtime.pipeline_parallel import (pipeline_forward,
                                                 split_layers_into_stages)
    """, data, """
    mesh = make_mesh((4,), ("stage",))

    def stage_fn(w, a):
        for i in range(w.shape[0]):
            a = jnp.tanh(a @ w[i])
        return a

    got = pipeline_forward(stage_fn, split_layers_into_stages(
        jnp.asarray(ws), 4), jnp.asarray(x), mesh=mesh, n_micro=6)
    print(json.dumps(np.asarray(got).tolist()))
    """), devices=4)
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.runtime.pipeline_parallel import (
            pipeline_forward, split_layers_into_stages)
        """, data, """
        mesh = make_mesh((4,), ("stage",), device="cpu")

        def stage_fn(w, a):
            for i in range(w.shape[0]):
                a = torch.tanh(a @ w[i])
            return a

        y = pipeline_forward(stage_fn, split_layers_into_stages(
            torch.from_numpy(ws), 4), torch.from_numpy(x), mesh=mesh,
            n_micro=6)
        emit(y.tolist())
        """), 4, out)
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.standard_normal((8, 8, 8)) * 0.3)
                          .astype(np.float32))
    seq = torch.from_numpy(rng.standard_normal((6, 3, 8)).astype(np.float32))
    for w in ws:
        seq = torch.tanh(seq @ w)
    for g in got:
        np.testing.assert_allclose(g, seq.numpy(), rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(g, want, rtol=PIPE_TOL, atol=PIPE_TOL)


# --- elastic restore (gloo) --------------------------------------------------


def test_elastic_restore_onto_smaller_mesh():
    """A (2, 2) run's checkpoint and one that ``repro``'s trainer wrote,
    restored after a relaunch on 2 ranks onto ``make_elastic_mesh(
    model_parallel=2)`` (a (1, 2) mesh): each rank's shards equal the
    checkpoint's arrays; a mesh over a subset of ranks leaves the others
    out."""
    with tempfile.TemporaryDirectory() as out:
        jcfg = dataclasses.replace(jax_reduced(JAX_REGISTRY["granite-3-8b"]),
                                   **SPARSE)
        jmodel = jax_build(jcfg)
        JaxTrainer(jmodel, jcfg, JaxShapeConfig(**TRAIN_SHAPE),
                   JaxTrainerConfig(steps=1, ckpt_dir=os.path.join(
                       out, "jax"))).run()
        np.savez(os.path.join(out, "patterns.npz"), **{
            f"{p}_{i}": a for p, v in patterns_of(jmodel).items()
            for i, a in enumerate(v)})
        setup = f"""
        import dataclasses
        from repro_torch.checkpoint import (CheckpointManager, JaxCheckpoint,
                                            restore_jax_checkpoint)
        from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import build_model
        from repro_torch.runtime import Trainer, TrainerConfig
        from repro_torch.runtime.elastic import (make_elastic_mesh,
                                                 restore_onto_mesh)

        z = np.load(os.path.join(OUT, "patterns.npz"))
        pats = {{p: (z[p + "_0"], z[p + "_1"]) for p in ("up", "gate", "down")}}
        cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                                  **{SPARSE!r})

        def trainer(mesh, **kw):
            return Trainer(build_model(cfg, device="cpu", ffn_patterns=pats),
                           cfg, ShapeConfig(**{TRAIN_SHAPE!r}),
                           TrainerConfig(steps=1, **kw), mesh=mesh)
        """
        _gloo(_src(setup, """
        trainer(make_test_mesh(2, 2, device="cpu"),
                ckpt_dir=os.path.join(OUT, "port")).run()
        """), 4, out)
        got = _gloo(_src(setup, """
        mesh = make_elastic_mesh(model_parallel=2, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 2)
        t = trainer(mesh)
        with np.load(os.path.join(OUT, "port", "step_00000001",
                                  "arrays.npz")) as f:
            port = {k: f[k] for k in f.files}
        full = restore_jax_checkpoint(os.path.join(OUT, "jax"), 1, cfg,
                                      pats, device="cpu")
        n = 0
        for ckpt, want in ((CheckpointManager(os.path.join(OUT, "port")),
                            port),
                           (JaxCheckpoint(os.path.join(OUT, "jax"), cfg,
                                          pats), full)):
            sd = restore_onto_mesh(ckpt, 1, t.state_dict(), mesh)
            t.load_state_dict(sd)
            for k, p in t.params.items():
                assert np.array_equal(p.detach().numpy(),
                                      np.asarray(want["params/" + k])), k
            for k, d in sd.items():
                local = d.to_local()
                w = torch.as_tensor(np.asarray(want[k]))
                sh = t._step_fn.shardings.get(k.split("/")[-1])
                if sh is not None:
                    w = sh.shard(w)
                assert torch.equal(local, w.to(local.dtype)), k
                n += 1
        sub = make_elastic_mesh([1], model_parallel=1, device="cpu")
        assert (sub.get_coordinate() is None) == (RANK != 1)
        emit(n)
        """), 2, out)
    assert got[0] == got[1] > 0
