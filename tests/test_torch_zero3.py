"""Expert-parallel MoE and the per-unit gather and free of the sharded
parameters (ZeRO-3) against one process and against ``repro``, on the CPU.

Each case runs on gloo ranks (one process a rank, each launch bounded by
its own timeout, as ``tests/test_torch_distributed.py`` runs them):

* the MoE layer split over a (1, 2) and a (1, 4) mesh against the unsplit
  layer and ``repro.models.moe.moe_apply`` on the same numpy parameters;
* ``Trainer(mesh=)`` on reduced Phi-3.5-MoE (top-2) and reduced Maverick
  (top-1, ``("attn", "moe")``) over (2, 2) and (1, 4) against ``repro``'s
  ``Trainer(mesh=)`` on fake XLA devices and against one process;
* the invariant: one unit gathered at a time, and between steps every
  parameter held as its rule shard;
* the collectives of a step against the count the units give;
* the cross-pod reduce-scatter's order (``data`` before ``pod``).
"""
import dataclasses
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402

from test_torch_distributed import (PARAM_TOL, TRAIN, TRAIN_RTOL,  # noqa: E402
                                    TRAIN_SHAPE, _gloo, _jax, _src, _sum_lr)
from test_torch_tp import REPRO_RTOL, STEP_SETUP, TP_RTOL, _rel  # noqa: E402

# --- (a) the MoE layer split over model ------------------------------------

MOE_SRC = """
import numpy as np
import torch
from repro_torch.models.moe import MoE, moe_apply

D, F, E, T = 64, 128, 4, 24
TOP_KS = (1, 2)


def moe_case(top_k):
    rng = np.random.default_rng(30 + top_k)

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    state = {"router.w": w(D, E, scale=0.5),
             "gate": w(E, D, F, scale=D ** -.5),
             "up": w(E, D, F, scale=D ** -.5),
             "down": w(E, F, D, scale=F ** -.5)}
    return state, w(2, T, D, scale=1.0), w(2, T, D, scale=1.0)


def run_moe(moe, x, ct, top_k):
    \"\"\"Output, aux loss and the gradient of a scalar of both w.r.t. x
    and every parameter (the layer's own, as the rank holds them).\"\"\"
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe_apply(moe, xt, top_k=top_k, capacity_factor=1.0)
    ((out * torch.from_numpy(ct)).sum() + 3.0 * aux).backward()
    return out, aux, xt.grad, {k: p.grad for k, p in moe.named_parameters()}
"""
MOE_WORLDS = (2, 4)
MOE_TOP_KS = (1, 2)


@pytest.fixture(scope="module")
def moe_ranks():
    """The MoE layer on gloo ranks over a (1, 2) and a (1, 4) mesh, for
    top-1 and top-2: each rank's output, aux loss, x's gradient, every
    parameter's gradient gathered full and its experts' local shape."""
    runs = {}
    for world in MOE_WORLDS:
        with tempfile.TemporaryDirectory() as out:
            runs[world] = _gloo(_src(MOE_SRC, """
            from repro_torch.launch.mesh import make_mesh
            from repro_torch.sharding.tensor_parallel import (gather_full,
                                                              local, tp_group)
            mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
            tp = tp_group(mesh)
            res = {}
            for top_k in TOP_KS:
                state, x, ct = moe_case(top_k)
                moe = MoE(D, F, E, device="cpu")
                moe.tensor_parallel_(tp)
                with torch.no_grad():
                    for k, p in moe.named_parameters():
                        full = torch.from_numpy(state[k])
                        p.copy_(local(full, 0, tp) if k in moe.tp_local
                                else full)
                out, aux, gx, grads = run_moe(moe, x, ct, top_k)
                res[top_k] = {
                    "out": out.tolist(), "aux": float(aux),
                    "grads": {"x": gx.tolist(), **{
                        k: (gather_full(g, 0, tp) if k in moe.tp_local
                            else g).tolist() for k, g in grads.items()}},
                    "local": {k: list(moe.get_parameter(k).shape)
                              for k in moe.tp_local},
                    "span": list(moe.expert_span())}
            emit(res)
            """), world, out, timeout=240)
    return runs


@pytest.mark.parametrize("top_k", MOE_TOP_KS)
@pytest.mark.parametrize("world", MOE_WORLDS)
def test_split_moe_matches_single_process_and_repro(world, top_k, moe_ranks):
    """Reduced Phi-3.5-MoE widths (D 64, d_ff 128), 4 experts, capacity
    1.0 (tokens drop): every rank's fp32 output equals the unsplit
    layer's exactly (a token meets at most two nonzero terms in the sum
    over ``model``), its aux loss too; x's and every parameter's gradient
    (the experts' gathered) within ``TP_RTOL``; the output within
    ``REPRO_RTOL`` of ``repro``'s ``moe_apply``; each rank holds its E/tp
    experts of ``gate``, ``up`` and ``down``, and the router whole."""
    ns = {}
    exec(MOE_SRC, ns)
    state, x, ct = ns["moe_case"](top_k)
    moe = ns["MoE"](ns["D"], ns["F"], ns["E"], device="cpu")
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out, aux, gx, grads = ns["run_moe"](moe, x, ct, top_k)
    jp = {"router": {"w": jnp.asarray(state["router.w"])},
          **{k: jnp.asarray(state[k]) for k in ("gate", "up", "down")}}
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=top_k,
                                capacity_factor=1.0)
    assert _rel(out.detach().numpy(), np.asarray(want)) <= REPRO_RTOL
    e_loc = ns["E"] // world
    for r, got in enumerate(moe_ranks[world]):
        res = got[str(top_k)]
        assert np.array_equal(np.asarray(res["out"], np.float32),
                              out.detach().numpy()), r
        assert res["aux"] == float(aux.detach()), r
        assert _rel(res["out"], np.asarray(want)) <= REPRO_RTOL, r
        assert _rel(res["grads"]["x"], gx.numpy()) <= TP_RTOL, r
        for k, g in grads.items():
            assert _rel(res["grads"][k], g.numpy()) <= TP_RTOL, (r, k)
        assert res["span"] == [r * e_loc, (r + 1) * e_loc]
        assert res["local"] == {
            "gate": [e_loc, ns["D"], ns["F"]], "up": [e_loc, ns["D"], ns["F"]],
            "down": [e_loc, ns["F"], ns["D"]]}, r


def test_moe_split_errors_and_gathered_names():
    """Experts that do not split over the ranks raise (the layer then
    stays whole); a split model names only its routers in
    ``tp_gathered``, and one whose experts do not split names the MoE."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.models import Transformer
    from repro_torch.models.moe import MoE
    from repro_torch.sharding.tensor_parallel import TP, TensorParallelError
    with pytest.raises(TensorParallelError, match="experts"):
        MoE(16, 32, 6, device="cpu").tensor_parallel_(TP(0, 4))
    cfg = reduced_config(REGISTRY["phi3.5-moe-42b-a6.6b"])
    split = Transformer(cfg, device="meta").shard_(tp=TP(1, 2))
    assert sorted(split.tp_gathered) == ["layers.0.moe.router",
                                         "layers.1.moe.router"]
    assert split.layers[0].moe.gate.shape[0] == cfg.n_experts // 2
    whole = Transformer(dataclasses.replace(cfg, n_experts=6),
                        device="meta").shard_(tp=TP(1, 4))
    assert "layers.0.moe" in whole.tp_gathered
    assert whole.layers[0].moe.gate.shape[0] == 6


# --- (b) the whole trainer against repro's and one process -------------------

MOE_KNOBS = {"phi": ("phi3.5-moe-42b-a6.6b", dict(dtype="float32",
                                                  remat=True)),
             "maverick": ("llama4-maverick-400b-a17b",
                          dict(dtype="float32", remat=False))}
MOE_RUNS = (("phi", (2, 2)), ("phi", (1, 4)), ("maverick", (2, 2)),
            ("maverick", (1, 4)))


def _run_id(model, sizes):
    return f"{model}-{sizes[0]}x{sizes[1]}"


@pytest.fixture(scope="module")
def repro_moe(tmp_path_factory):
    """``repro``'s ``Trainer(mesh=)`` on 4 fake XLA devices for every run
    of ``MOE_RUNS`` (reference backend): the initial and final states
    under the port's names and each history."""
    out = tmp_path_factory.mktemp("repro_moe")
    res = _jax(f"""
    import dataclasses, json
    import jax, numpy as np
    from repro import api
    from repro.configs import REGISTRY as JR, reduced_config as jreduced
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.models import build_model
    from repro.runtime import Trainer, TrainerConfig
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.convert import params_from_jax

    OUT = {str(out)!r}
    res = {{}}
    for model_name, sizes in {MOE_RUNS!r}:
        arch, knobs = {MOE_KNOBS!r}[model_name]
        rid = f"{{model_name}}-{{sizes[0]}}x{{sizes[1]}}"
        jcfg = dataclasses.replace(jreduced(JR[arch]), **knobs)
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        mesh = make_mesh(sizes, ("data", "model"))
        t = Trainer(build_model(jcfg), jcfg, ShapeConfig(**{TRAIN_SHAPE!r}),
                    TrainerConfig(**{TRAIN!r}), mesh=mesh)
        init = jax.tree.map(np.array, t.state[0])
        with api.use_backend("reference"), mesh_context(mesh):
            res[rid] = t.run()["history"]
        for name, tree in (("init", init), ("final", t.state[0])):
            np.savez(f"{{OUT}}/{{name}}-{{rid}}.npz", **{{
                k: v.numpy() for k, v in params_from_jax(
                    cfg, jax.tree.map(np.asarray, tree)).items()}})
    print(json.dumps(res))
    """, devices=4, timeout=600)
    return out, res


@pytest.mark.parametrize("model,sizes", MOE_RUNS,
                         ids=[_run_id(*r) for r in MOE_RUNS])
def test_moe_trainer_matches_repro_and_single_process(model, sizes,
                                                      repro_moe):
    """``Trainer(mesh=)`` on four gloo ranks, experts split over
    ``model`` and every parameter held as its rule shard, from ``repro``'s
    initial parameters, 3 steps of accum 2: every step's loss and gradient
    norm within ``TRAIN_RTOL`` and the final parameters (written by the
    checkpoint) within ``PARAM_TOL`` (the 99.9 % quantile) of ``repro``'s
    ``Trainer(mesh=)`` on the same mesh of fake XLA devices and of the
    single-process trainer.  On the ranks: each MoE layer's E/tp experts
    and only the routers in ``tp_gathered``."""
    jdir, jres = repro_moe
    rid = _run_id(model, sizes)
    arch, knobs = MOE_KNOBS[model]
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src(f"""
        TRAIN, TRAIN_SHAPE = {TRAIN!r}, {TRAIN_SHAPE!r}
        """, STEP_SETUP, f"""
        mesh = make_mesh({sizes!r}, ("data", "model"), device="cpu")
        t = trainer({arch!r}, {knobs!r}, mesh, None,
                    ckpt_dir=os.path.join(OUT, "ckpt"))
        init = np.load({os.path.join(str(jdir), f"init-{rid}.npz")!r})
        t.model.load_state_dict({{k: torch.from_numpy(init[k])
                                  for k in init.files}})
        moes = [b.moe for b in t.model.layers if hasattr(b, "moe")]
        assert moes and all(m.gate.shape[0] * {sizes[1]} == m.n_experts
                            for m in moes)
        assert all(k.endswith(".moe.router") for k in t.model.tp_gathered)
        emit({{"hist": t.run()["history"]}})
        """), 4, out)
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
        from repro_torch.models import build_model
        from repro_torch.runtime import Trainer, TrainerConfig
        cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
        one = Trainer(build_model(cfg, device="cpu"), cfg,
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
    for g, w, a in zip(got[0]["hist"], jres[rid], alone):
        assert g["step"] == w["step"] == a["step"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=TRAIN_RTOL)
            np.testing.assert_allclose(g[key], a[key], rtol=TRAIN_RTOL)
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


# --- (c), (d) the invariant and the collectives of a step ------------------

INVARIANT_SRC = """
import dataclasses
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.roofline import CommRecorder
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.sharding.zero3 import unit_of


def held(z):
    \"\"\"The sharded parameters whose storage is allocated.\"\"\"
    return sorted(k for k in z.axes
                  if z.params[k].untyped_storage().nbytes() > 0)


def between_steps(z):
    \"\"\"Every sharded parameter holds no storage, its master is its
    shard (the full size over the ranks its gathers span), and the rank's
    parameter bytes are its masters' exactly.\"\"\"
    assert held(z) == [] and not z.live, held(z)
    for k, axes in z.axes.items():
        n = 1
        for _, _, size, _ in axes:
            n *= size
        assert z.master[k].numel() * n == z.params[k].numel(), k
    seen, total = set(), 0
    for t in z.master.values():
        if t.untyped_storage().data_ptr() not in seen:
            seen.add(t.untyped_storage().data_ptr())
            total += t.untyped_storage().nbytes()
    assert z.param_bytes() == total


def run(arch, knobs, sizes, accum=2):
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **knobs)
    mesh = make_mesh(sizes, ("data", "model"), device="cpu")
    t = Trainer(build_model(cfg, device="cpu", mesh=mesh), cfg,
                ShapeConfig("t", "train", 32, 8),
                TrainerConfig(steps=2, log_every=1, accum_steps=accum),
                mesh=mesh)
    z = t.model.zero3
    seen = []
    gather = z.gather

    def checked(unit, phase="forward"):
        fresh = unit not in z.live
        gather(unit, phase)
        if fresh:
            # one unit at a time: the one just gathered, nothing else
            assert z.live == {unit}, (unit, z.live)
            assert all(unit_of(k) == unit for k in held(z)), held(z)
            seen.append((unit, phase))
    z.gather = checked
    z.log = []
    between_steps(z)
    with CommRecorder() as comm:
        t.run(failure_hook=lambda step: between_steps(z))
    ops = [op for op, _ in comm.records]
    on_dp = [k for k, sh in z.shardings.items()
             if any(mesh.mesh_dim_names[i] == "data"
                    for i, *_ in sh._sharded())]
    return {"log": z.log, "seen": seen, "all_gather": ops.count("all-gather"),
            "reduce_scatter": ops.count("reduce-scatter"),
            "per_unit": {u: z.gather_counts(u) for u in z.units},
            "on_dp": len(on_dp), "layers": cfg.n_layers}
"""
INVARIANT_RUNS = {
    "phi-remat": ("phi3.5-moe-42b-a6.6b", dict(dtype="float32", remat=True)),
    "phi": ("phi3.5-moe-42b-a6.6b", dict(dtype="float32", remat=False)),
    "granite": ("granite-3-8b", dict(dtype="float32", remat=True))}


@pytest.fixture(scope="module")
def invariant_ranks():
    """Two ``Trainer`` steps of accum 2 on a (2, 2) mesh for each of
    ``INVARIANT_RUNS``, the gathers checked as they happen."""
    with tempfile.TemporaryDirectory() as out:
        return _gloo(_src(INVARIANT_SRC, f"""
        emit({{name: run(arch, knobs, (2, 2)) for name, (arch, knobs)
               in {INVARIANT_RUNS!r}.items()}})
        """), 4, out, timeout=300)


@pytest.mark.parametrize("name", sorted(INVARIANT_RUNS))
def test_one_unit_gathered_at_a_time(name, invariant_ranks):
    """While a unit runs (forward, and its backward: the remat recompute
    or the saved weights) it is the only one gathered and only its
    parameters hold storage; between steps every sharded parameter holds
    none and the rank's parameter bytes are exactly its rule shards'
    (checked on the ranks).  Each microbatch gathers in this order: the
    embedding (the lookup), each layer, the embedding (the norm and
    head), then backward the head and each layer last to first."""
    for res in invariant_ranks:
        run = res[name]
        layers = [f"layers.{i}" for i in range(run["layers"])]
        micro = ([("embed", "forward")] + [(u, "forward") for u in layers]
                 + [("embed", "forward"), ("embed", "backward")]
                 + [(u, "backward") for u in reversed(layers)])
        want = micro * 2 * 2                  # 2 microbatches, 2 steps
        assert [tuple(x) for x in run["log"]] == want
        assert [tuple(x) for x in run["seen"]] == want


@pytest.mark.parametrize("name", sorted(INVARIANT_RUNS))
def test_collectives_of_a_step(name, invariant_ranks):
    """Per microbatch: each unit's gathers (one all-gather a mesh dim it
    gathers over: the data axis, and ``model`` for the MoE router, which
    every rank holds whole) once a forward call and once in the backward,
    and one reduce-scatter a parameter the rules shard over ``data``;
    dense granite gathers each unit in one all-gather.  The split blocks'
    own collectives are all-reduces."""
    for res in invariant_ranks:
        run = res[name]
        per = run["per_unit"]
        n = 2 * 2
        gathers = sum(per[u] for u, _ in run["log"])
        assert gathers == n * (3 * per["embed"] + 2 * sum(
            per[f"layers.{i}"] for i in range(run["layers"])))
        assert run["all_gather"] == gathers
        assert run["reduce_scatter"] == n * run["on_dp"]
        if name == "granite":
            assert set(per.values()) == {1}
        else:
            assert per["embed"] == 1
            assert all(per[f"layers.{i}"] == 2
                       for i in range(run["layers"]))


# --- (e) the cross-pod reduce-scatter --------------------------------------

def test_cross_pod_reduce_scatter_reduces_data_first():
    """On a (2, 2, 1) pod × data × model mesh a gradient FSDP-sharded over
    ``("data", "pod")`` on one dim is reduced over ``data`` first (its
    result half the input, then a quarter), and every rank's shard is the
    mean over the four ranks of its quarter in DTensor's order (pod
    major), as the major-first order gave it; a tensor sharded over
    ``data`` only is replicated over ``pod`` and all-reduced there."""
    with tempfile.TemporaryDirectory() as out:
        got = _gloo("""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.sharding import rules
        from repro_torch.sharding.rules import P, make_shardings
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        calls = []
        orig = dist.reduce_scatter_tensor

        def rs(out, inp, group=None, **kw):
            calls.append([dist.get_process_group_ranks(group),
                          inp.numel(), out.numel()])
            return orig(out, inp, group=group, **kw)
        rules.dist.reduce_scatter_tensor = rs
        sh = make_shardings(mesh, {"w": P(("data", "pod"), None),
                                   "v": P("data", None)},
                            {"w": (16, 3), "v": (16, 3)})
        g = (torch.arange(48.0).reshape(16, 3) + 1) * (RANK + 1)
        res = {"w": sh["w"].reduce_scatter(g).tolist()}
        res["w_calls"], calls[:] = list(calls), []
        res["v"] = sh["v"].reduce_scatter(g).tolist()
        res["v_calls"] = calls
        res["coord"] = mesh.get_coordinate()
        emit(res)
        """, 4, out)
    base = np.arange(48.0).reshape(16, 3) + 1
    mean = base * np.mean([1, 2, 3, 4])
    for r in got:
        pod, data, _ = r["coord"]
        data_group = sorted({pod * 2, pod * 2 + 1})
        # data first (the input whole, its output half), then pod
        (g1, in1, out1), (g2, in2, out2) = r["w_calls"]
        assert sorted(g1) == data_group and in1 == 48 and out1 == 24
        assert sorted(g2) == sorted({data, data + 2}) and out2 == 12
        chunk = pod * 2 + data
        np.testing.assert_array_equal(r["w"], mean[chunk * 4:chunk * 4 + 4])
        (g, _, _), = r["v_calls"]
        assert sorted(g) == data_group
        np.testing.assert_array_equal(r["v"], mean[data * 8:data * 8 + 8])


# --- (f) the bucket bound on one collective ---------------------------------

BUCKET_SRC = """
import dataclasses
from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.roofline import CommRecorder
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, make_shardings


def step_run(bound):
    rules.BUCKET_BYTES = bound
    cfg = dataclasses.replace(
        reduced_config(REGISTRY["phi3.5-moe-42b-a6.6b"]), dtype="float32",
        remat=True)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    t = Trainer(build_model(cfg, device="cpu", mesh=mesh), cfg,
                ShapeConfig("t", "train", 32, 8),
                TrainerConfig(steps=2, log_every=1, accum_steps=2),
                mesh=mesh)
    z = t.model.zero3
    z.log = []
    with CommRecorder() as comm:
        hist = t.run()["history"]
    ops = [op for op, _ in comm.records]
    return {"loss": [h["loss"] for h in hist],
            "master": {k: v.tolist() for k, v in z.master.items()},
            "all_gather": ops.count("all-gather"),
            "want_gathers": sum(z.gather_counts(u) for u, _ in z.log),
            "reduce_scatter": ops.count("reduce-scatter"),
            "want_scatters": 2 * 2 * z.reduce_scatters(),
            "per_unit": {u: z.gather_counts(u) for u in z.units}}


def pod_scatter(bound):
    rules.BUCKET_BYTES = bound
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    sh = make_shardings(mesh, {"w": P(("data", "pod"), None)},
                        {"w": (16, 3)})["w"]
    g = (torch.arange(48.0).reshape(16, 3) + 1) * (RANK + 1)
    with CommRecorder() as comm:
        got = sh.reduce_scatter(g)
    return {"w": got.tolist(), "calls": len(comm.records),
            "want": sh.reduce_scatters((16, 3), 4)}
"""
SMALL_BUCKET = 2048


@pytest.fixture(scope="module")
def bucket_ranks():
    """Reduced Phi-3.5-MoE, 2 steps of accum 2 on a (2, 2) mesh, with the
    default bucket and with one of ``SMALL_BUCKET`` bytes; the cross-pod
    reduce-scatter of ``test_cross_pod_...`` whole and in 64-byte
    slices."""
    with tempfile.TemporaryDirectory() as out:
        return _gloo(_src(BUCKET_SRC, f"""
        emit({{"whole": step_run(rules.BUCKET_BYTES),
               "small": step_run({SMALL_BUCKET}),
               "pod_whole": pod_scatter(1 << 20),
               "pod_small": pod_scatter(64)}})
        """), 4, out, timeout=300)


def test_small_buckets_keep_the_step_exact(bucket_ranks):
    """With every all-gather and reduce-scatter cut to ``SMALL_BUCKET``
    bytes (buckets of parameters, a larger one in slices along a dim it is
    not split on) the two steps give the same losses and master shards bit
    for bit, and a step makes the collectives the plan counts: more
    all-gathers a layer than one a mesh dim, and reduce-scatters in
    slices."""
    for res in bucket_ranks:
        whole, small = res["whole"], res["small"]
        assert small["loss"] == whole["loss"]
        assert small["master"] == whole["master"]
        for run in (whole, small):
            assert run["all_gather"] == run["want_gathers"]
            assert run["reduce_scatter"] == run["want_scatters"]
        assert small["all_gather"] > whole["all_gather"]
        assert small["reduce_scatter"] > whole["reduce_scatter"]
        assert all(small["per_unit"][u] > 2 for u in small["per_unit"]
                   if u.startswith("layers."))


def test_sliced_reduce_scatter_matches_whole(bucket_ranks):
    """The cross-pod reduce-scatter in slices of at most 64 bytes along
    the dim it does not shard (three columns over ``data``, then two over
    ``pod``) equals the whole one exactly."""
    for res in bucket_ranks:
        assert res["pod_small"]["w"] == res["pod_whole"]["w"]
        assert res["pod_whole"]["calls"] == res["pod_whole"]["want"] == 2
        assert res["pod_small"]["calls"] == res["pod_small"]["want"] == 5


def test_mesh_trainer_is_freed_after_use():
    """A ``Trainer(mesh=)`` (its model held as rule shards by a ``Zero3``
    manager whose gradient hooks sit on the parameters) leaves nothing
    alive once the caller drops it: the model and the manager are
    collected, so a process that trains on a mesh and moves on frees the
    card (one gloo rank, a (1, 1) mesh, one step)."""
    from test_torch_distributed import TRAIN, TRAIN_SHAPE
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(_src(f"""
        TRAIN, TRAIN_SHAPE = {TRAIN!r}, dict({TRAIN_SHAPE!r})
        TRAIN["steps"] = 1
        """, STEP_SETUP, """
        import gc, weakref
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")


        def run():
            t = trainer("granite-3-8b", dict(dtype="float32"), mesh, None)
            t.run()
            return weakref.ref(t.model), weakref.ref(t._step_fn.zero3)
        refs = run()
        gc.collect()
        emit([r() is None for r in refs])
        """), 1, out)
    assert got == [[True, True]]
