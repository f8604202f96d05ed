"""The port's dry run on the CPU: the abstract specs of every cell against
``repro``'s, the ``fsdp=`` axes of the rules and of the trainer against
``repro``'s, a fake-tensor trace against the same step run for real, the
counterpart of ``tests/test_distributed.py::test_dryrun_cell_small_mesh``
and the command line at a reduced size."""
import dataclasses
import json
import os
import tempfile

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.checkpoint import jax_state_layout  # noqa: E402
from repro_torch.configs import (REGISTRY, SHAPES, ShapeConfig,  # noqa: E402
                                 cell_is_live, reduced_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (Transformer, abstract_params,  # noqa: E402
                                build_model, cache_specs, input_specs)
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.runtime import make_train_step  # noqa: E402
from repro_torch.sharding import params_pspecs, sanitize_pspec  # noqa: E402

from test_torch_distributed import (SPARSE, TRAIN, TRAIN_RTOL,  # noqa: E402
                                    TRAIN_SHAPE, _gloo, _meshes)

FSDP = ("data", "pod")


def _torch_dtype(jdtype):
    return getattr(torch, str(np.dtype(jdtype)) if str(jdtype) != "bfloat16"
                   else "bfloat16")


# --- abstract specs -----------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_specs_match_repro(arch):
    """Every live cell: the same names, shapes and dtypes, on ``meta``."""
    for shape in SHAPES:
        if not cell_is_live(arch, shape):
            continue
        want = jax_input_specs(JAX_REGISTRY[arch], JAX_SHAPES[shape])
        got = input_specs(REGISTRY[arch], SHAPES[shape])
        assert sorted(got) == sorted(want), (arch, shape)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (arch, shape, k)
            assert got[k].dtype == _torch_dtype(w.dtype), (arch, shape, k)


def _repro_layer_cache(cfg, jcache, i):
    """``repro``'s cache leaves of decoder layer ``i`` (port order) as
    ``{name: (per-layer shape, dtype)}``."""
    if cfg.family == "enc_dec":
        sub, idx = jcache["dec"], i
    elif cfg.layer_pattern:
        p = len(cfg.layer_pattern)
        u, j = divmod(i, p)
        n_units = cfg.n_layers // p
        group, idx = ("units", u) if u < n_units else ("tail", 0)
        sub = jcache[group][f"b{j}"]
    else:
        sub, idx = jcache["layers"], i
    (leaves,) = sub.values()
    return {k: (tuple(v.shape[1:]), v.dtype) for k, v in leaves.items()}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs_map_onto_repro(arch):
    """Each decode cell's cache: every layer's entries leaf for leaf (shape
    and dtype) with ``jax.eval_shape`` of ``repro``'s ``init_cache``, and
    the same total bytes."""
    cfg = REGISTRY[arch]
    jmodel = jax_build(JAX_REGISTRY[arch])
    model = Transformer(cfg, device="meta")
    for name in ("decode_32k", "long_500k"):
        if not cell_is_live(arch, name):
            continue
        shape = SHAPES[name]
        jcache = jax.eval_shape(lambda: jmodel.init_cache(
            shape.global_batch, shape.seq_len))
        cache = cache_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in cache.values())
        for i, (keys, idx) in enumerate(zip(model._cache_keys,
                                            model._cache_index)):
            want = _repro_layer_cache(cfg, jcache, i)
            got = {n: (tuple(cache[k][idx].shape), cache[k].dtype)
                   for n, k in keys.items() if k in cache}
            assert sorted(got) == sorted(want), (arch, i)
            for n, (s, dt) in want.items():
                assert got[n] == (s, _torch_dtype(dt)), (arch, i, n)
        jbytes = sum(leaf.size * leaf.dtype.itemsize
                     for leaf in jax.tree_util.tree_leaves(jcache))
        assert sum(t.numel() * t.element_size() for t in cache.values()) \
            == jbytes, arch


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_abstract_params_match_repro(arch):
    """The port's state dict on ``meta`` through ``jax_state_layout``: each
    ``repro`` leaf of ``jax.eval_shape(init)`` is its names' tensors
    stacked, shape and dtype."""
    cfg = REGISTRY[arch]
    jmodel = jax_build(JAX_REGISTRY[arch])
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0))))[0]
    params = abstract_params(cfg)
    layout = jax_state_layout(cfg)[:len(leaves)]
    assert sum(len(e.names) for e in layout) == len(params)
    for (path, leaf), entry in zip(leaves, layout):
        assert "[0]" + jax.tree_util.keystr(path) == entry.path
        ts = [params[n[len("params/"):]] for n in entry.names]
        shape = tuple(ts[0].shape)
        if len(leaf.shape) == len(shape) + 1:
            shape = (len(ts),) + shape
        assert shape == tuple(leaf.shape), entry.path
        assert all(t.device.type == "meta" and
                   t.dtype == _torch_dtype(leaf.dtype) for t in ts)


# --- fsdp= ----------------------------------------------------------------------

def _layout_specs(cfg, jcfg, fsdp, sizes):
    """(port spec, repro spec) of each parameter on a pod × data × model
    mesh of ``sizes``, both sanitized, the repro one without its stack
    axis; and the per-rank shard shapes (``repro``'s ``NamedSharding`` on
    an abstract mesh against the port's rules)."""
    axes = ("pod", "data", "model")
    pm, jm = _meshes(axes, sizes)
    amesh = AbstractMesh(sizes, axes)
    jmodel = jax_build(jcfg)
    ap = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(ap)[0]
    jspecs = jax.tree_util.tree_leaves(
        jrules.params_pspecs(ap, fsdp=fsdp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jsh = jax.tree_util.tree_leaves(
        jrules.make_shardings(amesh, jrules.params_pspecs(ap, fsdp=fsdp),
                              ap),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    params = abstract_params(cfg)
    got = params_pspecs(params, fsdp=fsdp)
    out = []
    for (path, leaf), jspec, sh, entry in zip(
            leaves, jspecs, jsh, jax_state_layout(cfg)[:len(leaves)]):
        for name in entry.names:
            k = name[len("params/"):]
            stack = leaf.ndim - params[k].ndim
            ws = jrules.sanitize_pspec(jm, jspec, leaf.shape)
            gs = sanitize_pspec(pm, got[k], params[k].shape)
            w_entries = (tuple(ws) + (None,) * leaf.ndim)[:leaf.ndim]
            g_entries = (tuple(gs) + (None,) * params[k].ndim)[
                :params[k].ndim]
            div = [1] * params[k].ndim
            for d, e in enumerate(g_entries):
                for a in (e if isinstance(e, tuple) else (e,)):
                    div[d] *= dict(zip(axes, sizes)).get(a, 1)
            shard = tuple(s // n for s, n in zip(params[k].shape, div))
            out.append((k, g_entries, w_entries[stack:], shard,
                        tuple(sh.shard_shape(leaf.shape))[stack:]))
    return out


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "granite-3-8b"])
def test_cross_pod_fsdp_specs_match_repro(arch):
    """``params_pspecs(fsdp=("data", "pod"))`` on a (2, 2, 2) pod × data ×
    model mesh: every parameter's spec, sanitized, is ``repro``'s leaf for
    leaf, and its per-rank shard shape is ``repro``'s ``NamedSharding``'s;
    FSDP over both axes halves the shard of every FSDP dim that
    ``("data",)`` alone shards."""
    cfg = reduced_config(REGISTRY[arch])
    jcfg = jax_reduced(JAX_REGISTRY[arch])
    both = _layout_specs(cfg, jcfg, FSDP, (2, 2, 2))
    data = _layout_specs(cfg, jcfg, "data", (2, 2, 2))
    smaller = 0
    for (k, g, w, shard, jshard), (_, _, _, shard_d, _) in zip(both, data):
        assert g == w, (k, g, w)
        assert shard == jshard, (k, shard, jshard)
        smaller += np.prod(shard) * 2 == np.prod(shard_d)
    assert smaller > 0


def test_cross_pod_fsdp_trainer_on_gloo():
    """``Trainer(mesh=, fsdp=("data", "pod"))`` on four gloo ranks, a (2, 2,
    1) pod × data × model mesh (reduced granite, sparse FFN, accum 2): its
    master shards and moments are split over both dp axes (a quarter of
    each FSDP dim) and its losses and gradient norms are the one-process
    trainer's; the same run with ``fsdp="data"`` replicates over ``pod``
    (half of each)."""
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              **SPARSE)
    with tempfile.TemporaryDirectory() as out:
        got = _gloo(f"""
        import dataclasses
        from repro_torch.configs import REGISTRY, ShapeConfig, reduced_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        from repro_torch.runtime import Trainer, TrainerConfig

        cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                                  **{SPARSE!r})
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        res = {{}}
        for fsdp in (("data", "pod"), "data"):
            t = Trainer(build_model(cfg, device="cpu"), cfg,
                        ShapeConfig(**{TRAIN_SHAPE!r}),
                        TrainerConfig(**{TRAIN!r}), mesh=mesh, fsdp=fsdp)
            hist = t.run()["history"]
            k = "layers.0.attn.wq.w"
            res[str(fsdp)] = {{
                "hist": [[h["loss"], h["grad_norm"]] for h in hist],
                "shard": list(t._step_fn.master[k].shape),
                "m": list(t.opt_state.m[k].shape),
                "full": list(t.params[k].shape)}}
        emit(res)
        """, 4, out)
    one = dryrun_one_process(cfg)
    for r in got:
        both, data = r[str(FSDP)], r["data"]
        # wq.w (64, 64) is (data, model): FSDP on dim 0
        assert both["full"] == [64, 64]
        assert both["shard"] == both["m"] == [16, 64]
        assert data["shard"] == data["m"] == [32, 64]
        for run in (both, data):
            for (loss, norm), (w_loss, w_norm) in zip(run["hist"], one):
                np.testing.assert_allclose(loss, w_loss, rtol=TRAIN_RTOL)
                np.testing.assert_allclose(norm, w_norm, rtol=TRAIN_RTOL)


def dryrun_one_process(cfg):
    from repro_torch.runtime import Trainer, TrainerConfig
    t = Trainer(build_model(cfg, device="cpu"), cfg, ShapeConfig(
        **TRAIN_SHAPE), TrainerConfig(**TRAIN))
    return [(h["loss"], h["grad_norm"]) for h in t.run()["history"]]


# --- traces -----------------------------------------------------------------------

def test_fake_trace_equals_the_real_cpu_step():
    """Reduced granite (sparse FFN, remat, accum 2) at world size 1: the
    dry run's fake-CPU trace and the same step run for real on the CPU
    under the same trackers give the same MemTracker peak, category for
    category, and the same CostCounter FLOPs and bytes, all exactly (a
    CPU storage is counted at its bytes, with no rounding, and the kernel
    operators' CPU implementations allocate nothing the trackers see but
    their outputs, as their fake rules do on a CPU tensor)."""
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              remat=True, **SPARSE)
    shape = ShapeConfig("t", "train", 32, 8)
    dev = torch.device("cpu")
    fake = dryrun.trace_cell(cfg, shape, None, dev=dev, accum=2)
    model = build_model(cfg, device=dev)
    model.init(torch.Generator().manual_seed(0))
    fn, external, opt = dryrun.make_step(cfg, shape, model, None, 1,
                                         accum=2, dev=dev)
    for k, t in zip(("tokens", "targets"), external[-2:]):
        t.copy_(torch.randint(0, cfg.vocab, t.shape))
    real = dryrun.measure(fn, external, opt)
    assert fake["peak"] == real["peak"]
    assert fake["argument"] == real["argument"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["bytes"] == real["bytes"]
    assert fake["records"] == real["records"] == []
    assert fake["peak"]["Optstate"] == 2 * sum(
        p.numel() * 4 for p in model.parameters())


def test_dryrun_cell_small_mesh():
    """The counterpart of ``repro``'s miniature dry run: reduced
    Phi-3.5-MoE on a fake 4 × 2 world (rank 0's step traced on fake CPU
    tensors).  Each rank's AdamW moments, and the master shards the
    optimizer updates, are ``repro``'s per-device shard bytes of
    ``make_shardings`` for the same specs; the parameter peak is those
    shards plus the largest unit's gathered working set (a layer: its
    attention split over ``model``, its experts split E/tp, the router
    whole), as each unit gathers its parameters just before it runs and
    frees them after; the step's collectives are one reduce-scatter per
    FSDP-sharded tensor a microbatch and each unit's all-gathers (one a
    mesh dim it gathers over) at each forward call and in its
    backward."""
    from repro_torch.launch.mesh import make_test_mesh
    cfg = reduced_config(REGISTRY["phi3.5-moe-42b-a6.6b"])
    jcfg = jax_reduced(JAX_REGISTRY["phi3.5-moe-42b-a6.6b"])
    jmodel = jax_build(jcfg)
    ap = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jsh = jrules.make_shardings(AbstractMesh((4, 2), ("data", "model")),
                                jrules.params_pspecs(ap), ap)
    want = sum(np.prod(s.shard_shape(leaf.shape)) * 4
               for s, leaf in zip(jax.tree_util.tree_leaves(
                   jsh, is_leaf=lambda x: isinstance(
                       x, jax.sharding.NamedSharding)),
                   jax.tree_util.tree_leaves(ap)))
    shape = ShapeConfig("t", "train", 32, 8)
    with dryrun.fake_world(8):
        mesh = make_test_mesh(4, 2, device="cpu")
        with dryrun.fake_mode():
            model = Transformer(cfg, device="cpu")
            opt = AdamW(lr=constant(3e-4))
            step = make_train_step(model, opt, 2, mesh=mesh)
            state = opt.init(step.master)
            master = sum(t.numel() * 4 for t in step.master.values())
            batch = {k: torch.empty((2, 32), dtype=torch.int32)
                     for k in ("tokens", "targets")}
            res = dryrun.measure(lambda: step(state, batch),
                                 [model, *batch.values()],
                                 [*state.m.values(), *state.v.values()])
    full = sum(p.numel() * 4 for p in model.parameters())
    z = model.zero3
    units = {u: z.unit_bytes(u) for u in z.units}
    assert master == want < full
    assert res["peak"]["Optstate"] == 2 * want
    assert model.layers[0].moe.gate.shape[0] == cfg.n_experts // 2
    assert max(units, key=units.get).startswith("layers.")
    assert res["peak"]["Parameter"] == want + max(units.values())
    ops = [op for op, _ in res["records"]]
    on_data = sum(1 for s in step.shardings.values()
                  if any(mesh.mesh_dim_names[i] == "data"
                         for i, _, _, _ in s._sharded()))
    assert ops.count("reduce-scatter") == 2 * on_data
    per = {u: z.gather_counts(u) for u in z.units}
    layers = sum(per[f"layers.{i}"] for i in range(cfg.n_layers))
    assert ops.count("all-gather") == 2 * (3 * per["embed"] + 2 * layers)


def test_dryrun_moe_decode_fits_the_card():
    """Phi-3.5-MoE's ``decode_32k`` cell at published widths on the fake
    ``pod_16x16`` world (fake CPU tensors): with the experts split over
    16 ``model`` ranks and the parameters held as their shards, gathered a
    layer at a time, one rank's peak fits an H100's memory; its parameter
    bytes are the fp32 masters (the whole model over 256 ranks) plus one
    layer's working set, far below the whole model."""
    from repro_torch.roofline import H100_SXM
    with tempfile.TemporaryDirectory() as out:
        res = dryrun.run_cell("phi3.5-moe-42b-a6.6b", "decode_32k",
                              out_dir=out, device="cpu")
    cats = res["memory"]["peak_by_category"]
    whole = REGISTRY["phi3.5-moe-42b-a6.6b"].param_count() * 4
    assert res["fit"] and res["memory"]["peak_bytes"] <= H100_SXM.hbm_bytes
    assert whole / 256 < cats["Parameter"] < whole / 64
    assert res["tp_gathered"] == [
        "router: the MoE router (top-k reads every expert's logit)"]


def test_command_line_at_a_reduced_size(monkeypatch):
    """``main`` over every live cell of one arch on fake CPU tensors, the
    config and shapes cut to a CPU size: each JSON file holds ``repro``'s
    keys (but the two the docstring drops) and the port's; a cell over a
    tiny card memory exits 0 when ``EXPECTED_OVER_HBM`` lists it and 2
    when it does not."""
    # 16 query heads (on 4 KV heads), so the attention splits over the
    # mesh's 16 model ranks as granite's 32 do
    small = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                                name="granite-3-8b", n_heads=16, n_kv=4,
                                head_dim=16)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: small)
    monkeypatch.setattr(dryrun, "SHAPES", {
        k: dataclasses.replace(v, seq_len=64) for k, v in SHAPES.items()})
    with tempfile.TemporaryDirectory() as out:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            dryrun.main(["--arch", "granite-3-8b", "--shape", shape,
                         "--device", "cpu", "--out", out])
            res = json.load(open(os.path.join(
                out, f"granite-3-8b__{shape}__pod_16x16.json")))
            for key in ("arch", "shape", "mesh", "chips", "ok", "memory",
                        "cost", "collectives_bytes_per_device", "roofline",
                        "model_flops", "useful_flops_ratio", "fit",
                        "tensor_parallel"):
                assert key in res, key
            assert res["chips"] == 256 and res["fit"] and \
                res["tensor_parallel"] and res["tp"] == 16
            assert set(res["roofline"]) == {
                "compute_s", "memory_s", "collective_s", "dcn_s",
                "dominant", "bound_s"}
            # the split step (measured 0.706 in each of the three cells)
            assert 0.5 <= res["useful_flops_ratio"] < 1
            # every cell's split blocks all-reduce; only training
            # reduce-scatters (its gradients over dp)
            coll = res["collectives_bytes_per_device"]
            assert coll.get("all-reduce", 0) > 0
            assert (shape == "train_4k") == ("reduce-scatter" in coll)
        monkeypatch.setattr(dryrun, "run_cell", _tiny_card(dryrun.run_cell))
        argv = ["--arch", "granite-3-8b", "--shape", "decode_32k",
                "--device", "cpu", "--out", out]
        # granite's decode cell fits the card since its model is split
        # over model: a table that lists it stands for one that expects it
        monkeypatch.setattr(dryrun, "EXPECTED_OVER_HBM", {
            ("granite-3-8b", "decode_32k", "pod_16x16"): "over"})
        dryrun.main(argv)                      # over, as expected: exit 0
        monkeypatch.setattr(dryrun, "EXPECTED_OVER_HBM", {})
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv)
        assert e.value.code == 2


def _tiny_card(run_cell):
    def run(*a, **kw):
        return run_cell(*a, hbm_bytes=1024, **kw)
    return run



def test_folded_microbatches_give_the_whole_step(monkeypatch):
    """A step of 4 microbatches traced as 2 and extended (``unfold``)
    reports what tracing all 4 reports: FLOPs, bytes, collectives and the
    peak by category, exactly (reduced granite on a fake 2 × 2 world)."""
    from repro_torch.launch.mesh import make_test_mesh
    cfg = reduced_config(REGISTRY["granite-3-8b"])
    shape = ShapeConfig("t", "train", 32, 16)
    out = {}
    with dryrun.fake_world(4):
        mesh = make_test_mesh(2, 2, device="cpu")
        for traced in (2, 4):
            monkeypatch.setattr(dryrun, "TRACED_MICROBATCHES", traced)
            out[traced] = dryrun.trace_cell(cfg, shape, mesh, dev="cpu",
                                            accum=4)
    folded, whole = out[2], out[4]
    assert folded["microbatches_traced"] == 2
    assert "microbatches_traced" not in whole
    for key in ("flops", "bytes", "peak", "argument"):
        assert folded[key] == whole[key], key
    # the same collectives (the extra microbatches' after the optimizer's)
    assert sorted(folded["records"]) == sorted(whole["records"])


@pytest.mark.parametrize("kind,sizes", [
    ("train", (2, 1)), ("prefill", (2, 1)), ("train", (1, 2)),
    ("prefill", (1, 2))], ids=["train", "prefill", "train-1x2",
                               "prefill-1x2"])
def test_folded_length_equals_a_direct_trace(kind, sizes, monkeypatch):
    """RWKV-6 (no attention) traced at 1 and 2 layers over 8, 16 and 24
    positions and extended to 3 layers over 32: FLOPs, bytes and
    collective bytes equal a direct trace of 3 layers over 32 exactly, and
    so does every category of the peak in training; in prefill the
    peak's total lies within 2 % (its largest point still moves at these
    lengths: measured 1.2 %) (reduced widths, a fake 2 × 1 world, and a
    fake 1 × 2 one whose two ``model`` ranks split each RWKV layer by
    heads: its collectives grow with T too)."""
    from repro_torch.launch.mesh import make_test_mesh
    monkeypatch.setattr(dryrun, "FOLD_SEQ", (8, 16, 24))
    cfg = dataclasses.replace(reduced_config(REGISTRY["rwkv6-1.6b"]),
                              n_layers=3)
    shape = ShapeConfig("t", kind, 32, 2)
    assert dryrun.host_loop(cfg, shape)
    with dryrun.fake_world(2):
        mesh = make_test_mesh(*sizes, device="cpu")
        folded = dryrun.trace_folded(cfg, shape, mesh, dev="cpu")
        whole = dryrun.trace_cell(cfg, shape, mesh, dev="cpu")
    assert whole["tp"] == sizes[1] and not whole["tp_gathered"]
    from repro_torch.roofline import collective_bytes
    assert folded["collectives"] == collective_bytes(whole["records"])
    for key in ("flops", "bytes", "argument"):
        assert folded[key] == whole[key], key
    assert folded["peak_extrapolated"]
    if kind == "train":
        assert folded["peak"] == whole["peak"]
    else:
        err = abs(folded["peak"]["Total"] / whole["peak"]["Total"] - 1)
        assert err <= 0.02, err


def test_rwkv_cells_are_tensor_parallel(monkeypatch):
    """RWKV-6's four cells (train, prefill, decode, long context) through
    the command line on the 16 x 16 fake mesh, its config cut to a CPU
    size with 16 heads so that they split over the 16 ``model`` ranks as
    rwkv6-1.6b's 32 do: each reports ``tensor_parallel`` true and nothing
    gathered, and its collectives all-reduce (the split blocks' outputs
    and ``ln_x``'s statistic)."""
    small = dataclasses.replace(reduced_config(REGISTRY["rwkv6-1.6b"]),
                                n_heads=16)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: small)
    monkeypatch.setattr(dryrun, "SHAPES", {
        k: dataclasses.replace(v, seq_len=32) for k, v in SHAPES.items()})
    shapes = [s for s in SHAPES if cell_is_live("rwkv6-1.6b", s)]
    assert shapes == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    with tempfile.TemporaryDirectory() as out:
        for shape in shapes:
            dryrun.main(["--arch", "rwkv6-1.6b", "--shape", shape,
                         "--device", "cpu", "--out", out])
            res = json.load(open(os.path.join(
                out, f"rwkv6-1.6b__{shape}__pod_16x16.json")))
            assert res["tensor_parallel"] and res["tp"] == 16, shape
            assert res["tp_gathered"] == [], shape
            assert res["collectives_bytes_per_device"]["all-reduce"] > 0


def test_gathered_decode_cell_splits_its_cache_on_time():
    """Reduced Qwen1.5 with 3 heads, which do not split over 2 ``model``
    ranks, in a decode cell on a fake 1 × 2 world (fake CPU tensors): the
    attention is named gathered, the full-attention KV cache is split on
    time (``kv_split_on_time``), its bytes a rank exactly half of the
    unsplit layout's, and the traced step's peak lower than at one
    rank."""
    from repro_torch.launch.mesh import make_test_mesh
    cfg = dataclasses.replace(reduced_config(REGISTRY["qwen1.5-4b"]),
                              n_heads=3, n_kv=3, head_dim=16)
    shape = ShapeConfig("d", "decode", 64, 4)
    with dryrun.fake_world(2):
        mesh = make_test_mesh(1, 2, device="cpu")
        split = dryrun.trace_cell(cfg, shape, mesh, dev="cpu")
        whole = dryrun.trace_cell(cfg, shape, None, dev="cpu")
        nbytes = {}
        for name, m in (("split", mesh), ("whole", None)):
            with dryrun.fake_mode():
                model = Transformer(cfg, device="cpu", mesh=m)
                cache = model.init_cache(4, 64)
                nbytes[name] = sum(t.numel() * t.element_size()
                                   for t in cache.values())
                assert cache["k"].shape[2] == (32 if m else 64)
    assert split["kv_split_on_time"] and not whole["kv_split_on_time"]
    assert split["tp_gathered"] and split["tp"] == 2
    assert 2 * nbytes["split"] == nbytes["whole"] > 0
    assert split["peak"]["Total"] < whole["peak"]["Total"]
    assert {op for op, _ in split["records"]} == {"all-reduce",
                                                  "all-gather"}


def test_seq_shard_train_cell_takes_effect():
    """Reduced granite (remat) in a training cell on a fake 1 × 2 world,
    with and without ``seq_shard``: the flag takes effect
    (``seq_shard_effect``), the activation bytes at the peak fall (the
    remat-saved block inputs hold T / 2 rows), and the step all-gathers
    and reduce-scatters T where it all-reduced."""
    from repro_torch.launch.mesh import make_test_mesh
    cfg = dataclasses.replace(reduced_config(REGISTRY["granite-3-8b"]),
                              remat=True)
    shape = ShapeConfig("t", "train", 64, 8)
    res = {}
    with dryrun.fake_world(2):
        mesh = make_test_mesh(1, 2, device="cpu")
        for seq in (False, True):
            res[seq] = dryrun.trace_cell(
                dataclasses.replace(cfg, seq_shard=seq), shape, mesh,
                dev="cpu", accum=2)
    assert res[True]["seq_shard_effect"] and not res[False]["seq_shard_effect"]
    assert res[True]["peak"]["Activation"] < res[False]["peak"]["Activation"]
    assert {op for op, _ in res[False]["records"]} == {"all-reduce"}
    assert {"all-gather", "reduce-scatter"} <= {
        op for op, _ in res[True]["records"]}


#: the KV group's size of each arch with attention on 16 model ranks
KV_GROUPS = {"internvl2-2b": 2, "whisper-tiny": 16, "phi3-mini-3.8b": 1,
             "qwen1.5-4b": 16, "granite-3-8b": 2, "command-r-plus-104b": 2,
             "recurrentgemma-9b": 16, "llama4-maverick-400b-a17b": 16,
             "phi3.5-moe-42b-a6.6b": 2}


def test_decode_cells_hold_repro_cache_share():
    """Every live decode cell on ``pod_16x16`` (fake group of 256, the
    model split on ``meta``): a rank's KV cache bytes (full attention and
    rings) equal ``repro``'s ``cache_pspec`` share, sanitized on an
    ``AbstractMesh((16, 16))`` (its KV leaves' bytes over the mesh axes
    that shard them), and a KV cache splits on time wherever the KV group
    has more than one rank."""
    from repro_torch.launch.mesh import make_production_mesh
    amesh = AbstractMesh((16, 16), ("data", "model"))
    cells = [(a, s) for a in sorted(REGISTRY) for s in ("decode_32k",
                                                         "long_500k")
             if cell_is_live(a, s)]
    got, want = {}, {}
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        for arch, name in cells:
            shape = SHAPES[name]
            cfg = dryrun.cell_config(arch, shape)
            model = Transformer(cfg, device="meta", mesh=mesh)
            assert model.kv_tp.size == KV_GROUPS.get(arch, 1), arch
            assert model.kv_split_on_time(shape.seq_len) == (
                model.kv_tp.size > 1), (arch, name)
            b = dryrun._rows(shape.global_batch, 16)
            got[arch, name] = dryrun.kv_cache_bytes(
                model.init_cache(b, shape.seq_len))
            jmodel = jax_build(JAX_REGISTRY[arch])
            jcache = jax.eval_shape(lambda: jmodel.init_cache(
                shape.global_batch, shape.seq_len))
            total = 0
            for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
                if path[-1].key not in ("k", "v", "k_s", "v_s"):
                    continue
                spec = jrules.sanitize_pspec(
                    amesh, jrules.cache_pspec(amesh, leaf), leaf.shape)
                div = 1
                for axes in spec:
                    for a in (axes if isinstance(axes, tuple) else (axes,)):
                        div *= amesh.shape.get(a, 1) if a else 1
                total += leaf.size * leaf.dtype.itemsize // div
            want[arch, name] = total
    assert got == want
    assert all(v > 0 for (a, _), v in got.items() if a in KV_GROUPS)
