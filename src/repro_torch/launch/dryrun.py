"""Dry run of the port: trace one (arch × shape × mesh) cell's step on
fake tensors and report what one rank needs, before any hardware is asked
for (``repro.launch.dryrun``).

Nothing is allocated and nothing is launched.  A fake process group of the
mesh's size (256, or 512 for ``--multi-pod``) stands for the cluster, this
process as rank 0; inside a ``FakeTensorMode`` the full-width model is
built and its state placed as the sharding rules say (rank 0 holds the
largest shards), and the port's real step runs once on fake tensors:

* ``train``: ``make_train_step(..., mesh=, fsdp=, accum_dtype=)`` with
  AdamW (bf16 moments for :data:`BF16_OPT`), on this rank's rows of the
  global batch;
* ``prefill``: ``forward`` to the last position's fp32 logits;
* ``decode``: ``decode_step`` at position T - 1 over a cache of T
  positions (Whisper with a zero ``enc_out``, as in ``repro``).

The step runs under ``torch.distributed._tools.mem_tracker.MemTracker``,
:class:`~repro_torch.roofline.CostCounter` and
:class:`~repro_torch.roofline.CommRecorder`.  The kernels are custom
operators whose fake rules allocate what their launches allocate on the
card (:mod:`repro_torch.kernels.fake`).

The step is the port's sharded one: the model is built split over the
mesh's ``model`` axis (``Transformer(cfg, mesh=)``), so each rank holds
and computes its share of the attention heads, the dense SwiGLU's hidden
units, the RG-LRU channels, RWKV-6's heads and hidden units, the MoE
experts and the vocabulary, and the
fake rules of the kernels see the local shapes; every parameter is held
as this rank's rule shard and gathered a unit at a time
(``Transformer.zero3_``: the trainer's on its FSDP axes, and the same for
a prefill or decode cell), so the ``Parameter`` bytes at the peak are the
shards plus the unit gathered then.  Two facts are recorded in each
result rather than hidden:

* ``"tensor_parallel"``: true when every block of the model is split (or
  replicated by ``repro``'s rules, as the block-sparse FFN is);
  ``"tp_gathered"`` names what still computes on full tensors on every
  rank along ``model``: the MoE router (its top-k reads every expert's
  logit), the modality frontend, and an attention whose heads do not
  split over the 16 ranks (Whisper's 6, Qwen1.5's 20, Maverick's 40).
  Prefill and decode cells split the batch and the cache over the dp
  axes; RWKV-6's wkv state holds each rank's 2 of 32 heads.  A decode
  cell's KV caches (full attention and the rings of ``local`` layers)
  hold the KV heads each rank's query heads read, their time axis split
  over the ranks that hold the same KV heads (``Transformer.kv_tp``):
  all 16 where the attention runs whole on every rank, the two that
  share one of 8 KV heads for granite, command-r-plus, Phi-3.5-MoE and
  InternVL2-2B, all 16 for RecurrentGemma-9B's one KV head (its 2048
  ring slots, 128 a rank), none for Phi-3-mini's 32 (each rank owns
  two).  So a rank holds exactly ``repro``'s ``cache_pspec`` share
  (``"kv_split_on_time"``, ``"kv_cache_bytes"``); the decode step's
  all-reduces over those groups are recorded at their bytes.
* ``"seq_shard_effect"``: true where ``seq_shard`` (:data:`CELL_OVERRIDES`)
  split the residual stream's T over ``model`` between blocks
  (``Transformer.seq_parallel``; a training or prefill cell).

Two of ``repro``'s keys are absent: ``cpu_artifact_bytes`` and
``fit_bytes_tpu`` (the correction for XLA-CPU's fp32 copies of a bf16
cache: no XLA compile happens here), and ``roofline_corrected`` /
``m_trips`` (XLA counts a loop body once; an eager trace counts every
layer and every microbatch, so the trip-count correction is 1).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --device cpu   # fake CPU tensors
Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.api import clear_plan_cache
from repro_torch.configs import REGISTRY, SHAPES, cell_is_live, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import input_specs
from repro_torch.models.transformer import Transformer, act_dtype
from repro_torch.optim import AdamW, constant
from repro_torch.roofline import (H100_SXM, CommRecorder, CostCounter,
                                  collective_bytes, model_flops,
                                  roofline_terms)
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.sharding import dp_axes

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# repro's per-arch tables: grad-accumulation microbatches, bf16 optimizer
# state and accumulation for the largest models, cross-pod ZeRO for the
# state-dominated giant, per-arch model overrides
TRAIN_ACCUM = {
    "internvl2-2b": 2, "whisper-tiny": 1, "phi3-mini-3.8b": 4,
    "qwen1.5-4b": 4, "granite-3-8b": 8, "command-r-plus-104b": 16,
    "recurrentgemma-9b": 4, "llama4-maverick-400b-a17b": 16,
    "phi3.5-moe-42b-a6.6b": 8, "rwkv6-1.6b": 2,
}
BF16_OPT = {"command-r-plus-104b", "llama4-maverick-400b-a17b"}
BF16_ACCUM = {"llama4-maverick-400b-a17b"}
CROSS_POD_FSDP = {"llama4-maverick-400b-a17b"}
CELL_OVERRIDES = {
    "command-r-plus-104b": {"seq_shard": True},
}
# cells whose per-rank peak exceeds the card's memory in the port, with
# what puts them over ((arch, shape, mesh) → why).  None: the step holds
# every parameter as its rule shard, gathers one unit at a time and splits
# the MoE experts over model, and every decode cell holds repro's
# cache_pspec share of its KV caches: the timeline split over the ranks
# that hold the same KV heads (all of model for Qwen1.5's 20 heads,
# Whisper's 6 and Maverick's 40, which run whole on every rank; the two
# ranks of one KV head for 8 KV heads on 16 ranks; every rank for
# RecurrentGemma's one KV head and its rings)
EXPECTED_OVER_HBM: Dict[tuple, str] = {}


def mesh_tag(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks with this process as rank
    0: collectives return at once and move nothing."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_device(device) -> torch.device:
    """``None``: the card's device type (raises without a card, as the
    port's entry points do); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to trace fake CPU tensors")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def fake_mode():
    """The dry run's ``FakeTensorMode``: real tensors made from host arrays
    inside it (a sparse FFN's plan leaves) are taken as constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _category_bytes(snapshot) -> Dict[str, int]:
    """A MemTracker snapshot summed over devices, by category name."""
    out: Dict[str, int] = {}
    for dev_snap in snapshot.values():
        for key, val in dev_snap.items():
            name = getattr(key, "value", key)
            out[name] = out.get(name, 0) + int(val)
    return out


def _step_tracker():
    """A ``MemTracker`` for one training step: the model's forward runs
    once a microbatch, which ``MemTracker`` takes for a second iteration
    and refuses, so its per-module statistics (which the dry run does not
    read) are cleared when the root module starts again; and its peak is
    kept for the whole process only (the per-module peaks cost a pass over
    every module at every operator)."""
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType

    class StepTracker(MemTracker):
        def track_optimizer_state(self, tensors):
            """The port's AdamW moments under ``Optstate`` (it is not a
            ``torch.optim.Optimizer``, which ``track_external`` expects)."""
            for t in tensors:
                self._update_and_maybe_create_winfos(t, _MemRefType.OPT)

        def track_params(self, tensors):
            """A sharded model's master shards under ``Parameter``."""
            for t in tensors:
                self._update_and_maybe_create_winfos(t, _MemRefType.PARAM)

        def _update_and_maybe_create_winfos(self, t, reftype,
                                            update_existing=False):
            # a sharded model's gradient hook takes ``p.grad`` (reduced
            # into its shard) before MemTracker's post-accumulate hook
            # reads it
            if t is None:
                return set()
            return super()._update_and_maybe_create_winfos(
                t, reftype, update_existing)

        def _pre_fw_hook(self, module, inputs):
            name = self._mod_tracker.get_known_fqn(module)
            if (module in self.memory_tracking and not self._mod_tracker.is_bw
                    and set(self._mod_tracker.parents) - {name}
                    == {"Global"}):
                self.reset_mod_stats()
            super()._pre_fw_hook(module, inputs)

        def _update_peak_stats(self, peak_state):
            for dev, snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < snap["Total"]:
                    self._peak_mem[dev] = snap["Total"]
                    self._peak_mem_snap[dev] = dict(snap)

    return StepTracker()


def plan_tensors(model) -> list:
    """The device tensors of the model's Segment plans that are not its
    parameters: the schedule leaves of every plan and grad plan, and the
    blocks the plans were built with (one set a shared pattern)."""
    from repro_torch.models.sparse_ffn import SparseLinear
    seen, out = set(), []
    params = {id(p) for p in model.parameters()}
    plans = [m.plan for m in model.modules() if isinstance(m, SparseLinear)]
    plans += [p.grad_plan for p in plans if p.grad_plan is not None]
    for plan in plans:
        for v in vars(plan).values():
            if (isinstance(v, torch.Tensor) and id(v) not in seen
                    and id(v) not in params):
                seen.add(id(v))
                out.append(v)
    return out


def measure(fn: Callable[[], object], external: Iterable,
            optimizer_state: Iterable = (), model=None) -> dict:
    """Run ``fn()`` once under ``MemTracker`` (``external``: the modules and
    tensors that exist before it; ``optimizer_state``: the AdamW moments),
    :class:`CostCounter` and :class:`CommRecorder`.  Returns the resident
    bytes at the start (``argument``) and the peak, by MemTracker category,
    FLOPs, bytes, the collectives' records and the host seconds the trace
    took; with ``model``, also ``marks``: the counters ``(flops, bytes,
    records)`` each time its forward starts (once a microbatch)."""
    mt = _step_tracker()
    mt.track_external(*external)
    for obj in external:
        if getattr(obj, "zero3", None) is not None:
            mt.track_params(obj.zero3.master.values())
    mt.track_optimizer_state(optimizer_state)
    cost, comm = CostCounter(), CommRecorder()
    marks = []
    hook = None if model is None else model.register_forward_pre_hook(
        lambda *_: marks.append((cost.flops, cost.bytes, len(comm.records))))
    t0 = time.perf_counter()
    try:
        with mt:
            start = _category_bytes(mt.get_tracker_snapshot("current"))
            with cost, comm:
                fn()
    finally:
        if hook is not None:
            hook.remove()
    peak = _category_bytes(mt.get_tracker_snapshot("peak"))
    return {"argument": start, "peak": peak, "flops": cost.flops,
            "bytes": cost.bytes, "records": comm.records, "marks": marks,
            "trace_s": time.perf_counter() - t0}


#: training steps of more microbatches than this are traced with this
#: many (of the same size) and the rest added from the last one traced
TRACED_MICROBATCHES = 2


def unfold(res: dict, accum: int) -> dict:
    """A trace of :data:`TRACED_MICROBATCHES` microbatches (over the whole
    batch, which is resident) extended to ``accum``: every microbatch runs
    the same operators (the gradient buffer is made before the first), so
    the second one's FLOPs, bytes and collectives (between the two forward
    starts in ``marks``) are added ``accum - 2`` more times, and the peak,
    which every microbatch reaches alike, stays."""
    (f1, b1, r1), (f2, b2, r2) = res["marks"][:2]
    extra = accum - TRACED_MICROBATCHES
    return dict(res, flops=res["flops"] + extra * (f2 - f1),
                bytes=res["bytes"] + extra * (b2 - b1),
                records=res["records"] + extra * res["records"][r1:r2],
                microbatches_traced=TRACED_MICROBATCHES)


def _rows(n: int, dp: int) -> int:
    """This rank's rows of ``n``: split over dp where it divides, else all
    (the rules replicate a dim the mesh does not divide)."""
    return n // dp if n % dp == 0 else n


def train_accum(arch: str, shape: ShapeConfig, dp_total: int,
                accum_override: Optional[int] = None) -> int:
    """``repro``'s accumulation: the arch's table value, halved until each
    microbatch splits evenly over the dp ranks."""
    accum = accum_override or TRAIN_ACCUM.get(arch, 4)
    while accum > 1 and (shape.global_batch // accum) % dp_total != 0:
        accum //= 2
    return accum


def cell_config(arch: str, shape: ShapeConfig,
                overrides: Optional[dict] = None) -> ModelConfig:
    merged = dict(CELL_OVERRIDES.get(arch, {}))
    if shape.kind != "train":
        merged["seq_shard"] = False
    merged.update(overrides or {})
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **merged) if merged else cfg


def kv_cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    """The bytes of a decode cache's KV entries (full attention and rings,
    values and int8 scales) on this rank."""
    return sum(t.numel() * t.element_size() for k, t in cache.items()
               if k.split("_")[0] in ("k", "v"))


def make_step(cfg: ModelConfig, shape: ShapeConfig, model, mesh, dp: int,
              *, accum: int, fsdp="data", dev,
              traced: Optional[int] = None) -> tuple:
    """``(fn, external, optimizer_state)``: the cell's step on this rank's
    inputs (uninitialized tensors of the input specs' shapes on ``dev``:
    fake inside a ``FakeTensorMode``), and the state that exists before
    it.  With ``traced`` the whole batch is made but the step runs on its
    first ``traced`` microbatches."""
    specs = input_specs(cfg, shape, device=dev)
    plans = plan_tensors(model)
    if shape.kind == "train":
        opt = AdamW(lr=constant(3e-4), state_dtype=(
            torch.bfloat16 if cfg.name in BF16_OPT else torch.float32))
        traced = traced or accum
        step = make_train_step(
            model, opt, traced, mesh=mesh, fsdp=fsdp,
            accum_dtype=(torch.bfloat16 if cfg.name in BF16_ACCUM
                         else torch.float32))
        state = opt.init(step.master)
        batch = {k: torch.empty((shape.global_batch // dp, *v.shape[1:]),
                                dtype=v.dtype, device=dev)
                 for k, v in specs.items()}
        rows = shape.global_batch // dp // accum * traced
        return (lambda: step(state, {k: v[:rows] for k, v in batch.items()}),
                [model, *plans, *batch.values()],
                [*state.m.values(), *state.v.values()])
    b = _rows(shape.global_batch, dp)
    if shape.kind == "prefill":
        batch = {k: torch.empty((b, *v.shape[1:]), dtype=v.dtype, device=dev)
                 for k, v in specs.items()}

        @torch.no_grad()
        def prefill():
            logits = model(batch["tokens"], batch.get("vis_embeds"),
                           batch.get("enc_embeds"))
            return logits[:, -1].float()
        return prefill, [model, *plans, *batch.values()], []
    cache = model.init_cache(b, shape.seq_len)
    token = torch.empty((b, 1), dtype=torch.int32, device=dev)
    enc = (torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=act_dtype(cfg), device=dev)
           if cfg.family == "enc_dec" else None)

    @torch.no_grad()
    def decode():
        return model.decode_step(cache, token, shape.seq_len - 1,
                                 enc_out=enc)[0]
    return decode, [model, *plans, *cache.values(), token,
                    *([] if enc is None else [enc])], []


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, dev,
               accum: int = 1, fsdp="data",
               serve_params_dtype: Optional[torch.dtype] = None) -> dict:
    """Build ``cfg``'s model on fake tensors of ``dev`` and measure one
    step of ``shape``'s kind on this rank of ``mesh`` (``None``: one rank,
    the plain trainer).  A training step of more than
    :data:`TRACED_MICROBATCHES` microbatches is traced with that many, of
    the same size, and extended (:func:`unfold`): the result is the same,
    at a fraction of the host time."""
    dp = (math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                    for a in dp_axes(mesh)) if mesh is not None else 1)
    fold = shape.kind == "train" and accum > TRACED_MICROBATCHES
    traced = TRACED_MICROBATCHES if fold else accum
    try:
        with fake_mode():
            model = Transformer(cfg, device=dev, mesh=mesh)
            if serve_params_dtype is not None and shape.kind != "train":
                model.to(serve_params_dtype)
            if mesh is not None and shape.kind != "train":
                # serving holds the parameters sharded too (the trainer
                # shards them on its FSDP axes itself)
                model.zero3_(mesh, fsdp)
            fn, external, opt = make_step(cfg, shape, model, mesh, dp,
                                          accum=accum, fsdp=fsdp, dev=dev,
                                          traced=traced)
            res = measure(fn, external, opt, model=model)
            if shape.kind == "decode":
                res["kv_cache_bytes"] = kv_cache_bytes(model.init_cache(
                    _rows(shape.global_batch, dp), shape.seq_len))
    finally:
        clear_plan_cache()
    specs = input_specs(cfg, shape)
    t = sum(specs[k].shape[1] for k in ("tokens", "vis_embeds")
            if k in specs)
    res["seq_shard_effect"] = (shape.kind != "decode"
                               and model.seq_parallel(t).on)
    res["kv_split_on_time"] = (shape.kind == "decode"
                               and model.kv_split_on_time(shape.seq_len))
    if fold:
        res = unfold(res, accum)
    res["dp"] = dp
    res["tp"] = model.tp.size
    res["tp_gathered"] = sorted({f"{name.split('.')[-1]}: {why}" for name, why
                                 in model.tp_gathered.items()})
    return res


#: an ``ssm`` cell longer than the last of these is traced at 1 and 2
#: layers over sequences of these lengths and extended to its depth and
#: length (:func:`trace_folded`)
FOLD_SEQ = (64, 128, 192)


def host_loop(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """True for a cell whose blocks loop over time on the host: RWKV-6's
    wkv recurrence is a torch loop over T (no kernel in either package),
    ~100 operators a step and layer in training, too many to trace at
    published depth and length in minutes."""
    return (cfg.family == "ssm" and shape.kind != "decode"
            and shape.seq_len > FOLD_SEQ[-1])


def _extend(x, dl: int, k: int, quadratic: bool = True):
    """``x[l][j]``, traced at 1 + l layers and the j-th of
    :data:`FOLD_SEQ`, at ``1 + dl`` layers and ``k`` length steps past the
    first, in integer arithmetic: linear in the layers; in the length
    quadratic through the three lengths (``quadratic``: the eager backward
    of a loop over T writes a (B, T, ...) gradient for each of its T
    slices) or linear through the last two (what is resident at once grows
    with T, one step's state at a time)."""
    def at(row):
        if not quadratic:
            return row[2] + (k - 2) * (row[2] - row[1])
        d1, d2 = row[1] - row[0], row[2] - 2 * row[1] + row[0]
        return row[0] + k * d1 + k * (k - 1) // 2 * d2
    one, two = at(x[0]), at(x[1])
    return one + dl * (two - one)


def trace_folded(cfg: ModelConfig, shape: ShapeConfig, mesh, *, dev,
                 accum: int = 1, fsdp="data", **kw) -> dict:
    """:func:`trace_cell` of a cell with no attention (``ssm``) at 1 and 2
    layers over the :data:`FOLD_SEQ` lengths, extended to ``cfg``'s depth
    and ``shape``'s length (:func:`_extend`).  Every layer adds the same
    operators, and every operator of such a step costs a fixed amount or
    one growing with T or T², so FLOPs, bytes and collective bytes are
    extended exactly.  The peak (and what is resident at the start), by
    category, is extended linearly from the two longer lengths: once the
    step's largest point stays the same, what it holds grows with T one
    step's tensors at a time.  That extension is not proved for the
    published length: ``peak_extrapolated`` marks it
    (``tests/test_torch_dryrun.py`` holds every category exact against a
    direct trace at a larger size in training).  The length must be the
    first plus a whole number of steps between the lengths."""
    t1, t2, t3 = FOLD_SEQ
    step = t2 - t1
    k, rem = divmod(shape.seq_len - t1, step)
    if rem or t3 - t2 != step:
        raise ValueError(f"seq_len {shape.seq_len} is not {t1} plus a "
                         f"multiple of {step}")
    rows = []
    t0 = time.perf_counter()
    for n_layers in (1, 2):
        row = []
        for t in FOLD_SEQ:
            res = trace_cell(dataclasses.replace(cfg, n_layers=n_layers),
                             dataclasses.replace(shape, seq_len=t), mesh,
                             dev=dev, accum=accum, fsdp=fsdp, **kw)
            res["collectives"] = collective_bytes(res["records"])
            row.append(res)
        rows.append(row)
    dl = cfg.n_layers - 1

    def ext(key, name=None, quadratic=True):
        def get(r):
            return r[key] if name is None else r[key].get(name, 0)
        return _extend([[get(r) for r in row] for row in rows], dl, k,
                       quadratic)

    def ext_dict(key, quadratic):
        names = sorted(set().union(*(r[key] for row in rows for r in row)))
        return {n: ext(key, n, quadratic) for n in names}

    out = dict(rows[0][0], flops=ext("flops"), bytes=ext("bytes"),
               peak=ext_dict("peak", False),
               argument=ext_dict("argument", False),
               collectives=ext_dict("collectives", True),
               peak_extrapolated=True,
               traced={"layers": [1, 2], "seq_len": list(FOLD_SEQ)},
               trace_s=time.perf_counter() - t0)
    for key in ("records", "marks"):
        out.pop(key, None)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = ART_DIR, overrides: Optional[dict] = None,
             serve_params_dtype=None, fsdp_override=None,
             accum_override: Optional[int] = None, tag: str = "", *,
             device=None, hbm_bytes: Optional[int] = None) -> dict:
    """Trace one cell on a fake mesh and write its JSON (``repro``'s
    levers: ``serve_params_dtype`` for serving cells, ``fsdp_override``,
    ``accum_override``, model ``overrides``).  ``device``: ``None`` traces
    fake tensors of the card's type (raises without a card), ``"cpu"``
    fake CPU tensors.  ``fit`` compares the peak with the card's memory:
    the card's own where there is one, else ``hbm_bytes`` (default
    :data:`~repro_torch.roofline.H100_SXM`'s)."""
    dev = trace_device(device)
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape, overrides)
    if hbm_bytes is None:
        hbm_bytes = (torch.cuda.get_device_properties(dev).total_memory
                     if dev.type == "cuda" and torch.cuda.is_available()
                     else H100_SXM.hbm_bytes)
    fsdp = ("data", "pod") if arch in CROSS_POD_FSDP else "data"
    if fsdp_override is not None:
        fsdp = fsdp_override
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        dp_total = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                             for a in dp_axes(mesh))
        accum = (train_accum(arch, shape, dp_total, accum_override)
                 if shape.kind == "train" else 1)
        trace = trace_folded if host_loop(cfg, shape) else trace_cell
        res = trace(cfg, shape, mesh, dev=dev, accum=accum, fsdp=fsdp,
                    serve_params_dtype=serve_params_dtype)
    coll = (res["collectives"] if "collectives" in res
            else collective_bytes(res["records"]))
    flops_dev, bytes_dev = float(res["flops"]), float(res["bytes"])
    terms = roofline_terms(flops_dev * chips, bytes_dev * chips,
                           float(sum(coll.values())) * chips, chips)
    mf = model_flops(cfg, shape)
    peak = res["peak"].get("Total", 0)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod),
        "chips": chips, "ok": True, "device": dev.type,
        "trace_s": round(res["trace_s"], 1), "accum": accum,
        "fsdp": fsdp if isinstance(fsdp, str) else list(fsdp),
        "tensor_parallel": res["tp"] > 1 and not res["tp_gathered"],
        "tp": res["tp"], "tp_gathered": res["tp_gathered"],
        "seq_shard": cfg.seq_shard,
        "seq_shard_effect": res["seq_shard_effect"],
        "kv_split_on_time": res["kv_split_on_time"],
        "kv_cache_bytes": res.get("kv_cache_bytes"),
        "traced": dict(res.get("traced", {}), microbatches=res.get(
            "microbatches_traced", accum)),
        "memory": {"argument_bytes": res["argument"].get("Total", 0),
                   "peak_bytes": peak, "fit_bytes": peak,
                   "peak_by_category": res["peak"],
                   "argument_by_category": res["argument"],
                   "peak_extrapolated": res.get("peak_extrapolated", False),
                   "hbm_bytes": int(hbm_bytes)},
        "fit": peak <= hbm_bytes,
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives_bytes_per_device": coll,
        "roofline": terms,
        "model_flops": mf,
        "useful_flops_ratio": (mf / (flops_dev * chips)
                               if flops_dev > 0 else None),
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_tag(multi_pod)}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def summary(res: dict) -> str:
    mem = res["memory"]
    cats = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                     mem["peak_by_category"].items() if k != "Total" and v)
    terms = res["roofline"]
    return (f"{res['arch']} {res['shape']} {res['mesh']}: peak "
            f"{mem['peak_bytes'] / 1e9:.2f} GB a rank ({cats}), fit "
            f"{res['fit']}; flops/dev {res['cost']['flops_per_device']:.4g},"
            f" bytes/dev {res['cost']['bytes_per_device']:.4g}, collectives "
            f"{res['collectives_bytes_per_device']}; dominant "
            f"{terms['dominant']} {terms['bound_s']:.4g} s; useful "
            f"{res['useful_flops_ratio']:.4g}; tensor parallel "
            f"{res['tensor_parallel']} (tp {res['tp']}"
            + (f", gathered: {'; '.join(res['tp_gathered'])}"
               if res["tp_gathered"] else "")
            + f"); seq_shard_effect {res['seq_shard_effect']}, "
            f"kv_split_on_time {res['kv_split_on_time']}"
            + ("" if res.get("kv_cache_bytes") is None else
               f", KV cache {res['kv_cache_bytes'] / 1e9:.4f} GB a rank")
            + f"; traced in {res['trace_s']} s")


def over_hbm(res: dict) -> Optional[str]:
    """``None`` when the cell fits; else ``"expected"`` (in
    :data:`EXPECTED_OVER_HBM`) or ``"unexpected"``."""
    if res["fit"]:
        return None
    key = (res["arch"], res["shape"], res["mesh"])
    return "expected" if key in EXPECTED_OVER_HBM else "unexpected"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(REGISTRY))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every live cell on the mesh (--multi-pod: the "
                         "2 x 16 x 16 one)")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--device", default=None,
                    help="default: fake tensors of the card (needs one); "
                         "cpu: fake CPU tensors")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in REGISTRY for s in SHAPES
                 if cell_is_live(a, s)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    failures, unexpected = [], []
    for arch, shape in cells:
        tag = f"{arch} × {shape} × {mesh_tag(args.multi_pod)}"
        try:
            res = run_cell(arch, shape, args.multi_pod, args.out,
                           device=args.device)
        except Exception:
            traceback.print_exc()
            print(f"FAIL {tag}", flush=True)
            failures.append(tag)
            continue
        print(("PASS " if args.all else "") + summary(res), flush=True)
        over = over_hbm(res)
        if over == "expected":
            print(f"NOTE: {tag} exceeds the card's memory as expected: "
                  f"{EXPECTED_OVER_HBM[(arch, shape, res['mesh'])]}")
        elif over == "unexpected":
            print(f"WARNING: {tag} exceeds the card's "
                  f"{res['memory']['hbm_bytes'] / 1e9:.2f} GB "
                  f"({res['memory']['peak_bytes'] / 1e9:.2f} GB a rank)")
            unexpected.append(tag)
    if failures:
        print(f"\n{len(failures)} FAILURES:", *failures, sep="\n  ")
        sys.exit(1)
    if unexpected:
        print(f"\n{len(unexpected)} cells over the card's memory and not in "
              f"EXPECTED_OVER_HBM:", *unexpected, sep="\n  ")
        sys.exit(2)
    if args.all:
        print("\nALL DRY-RUN CELLS PASS")


if __name__ == "__main__":
    main()
