"""Training runtime of the port: train step with gradient accumulation,
AdamW, checkpoints and crash → resume, on one GPU or sharded over a mesh.

The counterpart of ``repro.runtime.train_loop``:

    state = (fp32 parameters, AdamW m/v, step)
    step:  for each of ``accum_steps`` microbatches: loss, backward, add
           grad / accum_steps to an ``accum_dtype`` buffer → clip → AdamW

The state is updated in place (the model's parameters and the optimizer's
moments).  The data pipeline is a pure function of the step, so a restart
from the latest checkpoint replays exactly the batches it would have seen.
``failure_hook`` lets tests inject a crash after a chosen step.  A trainer
with a checkpoint directory always resumes from its latest checkpoint
(``repro``'s ``resume="auto"``), so :class:`TrainerConfig` has no
``resume``.

**On a mesh** (``mesh=``, a ``DeviceMesh`` with ``data`` and ``model``
axes, one process a device): the model is split tensor parallel over
``model`` (``Transformer.shard_``): each attention runs this rank's heads,
each dense SwiGLU its hidden units, each RG-LRU block its channels, each
RWKV-6 block its heads and hidden units, each MoE layer its experts (the
router whole), the embedding and head its rows of the vocabulary, with
the all-reduces and all-gathers of
:mod:`repro_torch.sharding.tensor_parallel` between them.  The MoE
router and the frontend still compute on full tensors on every rank
along ``model`` (``Transformer.tp_gathered``), and the
block-sparse FFN is replicated, as ``repro``'s rules replicate its
blocks.  Every parameter lives as this rank's shard of
``repro_torch.sharding``'s rules (``Transformer.zero3_``): the shards are
the master parameters AdamW updates, beside AdamW's moments in the same
layout, and each unit of the model (a layer, the embedding with the head
and the final norm, the frontend) gathers its parameters just before it
runs and frees them after (:mod:`repro_torch.sharding.zero3`).  Each dp
rank computes its rows of each microbatch (microbatch *i* is rows
``[i·B/accum, (i+1)·B/accum)``, split over dp, as ``repro`` splits it).
Each parameter's gradient is reduce-scattered (mean over dp) into its
shard as soon as autograd has accumulated it and summed over the
microbatches there; the clip's global norm counts each element once over
``model`` and dp, and AdamW runs on the shards.  At one rank on ``model``
nothing is split, and at one rank every shard is the parameter itself.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.optim import AdamW, AdamWState, cosine_with_warmup
from repro_torch.runtime.elastic import restore_onto_mesh
from repro_torch.sharding import dp_axes, global_norm


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 10
    accum_steps: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10


class TrainStep:
    """``step(opt_state, batch) → metrics``, which updates the model's
    parameters and ``opt_state`` in place (see :func:`make_train_step`).

    ``master``: the tensors AdamW updates (and ``opt_state`` must be built
    over): the model's parameters, or on a mesh this rank's shards of them
    (``Transformer.zero3_``); ``shardings``: each parameter's ``Sharding``,
    or ``None``."""

    def __init__(self, model, opt: AdamW, accum_steps: int,
                 accum_dtype: torch.dtype, mesh, fsdp="data"):
        self.model, self.opt = model, opt
        self.accum_steps, self.accum_dtype = accum_steps, accum_dtype
        self.mesh = mesh
        self.zero3 = None
        if mesh is None:
            self.shardings = None
            self.master = dict(model.named_parameters())
        else:
            model.shard_(mesh)
            self.zero3 = model.zero3_(mesh, fsdp)
            self.shardings = self.zero3.shardings
            self.master = self.zero3.master

    def _backward(self, loss: torch.Tensor, sink) -> None:
        """Backward of ``loss``; each parameter's gradient, in the master
        layout (on a mesh reduce-scattered as it is accumulated), to
        ``sink(name, grad)``."""
        if self.zero3 is None:
            loss.backward()
            for k, p in self.master.items():
                g, p.grad = p.grad, None
                sink(k, g)
            return
        self.zero3.on_grad = sink
        try:
            loss.backward()
        finally:
            self.zero3.on_grad = None
            self.zero3.after_backward()

    def __call__(self, opt_state: AdamWState,
                 batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        accum = self.accum_steps
        grads: Dict[str, torch.Tensor] = {}
        if accum > 1:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=self.accum_dtype,
                                    device=p.device)
                     for k, p in self.master.items()}

            def add(k, g):
                grads[k].copy_(grads[k].float() + g.float() / accum)
            loss = torch.zeros((), device=self.model.device)
            for i in range(accum):
                mb_loss, _ = self.model.loss_fn(
                    {k: v[i] for k, v in micro.items()})
                self._backward(mb_loss, add)
                loss = loss + mb_loss.detach()
            loss = loss / accum
        else:
            loss, _ = self.model.loss_fn(batch)
            self._backward(loss, grads.__setitem__)
            loss = loss.detach()
        missing = set(self.master) - set(grads)
        if missing:
            raise RuntimeError(f"no gradient reached {sorted(missing)}")
        grads = {k: grads[k] for k in self.master}
        gnorm = None
        if self.mesh is not None:
            loss = _dp_mean(loss, self.mesh)
            gnorm = global_norm(grads, self.shardings)
        metrics = self.opt.update(grads, opt_state, self.master,
                                  grad_norm=gnorm)
        return {"loss": loss, **metrics}


class FullParams(Mapping):
    """The model's parameters by name as full tensors: on a mesh each one
    all-gathered from every rank's shard at each read (a collective:
    every rank of the mesh reads the same names in the same order); the
    parameters themselves without one."""

    def __init__(self, step: TrainStep):
        self._step = step

    def __getitem__(self, name: str) -> torch.Tensor:
        step = self._step
        if step.zero3 is None:
            return step.master[name]
        return step.zero3.full(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._step.master)

    def __len__(self) -> int:
        return len(self._step.master)


def _dp_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the mesh's dp axes."""
    t, n = t.clone(), 1
    for i, axis in enumerate(mesh.mesh_dim_names):
        if axis in dp_axes(mesh) and mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
            n *= mesh.size(i)
    return t / n


def make_train_step(model, opt: AdamW, accum_steps: int,
                    accum_dtype: torch.dtype = torch.float32, mesh=None,
                    fsdp="data") -> TrainStep:
    """Build ``step(opt_state, batch) → metrics``, which updates the
    model's parameters and ``opt_state`` (built over ``step.master``) in
    place.

    With ``accum_steps > 1`` the batch is split into that many microbatches
    along its rows; their gradients are averaged (each divided by
    ``accum_steps`` before it is added) into an ``accum_dtype`` buffer, and
    the step's loss is their mean.  On ``mesh`` the batch is this rank's
    rows (:func:`rank_rows`), the master state is sharded by the rules
    (FSDP on ``fsdp``: ``"data"``, or ``("data", "pod")`` for cross-pod
    ZeRO, as ``repro``'s ``fsdp=``) and the loss is the mean over dp."""
    return TrainStep(model, opt, accum_steps, accum_dtype, mesh, fsdp)


def rank_rows(global_batch: int, accum_steps: int, mesh) -> np.ndarray:
    """This rank's rows of the global batch, microbatch after
    microbatch: microbatch *i* is rows ``[i·B/accum, (i+1)·B/accum)``,
    split in order over the dp ranks (the flattened dp coordinate)."""
    dp = dp_axes(mesh)
    dims = [mesh.mesh_dim_names.index(a) for a in dp]
    n_dp = math.prod(mesh.size(i) for i in dims)
    if global_batch % (accum_steps * n_dp):
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{accum_steps} microbatches over {n_dp} dp ranks")
    coord = mesh.get_coordinate()
    r = 0
    for i in dims:
        r = r * mesh.size(i) + coord[i]
    mb = global_batch // accum_steps
    m = mb // n_dp
    return np.concatenate([np.arange(i * mb + r * m, i * mb + (r + 1) * m)
                           for i in range(accum_steps)])


class Trainer:
    """Trainer on one GPU, or on ``mesh`` (one process a device, tensor
    parallel on ``model``, FSDP on ``fsdp``; see the module docstring):
    splits ``model`` over the mesh, initializes it from ``seed`` (the same
    values as one process draws), builds AdamW
    with ``repro``'s cosine schedule, and resumes from ``tcfg.ckpt_dir``'s
    latest checkpoint when there is one (``repro``'s ``resume="auto"``).
    The model's parameters live on its device; batches are moved there."""

    def __init__(self, model, model_cfg: ModelConfig, shape_cfg: ShapeConfig,
                 tcfg: TrainerConfig, mesh=None, seed: int = 0,
                 fsdp="data"):
        self.model = model
        self.model_cfg = model_cfg
        self.shape_cfg = shape_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = model.device
        self.data = SyntheticDataset(model_cfg, shape_cfg, seed=seed + 1)
        self.opt = AdamW(lr=cosine_with_warmup(tcfg.peak_lr, tcfg.warmup,
                                               tcfg.steps))
        # the step splits the model over the mesh first: init then draws
        # the full tensors and keeps this rank's shards
        self._step_fn = make_train_step(model, self.opt, tcfg.accum_steps,
                                        mesh=mesh, fsdp=fsdp)
        model.init(torch.Generator(device=self.device).manual_seed(seed))
        #: the parameters by name as full tensors (``FullParams``)
        self.params = FullParams(self._step_fn)
        self._rows = (None if mesh is None else
                      rank_rows(shape_cfg.global_batch, tcfg.accum_steps,
                                mesh))
        self.opt_state = self.opt.init(self._step_fn.master)
        self.start_step = 0
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        if self.ckpt:
            latest = self.ckpt.latest_step()
            if latest is not None:
                like = self.state_dict()
                # on a mesh each rank places only its shards on its device
                self.load_state_dict(
                    self.ckpt.restore(latest, like) if mesh is None else
                    restore_onto_mesh(self.ckpt, latest, like, mesh,
                                      fsdp=fsdp))
                self.start_step = latest

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The checkpointed state, keyed by the port's state names; on a
        mesh each entry is a DTensor over this rank's shard."""
        master = self._step_fn.master
        sd = {f"params/{k}": p.detach() for k, p in master.items()}
        sd["opt/step"] = torch.tensor(self.opt_state.step, dtype=torch.int32)
        sd.update({f"opt/m/{k}": t for k, t in self.opt_state.m.items()})
        sd.update({f"opt/v/{k}": t for k, t in self.opt_state.v.items()})
        if self.mesh is None:
            return sd
        sh = self._step_fn.shardings
        rep = (Replicate(),) * self.mesh.ndim

        def wrap(key, t):
            # the rules shard only dims the mesh divides: the global shape
            # is the local one times the mesh along each sharded dim
            name = key.split("/")[-1]
            pl = rep if key == "opt/step" else sh[name].placements
            return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                      run_check=False)
        return {k: wrap(k, t) for k, t in sd.items()}

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a state: a DTensor entry is this rank's shard, a plain
        one the full tensor (sharded here on a mesh)."""
        sh = self._step_fn.shardings

        def local(key, name):
            t = sd[key]
            if isinstance(t, DTensor):
                return t.to_local()
            return t if sh is None else sh[name].shard(t)

        for k, p in self._step_fn.master.items():
            p.copy_(local(f"params/{k}", k))
            self.opt_state.m[k].copy_(local(f"opt/m/{k}", k))
            self.opt_state.v[k].copy_(local(f"opt/v/{k}", k))
        step = sd["opt/step"]
        self.opt_state.step = int(step.to_local() if isinstance(step, DTensor)
                                  else step)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step, shard=self._rows).items()}

    def run(self, failure_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        """Train from ``start_step`` to ``tcfg.steps``.  Logged steps record
        the loss, the pre-clip gradient norm and ``ms``: host time from the
        batch's creation to the read of its metrics, which waits for the
        step's work on the card."""
        history = []
        for step in range(self.start_step, self.tcfg.steps):
            t0 = time.perf_counter()
            metrics = self._step_fn(self.opt_state, self._batch(step))
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "ms": (time.perf_counter() - t0) * 1e3})
            if self.ckpt and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state_dict())
            if failure_hook is not None:
                failure_hook(step)   # may raise to simulate a crash
        if self.ckpt:
            self.ckpt.save(self.tcfg.steps, self.state_dict(), wait=True)
        return {"history": history, "final_loss": history[-1]["loss"]}
