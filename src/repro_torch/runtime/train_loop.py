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
axes, one process a device): the master parameters and the AdamW moments
live sharded by ``repro_torch.sharding``'s rules; the master shards are
views into the model's parameters, which each step all-gathers, so the
model and its kernels see full tensors.  Each dp rank computes its rows of
each microbatch (microbatch *i* is rows ``[i·B/accum, (i+1)·B/accum)``,
split over dp, as ``repro`` splits it); the ranks along ``model`` compute
the same rows.  Each microbatch's gradients are reduce-scattered (mean over
dp) into the parameter layout, the clip's global norm counts each element
once, and AdamW runs on the shards.  At one rank every shard is the
parameter itself.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.optim import AdamW, AdamWState, cosine_with_warmup
from repro_torch.runtime.elastic import restore_onto_mesh
from repro_torch.sharding import (constrain_like_params, dp_axes,
                                  global_norm, make_shardings, params_pspecs)


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
    over): the model's parameters, or on a mesh this rank's shards of them;
    ``shardings``: each parameter's ``Sharding``, or ``None``."""

    def __init__(self, model, opt: AdamW, accum_steps: int,
                 accum_dtype: torch.dtype, mesh):
        self.model, self.opt = model, opt
        self.accum_steps, self.accum_dtype = accum_steps, accum_dtype
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        if mesh is None:
            self.shardings = None
            self.master = self.params
        else:
            self.shardings = make_shardings(
                mesh, params_pspecs(self.params), self.params)
            self.master = {k: self.shardings[k].shard(p.detach())
                           for k, p in self.params.items()}

    def _grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Backward; the gradients in the master layout (on a mesh the
        reduce-scatter, mean over dp)."""
        loss.backward()
        grads = {k: p.grad for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        if self.mesh is not None:
            grads = constrain_like_params(grads, self.shardings)
        return grads

    def __call__(self, opt_state: AdamWState,
                 batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        accum = self.accum_steps
        if accum > 1:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=self.accum_dtype,
                                    device=p.device)
                     for k, p in self.master.items()}
            loss = torch.zeros((), device=self.model.device)
            for i in range(accum):
                mb_loss, _ = self.model.loss_fn(
                    {k: v[i] for k, v in micro.items()})
                for k, g in self._grads(mb_loss).items():
                    grads[k].copy_(grads[k].float() + g.float() / accum)
                loss = loss + mb_loss.detach()
            loss = loss / accum
        else:
            loss, _ = self.model.loss_fn(batch)
            grads = self._grads(loss)
            loss = loss.detach()
        gnorm = None
        if self.mesh is not None:
            loss = _dp_mean(loss, self.mesh)
            gnorm = global_norm(grads, self.shardings)
        metrics = self.opt.update(grads, opt_state, self.master,
                                  grad_norm=gnorm)
        if self.mesh is not None:
            self.gather_()
        return {"loss": loss, **metrics}

    @torch.no_grad()
    def gather_(self) -> None:
        """All-gather the master shards into the model's parameters."""
        for k, sh in (self.shardings or {}).items():
            full = sh.gather(self.master[k])
            if full is not self.master[k]:
                self.params[k].copy_(full)


def _dp_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the mesh's dp axes."""
    t, n = t.clone(), 1
    for i, axis in enumerate(mesh.mesh_dim_names):
        if axis in dp_axes(mesh) and mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
            n *= mesh.size(i)
    return t / n


def make_train_step(model, opt: AdamW, accum_steps: int,
                    accum_dtype: torch.dtype = torch.float32, mesh=None
                    ) -> TrainStep:
    """Build ``step(opt_state, batch) → metrics``, which updates the
    model's parameters and ``opt_state`` (built over ``step.master``) in
    place.

    With ``accum_steps > 1`` the batch is split into that many microbatches
    along its rows; their gradients are averaged (each divided by
    ``accum_steps`` before it is added) into an ``accum_dtype`` buffer, and
    the step's loss is their mean.  On ``mesh`` the batch is this rank's
    rows (:func:`rank_rows`), the master state is sharded by the rules
    (FSDP on ``data``) and the loss is the mean over dp."""
    return TrainStep(model, opt, accum_steps, accum_dtype, mesh)


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
    """Trainer on one GPU, or on ``mesh`` (one process a device; see the
    module docstring): initializes ``model`` from ``seed``, builds AdamW
    with ``repro``'s cosine schedule, and resumes from ``tcfg.ckpt_dir``'s
    latest checkpoint when there is one (``repro``'s ``resume="auto"``).
    The model's parameters live on its device; batches are moved there."""

    def __init__(self, model, model_cfg: ModelConfig, shape_cfg: ShapeConfig,
                 tcfg: TrainerConfig, mesh=None, seed: int = 0):
        self.model = model
        self.model_cfg = model_cfg
        self.shape_cfg = shape_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = model.device
        self.data = SyntheticDataset(model_cfg, shape_cfg, seed=seed + 1)
        self.opt = AdamW(lr=cosine_with_warmup(tcfg.peak_lr, tcfg.warmup,
                                               tcfg.steps))
        model.init(torch.Generator(device=self.device).manual_seed(seed))
        self.params = dict(model.named_parameters())
        self._step_fn = make_train_step(model, self.opt, tcfg.accum_steps,
                                        mesh=mesh)
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
                    restore_onto_mesh(self.ckpt, latest, like, mesh))
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
        if self.mesh is not None:
            self._step_fn.gather_()

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
