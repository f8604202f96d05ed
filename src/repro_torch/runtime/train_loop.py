"""Training runtime of the port, on one GPU: train step with gradient
accumulation, AdamW, checkpoints and crash → resume.

The counterpart of ``repro.runtime.train_loop``:

    state = (fp32 parameters, AdamW m/v, step)
    step:  for each of ``accum_steps`` microbatches: loss, backward, add
           grad / accum_steps to an ``accum_dtype`` buffer → clip → AdamW

The state is updated in place (the model's parameters and the optimizer's
moments).  The data pipeline is a pure function of the step, so a restart
from the latest checkpoint replays exactly the batches it would have seen.
``failure_hook`` lets tests inject a crash after a chosen step.  The mesh,
FSDP and ``grad_compression`` of ``repro`` are not ported (ROADMAP
"Multi-GPU"), so :class:`TrainerConfig` has no ``grad_compression``; nor
has it ``resume``, since a trainer with a checkpoint directory always
resumes from its latest checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.optim import AdamW, AdamWState, cosine_with_warmup


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 10
    accum_steps: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10


StepFn = Callable[[AdamWState, Mapping[str, torch.Tensor]],
                  Dict[str, Any]]


def make_train_step(model, opt: AdamW, accum_steps: int,
                    accum_dtype: torch.dtype = torch.float32) -> StepFn:
    """Build ``step(opt_state, batch) → metrics``, which updates the
    model's parameters and ``opt_state`` in place.

    With ``accum_steps > 1`` the batch is split into that many microbatches
    along its rows; their gradients are averaged (each divided by
    ``accum_steps`` before it is added) into an ``accum_dtype`` buffer, and
    the step's loss is their mean."""
    params = dict(model.named_parameters())

    def grads_of(loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads

    def step_fn(opt_state: AdamWState,
                batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        if accum_steps > 1:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for i in range(accum_steps):
                mb_loss, _ = model.loss_fn({k: v[i] for k, v in micro.items()})
                for k, g in grads_of(mb_loss).items():
                    grads[k].copy_(grads[k].float() + g.float() / accum_steps)
                loss = loss + mb_loss.detach()
            loss = loss / accum_steps
        else:
            loss, _ = model.loss_fn(batch)
            grads = grads_of(loss)
            loss = loss.detach()
        metrics = opt.update(grads, opt_state, params)
        return {"loss": loss, **metrics}

    return step_fn


class Trainer:
    """One-GPU trainer: initializes ``model`` from ``seed``, builds AdamW
    with ``repro``'s cosine schedule, and resumes from ``tcfg.ckpt_dir``'s
    latest checkpoint when there is one (``repro``'s ``resume="auto"``).
    The model's parameters live on its device; batches are moved there."""

    def __init__(self, model, model_cfg: ModelConfig, shape_cfg: ShapeConfig,
                 tcfg: TrainerConfig, seed: int = 0):
        self.model = model
        self.model_cfg = model_cfg
        self.shape_cfg = shape_cfg
        self.tcfg = tcfg
        self.device = model.device
        self.data = SyntheticDataset(model_cfg, shape_cfg, seed=seed + 1)
        self.opt = AdamW(lr=cosine_with_warmup(tcfg.peak_lr, tcfg.warmup,
                                               tcfg.steps))
        model.init(torch.Generator(device=self.device).manual_seed(seed))
        self.params = dict(model.named_parameters())
        self.opt_state = self.opt.init(self.params)
        self.start_step = 0
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        if self.ckpt:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self.load_state_dict(self.ckpt.restore(latest,
                                                       self.state_dict()))
                self.start_step = latest
        self._step_fn = make_train_step(model, self.opt, tcfg.accum_steps)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The checkpointed state, keyed by the port's state names."""
        sd = {f"params/{k}": p.detach() for k, p in self.params.items()}
        sd["opt/step"] = torch.tensor(self.opt_state.step, dtype=torch.int32)
        sd.update({f"opt/m/{k}": t for k, t in self.opt_state.m.items()})
        sd.update({f"opt/v/{k}": t for k, t in self.opt_state.v.items()})
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        for k, p in self.params.items():
            p.copy_(sd[f"params/{k}"])
            self.opt_state.m[k].copy_(sd[f"opt/m/{k}"])
            self.opt_state.v[k].copy_(sd[f"opt/v/{k}"])
        self.opt_state.step = int(sd["opt/step"])

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

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
