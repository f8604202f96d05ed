"""The reference's training steps: the loss and gradients of
:mod:`perfbench.reference.model` and AdamW with global-norm clipping, as the
traffic file states them (β1, β2, ε, weight decay inside the update, the
clip), all in float32.

:func:`readings` gives what a training cell compares, for the reference
and for a program alike: the loss of each step, each leaf's norm of the
first step's gradient as the optimizer took it (clipped; read back from
the first moment), and each leaf's norm of its change over the steps.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench.inputs import Arch, initial_leaves
from perfbench.reference import model as ref


def adamw_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
           step: int, hp: dict) -> None:
    """One AdamW step in place (``step`` counts from 1)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = torch.clamp(hp["clip_norm"] / torch.clamp(norm, min=1e-9),
                        max=1.0)
    f32 = np.float32
    bc1 = float(f32(1) - f32(hp["b1"]) ** f32(step))
    bc2 = float(f32(1) - f32(hp["b2"]) ** f32(step))
    for k, p in params.items():
        g = grads[k] * scale
        m[k].mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
        v[k].mul_(hp["b2"]).add_(g * g, alpha=1 - hp["b2"])
        delta = (m[k] / bc1) / ((v[k] / bc2).sqrt() + hp["eps"])
        p.sub_(delta + hp["weight_decay"] * p, alpha=hp["lr"])


def leaf_norms(t: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    names = list(t)
    norms = torch.stack([torch.linalg.vector_norm(t[k].float())
                         for k in names]) * scale
    return dict(zip(names, norms.tolist()))


@torch.no_grad()
def change_norms(a: Arch, seed: int, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each leaf's ``‖p − p₀‖``, its initial value drawn again from the
    seed."""
    device = params[next(iter(params))].device
    return {name: float(torch.linalg.vector_norm(params[name].float() - p0))
            for name, p0 in initial_leaves(a, seed, device,
                                           names=set(params))}


def run_steps(a: Arch, seed: int, batches: List[Dict[str, torch.Tensor]],
              pattern, hp: dict, device, prec: str = "fp32",
              log: Callable[[str], None] = lambda s: None) -> dict:
    """The reference trained from the seed's weights over ``batches``;
    returns its :func:`readings`."""
    ref.no_tf32()
    w = {k: t.requires_grad_() for k, t in initial_leaves(a, seed, device)}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, first = [], None
    for i, batch in enumerate(batches, start=1):
        loss = ref.loss(a, w, batch["tokens"], batch["targets"], pattern,
                        prec)
        loss.backward()
        grads = {k: t.grad for k, t in w.items()}
        with torch.no_grad():
            adamw_({k: t.data for k, t in w.items()}, grads, m, v, i, hp)
        for t in w.values():
            t.grad = None
        losses.append(float(loss.detach()))
        if i == 1:
            first = leaf_norms(m, 1.0 / (1 - hp["b1"]))
        log(f"reference step {i}: loss {losses[-1]:.6f}")
    del m, v, grads
    change = change_norms(a, seed, {k: t.data for k, t in w.items()})
    return {"loss": losses, "grad": first, "change": change}
