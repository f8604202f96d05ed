"""Gradient compression for data parallelism (``repro.runtime.compression``).

* ``int8``: per-tensor symmetric int8 quantization, with **error
  feedback**: the quantization residual is carried into the next step, so
  the compression bias vanishes in expectation;
* ``topk``: magnitude top-k sparsification, also with error feedback.

As ``repro``'s ``compressed_psum`` does, the all-reduce carries the
*dequantized fp32* values (the kept values for ``topk``), so the numbers
equal ``repro``'s; this cuts no traffic: an int8 payload or index/value
pairs on the wire are not implemented, in either package.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim import AdamW, AdamWState


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``q`` int8 in [-127, 127], ``g ≈ q · scale``."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where ``|g|`` is at least its k-th largest value (k = ``frac`` of
    the elements, at least one), else 0, in ``g``'s dtype."""
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compressed_psum(grads: Mapping[str, torch.Tensor], group,
                    error_fb: Mapping[str, torch.Tensor],
                    method: str = "int8", topk_frac: float = 0.1
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """All-reduce ``grads`` over ``group`` with compression and error
    feedback.  Returns ``(mean grads, new error feedback)``."""
    n = dist.get_world_size(group)
    mean, new_ef = {}, {}
    for k, g in grads.items():
        g = g.to(torch.float32) + error_fb[k]
        if method == "int8":
            sent = dequantize_int8(*quantize_int8(g))
        elif method == "topk":
            sent = g * topk_mask(g, topk_frac)
        else:
            sent = g.clone()
        new_ef[k] = g - sent
        dist.all_reduce(sent, group=group)
        mean[k] = sent / n
    return mean, new_ef


def init_error_fb(params_like: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """This rank's error-feedback residuals (fp32 zeros like each
    parameter).  ``repro`` carries one residual a dp rank on a leading axis
    of its one array; here each process carries its own."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params_like.items()}


def make_compressed_dp_step(loss_fn: Callable, opt: AdamW, mesh,
                            dp_axis: str = "data", method: str = "int8"):
    """A data-parallel train step whose gradient all-reduce is compressed.

    ``step((params, opt_state, error_fb), batch) → ((params, opt_state,
    error_fb), loss)``: ``params`` (a dict of tensors, replicated: pure DP)
    and ``opt_state`` are updated in place; ``batch`` is a tuple of
    tensors holding the global batch's rows, of which this rank takes its
    contiguous share along ``dp_axis``; ``loss_fn(params, batch)`` returns
    a scalar; the returned loss is the mean over the dp ranks."""
    group = mesh.get_group(dp_axis)
    n = mesh.size(mesh.mesh_dim_names.index(dp_axis))
    r = mesh.get_local_rank(dp_axis)

    def step(state: Tuple[Dict[str, torch.Tensor], AdamWState,
                          Dict[str, torch.Tensor]], batch):
        params, opt_state, error_fb = state
        local = tuple(x.chunk(n, dim=0)[r] for x in batch)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, local)
        g = torch.autograd.grad(loss, list(leaves.values()))
        grads, new_ef = compressed_psum(dict(zip(leaves, g)), group,
                                        error_fb, method)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        opt.update(grads, opt_state, params)
        return (params, opt_state, new_ef), loss / n

    return step
