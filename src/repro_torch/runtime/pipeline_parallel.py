"""GPipe-style pipeline parallelism over a ``stage`` mesh axis
(``repro.runtime.pipeline_parallel``).

Layers are split into S stages, one a rank of the ``stage`` axis, and
microbatches flow from each stage to the next by ``send``/``recv``.
Wall-clock = (n_micro + S - 1) ticks, GPipe's fill and drain; the bubble
is (S - 1) / (n_micro + S - 1).  This is the forward (inference)
pipeline, as in ``repro``; training composes it with gradient
accumulation outside.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _index(params, i: int):
    if isinstance(params, torch.Tensor):
        return params[i]
    return {k: _index(v, i) for k, v in params.items()}


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                     mesh, n_micro: int, axis: str = "stage"
                     ) -> torch.Tensor:
    """Run ``x`` through S pipelined stages.

    Args:
      stage_fn: (one stage's params, activation (mb, ...)) → activation of
        the same shape.
      stage_params: a tensor or dict of tensors with leading dim S; the
        rank at coordinate s of ``axis`` reads entry s.
      x: (n_micro, mb, ...) input microbatches (the same on every rank).
    Returns:
      (n_micro, mb, ...) outputs of the last stage, on every rank.
    """
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    p_one = _index(stage_params, sid)
    buf = torch.zeros_like(x[0])
    out_all = torch.zeros_like(x)
    for t in range(n_micro + s - 1):
        inp = x[min(t, n_micro - 1)] if sid == 0 else buf
        live = sid <= t < sid + n_micro
        out = stage_fn(p_one, inp) if live else torch.zeros_like(buf)
        # each stage first sends, then receives: the last stage's receive
        # is posted first, so the chain of blocking calls unwinds
        if sid < s - 1:
            dist.send(out.contiguous(), ranks[sid + 1], group=group)
        if sid > 0:
            dist.recv(buf, ranks[sid - 1], group=group)
        if sid == s - 1 and live:
            out_all[t - sid] = out
    if s > 1:
        dist.broadcast(out_all, ranks[s - 1], group=group)
    return out_all


def split_layers_into_stages(stacked_params, n_stages: int):
    """Reshape layer-stacked params (L, ...) → (S, L/S, ...)."""
    if isinstance(stacked_params, torch.Tensor):
        n = stacked_params.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return stacked_params.reshape(n_stages, n // n_stages,
                                      *stacked_params.shape[1:])
    return {k: split_layers_into_stages(v, n_stages)
            for k, v in stacked_params.items()}
