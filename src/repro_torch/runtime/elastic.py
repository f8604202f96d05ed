"""Elastic scaling: a new mesh after losing ranks, and the state restored
onto it (``repro.runtime.elastic``).

1. a node fails → the job is relaunched with the surviving processes;
2. :func:`make_elastic_mesh` builds the largest (data, model) mesh from
   them (the model-parallel degree is kept; the data axis shrinks);
3. the latest checkpoint is restored onto the new mesh: checkpoints hold
   unsharded arrays, so each rank takes its shards under the new mesh's
   layout (the port's own checkpoints, or ``repro``'s through
   ``checkpoint.JaxCheckpoint``);
4. the data pipeline is a pure function of (step, rows), so the global
   batch re-partitions over the surviving dp ranks (:func:`rescale_accum`
   keeps the effective batch).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding import make_shardings, params_pspecs


def make_elastic_mesh(ranks: Optional[Sequence[int]] = None,
                      model_parallel: int = 1,
                      axis_names=("data", "model"),
                      device: str = "cuda") -> DeviceMesh:
    """The largest (data, model) mesh over ``ranks`` (default: every rank
    of the process group), keeping ``model_parallel``.  Every rank of the
    group calls it; a rank left out gets a mesh it is not in."""
    if not dist.is_initialized():
        raise RuntimeError("make_elastic_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) < model_parallel:
        raise ValueError(f"{len(ranks)} ranks cannot hold model "
                         f"parallelism {model_parallel}")
    dp = len(ranks) // model_parallel
    grid = torch.tensor(ranks[: dp * model_parallel]).reshape(
        dp, model_parallel)
    return DeviceMesh(device, grid, mesh_dim_names=tuple(axis_names))


def restore_onto_mesh(ckpt, step: int,
                      state_like: Mapping[str, torch.Tensor],
                      mesh: DeviceMesh, fsdp="data"):
    """Restore ``step`` of ``ckpt`` (a ``CheckpointManager`` or a
    ``JaxCheckpoint``) under ``mesh``'s layout of ``state_like``'s names
    (FSDP on ``fsdp``): DTensors over this rank's shards (the step and the
    AdamW moments share the parameters' rules)."""
    shardings = make_shardings(mesh, params_pspecs(state_like, fsdp=fsdp),
                               state_like)
    return ckpt.restore(step, state_like, shardings=shardings)


def rescale_accum(global_batch: int, old_dp: int, new_dp: int,
                  old_accum: int) -> Tuple[int, int]:
    """Accumulation steps that keep the effective global batch at least
    the target after a dp change: ``(new_accum, effective_batch)``, with
    ``effective_batch = new_accum · new_dp · per-device batch``.  It
    ceil-divides, so the batch can overshoot (surfaced in the second
    value) but never shrink: 64 rows, dp 8 → 6 gives accum 2, 96 rows."""
    per_device = max(1, global_batch // (old_dp * old_accum))
    new_accum = max(1, -(-global_batch // (new_dp * per_device)))
    return new_accum, new_accum * new_dp * per_device
