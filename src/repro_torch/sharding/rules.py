"""Logical sharding rules over a ``DeviceMesh`` (``repro.sharding.rules``).

The strategy is ``repro``'s:

* **TP** on ``model``: attention heads, FFN hidden, vocab, experts;
* **FSDP** on ``data``: the other dimension of every large matrix, so the
  parameters and optimizer state scale down with the number of ranks;
* **DP** on ``pod``: replication, gradients averaged across pods.

The rules read the port's state names (``layers.0.attn.wq.w``,
``params/embed.table``, ``opt/m/...``): the last component is the name and
the one before it the parent, as ``repro`` reads the keys of its pytree.
The port's per-layer tensors have no stacked layer axis, so each spec is
``repro``'s without the leading ``None`` of that axis.

A :class:`Sharding` is ``repro``'s ``NamedSharding``: the sanitized spec
and the DTensor placements it gives, with the collectives the trainer
needs (the local shard, the all-gather, the reduce-scatter of gradients
into the parameter layout).  Within one tensor dim sharded over several
mesh axes the earlier mesh axis is the major one, as in DTensor.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.launch.mesh import current_mesh


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis name, or a tuple of
    them (``jax.sharding.PartitionSpec``, which also stores a one-axis
    tuple as the axis and an empty one as ``None``)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec

# parameter-name classes
_COL_PARALLEL = {"up", "gate", "wq", "wk", "wv", "wg", "wr", "in_x", "in_g",
                 "a_gate", "x_gate", "cm_k", "w_lora_a", "router"}
_ROW_PARALLEL = {"down", "wo", "out", "cm_v", "w_lora_b"}
_REPLICATED = {"scale", "b", "a_param", "mix", "cm_mix", "u", "conv",
               "w_bias"}

Shape = Tuple[int, ...]


def _shape(leaf) -> Shape:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_pspec(name: str, leaf, *, dp="data", tp: str = "model") -> P:
    """The spec of the tensor named ``name`` (``leaf``: it, or its
    shape)."""
    names = re.split(r"[./]", name)
    key = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    ndim = len(_shape(leaf))
    if key == "blocks":
        # Segment-kernel BSR blocks: the schedule indexes the full block
        # list, so they are replicated
        return P()
    if key == "table":                       # (vocab, d) embedding
        return P(tp, dp)
    if key in _REPLICATED:
        return P()
    if key == "w" and parent in _COL_PARALLEL:
        return _last2(ndim, dp, tp)
    if key == "w" and parent in _ROW_PARALLEL:
        return _last2(ndim, tp, dp)
    if key in ("gate", "up") and ndim >= 3:  # (E, d, ff) expert weights
        return _expert(ndim, tp, dp)
    if key == "down" and ndim >= 3:          # (E, ff, d)
        return _expert(ndim, tp, dp, swap=True)
    if ndim >= 2:
        return _last2(ndim, dp, tp)
    return P()


def _last2(ndim: int, a, b) -> P:
    """The last two dims as (a, b); leading dims unsharded."""
    return P(*([None] * (ndim - 2)), a, b)


def _expert(ndim: int, tp, dp, swap: bool = False) -> P:
    pad = [None] * (ndim - 3)
    return P(*pad, tp, None, dp) if swap else P(*pad, tp, dp, None)


def params_pspecs(params: Mapping[str, object]) -> Dict[str, P]:
    """Specs of a state dict, FSDP on ``data``."""
    return {k: param_pspec(k, v) for k, v in params.items()}


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch-sharding axes: ``("pod", "data")`` multi-pod, ``("data",)``."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_pspec(mesh, ndim: int) -> P:
    return P(dp_axes(mesh), *([None] * (ndim - 1)))


def batch_pspecs(mesh, batch: Mapping[str, object]) -> Dict[str, P]:
    return {k: batch_pspec(mesh, len(_shape(v))) for k, v in batch.items()}


def cache_pspec(mesh, leaf) -> P:
    """Decode-state spec of one entry of the port's flat cache: batch (axis
    1) on the dp axes, axis 2 on ``model`` where it divides.  The KV
    entries ``k``/``v`` and the rings ``k_local``/``v_local`` are
    (layers, B, T, n_kv, hd): the timeline shards over ``model``; an int8
    KV cache's (layers, B, T, n_kv) scales shard T too from T = 1024."""
    dp = dp_axes(mesh)
    shape = _shape(leaf)
    ndim = len(shape)
    n_model = _axis_sizes(mesh)["model"]
    if ndim >= 5:
        tp = "model" if shape[2] % n_model == 0 else None
        return P(None, dp, tp, *([None] * (ndim - 3)))
    if ndim == 4 and shape[2] >= 1024 and shape[2] % n_model == 0:
        return P(None, dp, "model", None)
    if ndim >= 2:
        return P(None, dp, *([None] * (ndim - 2)))
    return P()


def sanitize_pspec(mesh, spec: P, shape) -> P:
    """Drop each axis the mesh lacks or whose size does not divide the dim
    (the dim then falls back to replication over it)."""
    sizes = _axis_sizes(mesh)
    dims = _shape(shape)
    new = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(dims):
            new.append(None)
            continue
        keep, size = [], 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a in sizes and dims[i] % (size * sizes[a]) == 0:
                keep.append(a)
                size *= sizes[a]
        new.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*new)


def _placements(mesh: DeviceMesh, spec: P) -> Tuple[Placement, ...]:
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if e is not None
                and axis in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: ``spec`` and its DTensor
    ``placements`` (one a mesh dim)."""
    mesh: DeviceMesh
    spec: P
    placements: Tuple[Placement, ...]

    def _sharded(self):
        """``(mesh dim, tensor dim, size, this rank's coordinate)`` of each
        mesh dim of more than one rank that shards the tensor, in mesh
        order (the major one first)."""
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        return [(i, pl.dim, self.mesh.size(i), coord[i])
                for i, pl in enumerate(self.placements)
                if isinstance(pl, Shard) and self.mesh.size(i) > 1]

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``: a view, and ``full`` itself when
        nothing is sharded."""
        t = full
        for _, d, n, c in self._sharded():
            step = t.shape[d] // n
            t = t.narrow(d, c * step, step)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (all-gathers, minor mesh
        dim first); ``local`` itself when nothing is sharded."""
        t = local
        for i, d, n, _ in reversed(self._sharded()):
            t = _all_gather(t, d, n, self.mesh.get_group(i))
        return t

    def reduce_scatter(self, grad: torch.Tensor) -> torch.Tensor:
        """The mean over the dp axes of each rank's full gradient, in this
        rank's layout: reduce-scattered over a dp axis that shards the
        tensor, all-reduced over one that does not; sliced along a model
        axis (its ranks computed the same gradient).  ``grad`` itself at
        one rank."""
        dp = dp_axes(self.mesh)
        coord = self.mesh.get_coordinate()
        t, n_dp = grad, 1
        for i, (axis, pl) in enumerate(zip(self.mesh.mesh_dim_names,
                                           self.placements)):
            n = self.mesh.size(i)
            if n == 1:
                continue
            if axis not in dp:
                if isinstance(pl, Shard):
                    step = t.shape[pl.dim] // n
                    t = t.narrow(pl.dim, coord[i] * step, step)
                continue
            n_dp *= n
            group = self.mesh.get_group(i)
            if isinstance(pl, Shard):
                t = _reduce_scatter(t, pl.dim, n, group)
            else:                    # a copy: the caller's grad stays
                t = t.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(t, group=group)
        return t if n_dp == 1 else t / n_dp

    def counts_in_norm(self) -> bool:
        """True on the one rank of each replica group whose copy a global
        norm counts: coordinate 0 along every mesh dim that replicates the
        tensor."""
        coord = self.mesh.get_coordinate()
        return all(c == 0 for c, pl in zip(coord, self.placements)
                   if not isinstance(pl, Shard))


def _all_gather(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, n: int,
                    group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def make_shardings(mesh: DeviceMesh, pspecs: Mapping[str, P],
                   leaves: Optional[Mapping[str, object]] = None
                   ) -> Dict[str, Sharding]:
    """A :class:`Sharding` a name; with ``leaves`` (tensors or shapes) each
    spec is sanitized against its shape first."""
    out = {}
    for k, spec in pspecs.items():
        if leaves is not None:
            spec = sanitize_pspec(mesh, spec, leaves[k])
        out[k] = Sharding(mesh, spec, _placements(mesh, spec))
    return out


def constrain(x, mesh: DeviceMesh, spec: P):
    """A DTensor redistributed to ``spec``; a plain tensor as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, _placements(mesh, spec))
    return x


def constrain_like_params(grads: Mapping[str, torch.Tensor],
                          shardings: Mapping[str, Sharding]
                          ) -> Dict[str, torch.Tensor]:
    """Each rank's full gradients → their mean over the dp axes in the
    parameter layout (:meth:`Sharding.reduce_scatter`)."""
    return {k: shardings[k].reduce_scatter(g) for k, g in grads.items()}


def global_norm(grads: Mapping[str, torch.Tensor],
                shardings: Mapping[str, Sharding]) -> torch.Tensor:
    """The global L2 norm of sharded gradients, each element counted once:
    a replicated shard only on the rank that :meth:`Sharding.counts_in_norm`.
    """
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
          for k, g in grads.items() if shardings[k].counts_in_norm()]
    total = (torch.stack(sq).sum() if sq else
             torch.zeros((), device=next(iter(grads.values())).device))
    mesh = next(iter(shardings.values())).mesh
    for i in range(mesh.ndim):       # the sum over every rank of the mesh
        if mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return total.sqrt()


def act_constrain(x, kind: str):
    """Redistribute an activation DTensor inside :func:`mesh_context` (a
    plain tensor, or no mesh with a ``model`` axis: ``x`` as it is).

    kinds: ``hidden`` (B, T, D) batch-sharded; ``logits`` (B, T, V) batch
    and vocab (model); ``seq``, ``ffn``, ``heads``, ``scores_t`` and
    ``expert`` as in ``repro``."""
    m = current_mesh()
    if m is None or "model" not in m.mesh_dim_names \
            or not isinstance(x, DTensor):
        return x
    dp = dp_axes(m)
    if not dp:
        return x
    sizes = _axis_sizes(m)
    if x.shape[0] % math.prod(sizes[a] for a in dp) != 0:
        return x
    n = x.ndim

    def tp_ok(dim):
        return dim % sizes["model"] == 0

    if kind == "logits":
        spec = P(dp, *([None] * (n - 2)), "model")
    elif kind == "seq" and n >= 2 and tp_ok(x.shape[1]):
        spec = P(dp, "model", *([None] * (n - 2)))
    elif kind == "ffn" and tp_ok(x.shape[-1]):
        spec = P(dp, *([None] * (n - 2)), "model")
    elif kind == "heads" and n == 4 and tp_ok(x.shape[2]):
        spec = P(dp, None, "model", None)
    elif kind == "scores_t" and n == 4 and tp_ok(x.shape[-1]):
        spec = P(dp, None, None, "model")
    elif kind == "expert" and n == 4 and tp_ok(x.shape[1]):
        spec = P(dp, "model", None, None)
    elif kind == "expert" and n == 3 and tp_ok(x.shape[0]):
        spec = P("model", None, None)
    else:
        spec = P(dp, *([None] * (n - 1)))
    return constrain(x, m, spec)

